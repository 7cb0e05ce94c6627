"""Logit / sigmoid transforms on the position dims (port of ops/normalize.py)."""
from __future__ import annotations

import torch


def logit_pos(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Logit-transform the first two (position) dims, other dims unchanged."""
    if x.shape[-1] < 2:
        return x
    pos = torch.clamp(x[..., :2], eps, 1.0 - eps)
    return torch.cat([torch.log(pos / (1.0 - pos)), x[..., 2:]], dim=-1)


def sigmoid_pos(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid the first two (position) dims, other dims unchanged."""
    if x.shape[-1] < 2:
        return x
    return torch.cat([torch.sigmoid(x[..., :2]), x[..., 2:]], dim=-1)
