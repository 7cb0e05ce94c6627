"""Anchor clamps, hard and confidence-soft (port of ops/clamp.py)."""
from __future__ import annotations

from typing import Optional

import torch


def apply_clamp(x_hat: torch.Tensor, x_ref: torch.Tensor,
                clamp_mask: Optional[torch.Tensor], clamp_dims: str) -> torch.Tensor:
    """Hard clamp: where clamp_mask [B, T], overwrite x_hat with x_ref.

    clamp_dims == "pos" limits the overwrite to the first two (position) dims.
    """
    if clamp_mask is None:
        return x_hat
    m = clamp_mask[..., None]
    if clamp_dims == "pos":
        pos = torch.where(m, x_ref[..., :2], x_hat[..., :2])
        return torch.cat([pos, x_hat[..., 2:]], dim=-1)
    return torch.where(m, x_ref, x_hat)


def apply_soft_clamp(x_hat: torch.Tensor, x_ref: torch.Tensor, conf: Optional[torch.Tensor],
                     lam: float, clamp_dims: str) -> torch.Tensor:
    """Soft clamp: x_hat += lam * conf * (x_ref - x_hat); conf [B, T] or [B, T, 1]."""
    if conf is None or lam <= 0.0:
        return x_hat
    w = (conf[..., None] if conf.ndim == 2 else conf) * float(lam)
    if clamp_dims == "pos":
        pos = x_hat[..., :2] + w * (x_ref[..., :2] - x_hat[..., :2])
        return torch.cat([pos, x_hat[..., 2:]], dim=-1)
    return x_hat + w * (x_ref - x_hat)
