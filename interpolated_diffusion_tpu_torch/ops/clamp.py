"""Hard anchor clamp (port of ops/clamp.py::apply_clamp)."""
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
