"""Image-space ops on NCHW tensors (port of ops/image.py): bilinear grid
sampling (align_corners=True, border padding), flow warping, pooling,
resizing, the L2 normalisation and the local correlation volume.

`resize_bilinear` is `jax.image.resize(..., "bilinear")`: half-pixel
bilinear when both axes grow, and a triangle filter widened by the
downsampling factor (antialiasing, weights renormalised at the borders)
when an axis shrinks; `F.interpolate(antialias=True)` computes the same
weights, `antialias=False` does not.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with align_corners=True and border padding.

    x [B, C, H, W]; grid [B, H', W', 2] in [-1, 1], (x, y) order."""
    return F.grid_sample(x, grid.to(x.dtype), mode="bilinear", padding_mode="border",
                         align_corners=True)


def flow_to_grid(flow: torch.Tensor) -> torch.Tensor:
    """Pixel flow [B, 2, H, W] -> normalised sampling grid [B, H, W, 2]."""
    B, _, H, W = flow.shape
    y, x = torch.meshgrid(torch.arange(H, dtype=flow.dtype, device=flow.device),
                          torch.arange(W, dtype=flow.dtype, device=flow.device), indexing="ij")
    grid = torch.stack([x, y], dim=-1)[None] + flow.permute(0, 2, 3, 1)
    gx = 2.0 * grid[..., 0] / max(W - 1, 1) - 1.0
    gy = 2.0 * grid[..., 1] / max(H - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp x [B, C, H, W] by pixel flow [B, 2, H, W]."""
    return grid_sample_bilinear(x, flow_to_grid(flow))


def avg_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping average pool; H and W must be multiples of k."""
    B, C, H, W = x.shape
    return x.reshape(B, C, H // k, k, W // k, k).mean(dim=(3, 5))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] to out_hw, jax.image.resize's
    semantics (antialiased where an axis shrinks)."""
    H, W = x.shape[-2:]
    shrink = out_hw[0] < H or out_hw[1] < W
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=shrink)


def l2_normalize(x: torch.Tensor, dim: int = 1, eps: float = 1e-6) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def cost_volume(z0: torch.Tensor, z1: torch.Tensor, radius: int = 2, downscale: int = 2,
                normalize: bool = True) -> torch.Tensor:
    """Local correlation volume [B, (2r+1)^2, H, W] of z0 against z1 shifted
    by every (dy, dx) in [-r, r]^2 (z1 edge-padded), on the downscaled
    features and resized back."""
    if radius <= 0:
        raise ValueError("radius must be positive")
    z0s, z1s = (avg_pool2d(z0, downscale), avg_pool2d(z1, downscale)) if downscale > 1 \
        else (z0, z1)
    if normalize:
        z0s, z1s = l2_normalize(z0s), l2_normalize(z1s)
    B, C, H, W = z0s.shape
    pad = radius
    z1p = F.pad(z1s, (pad, pad, pad, pad), mode="replicate")
    vols = [(z0s * z1p[:, :, dy:dy + H, dx:dx + W]).sum(dim=1, keepdim=True)
            for dy in range(2 * pad + 1) for dx in range(2 * pad + 1)]
    cv = torch.cat(vols, dim=1) / math.sqrt(max(1.0, float(C)))
    if downscale > 1:
        cv = resize_bilinear(cv, z0.shape[-2:])
    return cv
