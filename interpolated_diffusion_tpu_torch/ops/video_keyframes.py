"""Interpolation of video latents between anchors (port of the part of
ops/video_keyframes.py that the Phase-1 trainer's `full` input mode uses):
segment lerp with an optional smoothing refinement, anchors re-scattered
exactly; and `distance_alpha`, the noise scale of the maze Stage-2 corruption.
The learned refinement and the video level / adjacent-level corruption batches
are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .keyframes import interpolate_from_indices


def distance_alpha(idx: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, 1] noise scale: 0 at anchors, 1 at segment midpoints."""
    idx = idx.long()
    B, K = idx.shape
    t_grid = torch.arange(T, dtype=torch.long, device=idx.device)
    seg = torch.searchsorted(idx.contiguous(), t_grid.expand(B, T).contiguous(), right=True) - 1
    seg = torch.clamp(seg, 0, K - 2)
    left, right = torch.gather(idx, 1, seg), torch.gather(idx, 1, seg + 1)
    gap = torch.clamp(right - left, min=1)
    dist = torch.minimum(t_grid[None, :] - left, right - t_grid[None, :])
    return torch.clamp(2.0 * dist.float() / gap.float(), 0, 1)[..., None]


def smooth_latents(z: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise temporal convolution over [B, T, D] with a symmetric 1D
    kernel, zero-padded at both ends."""
    B, T, D = z.shape
    x = z.transpose(1, 2).reshape(B * D, 1, T)
    y = F.conv1d(x, kernel.reshape(1, 1, -1).to(z.dtype), padding=kernel.shape[-1] // 2)
    return y.reshape(B, D, T).transpose(1, 2)


def interpolate_video_from_indices(idx: torch.Tensor, vals: torch.Tensor, T: int,
                                   mode: str = "linear",
                                   smooth_kernel: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """idx [B, K] sorted anchor frames, vals [B, K, D] -> [B, T, D]: segment
    lerp (`linear`), or the lerp smoothed by `smooth_kernel` (default
    [0.25, 0.5, 0.25]) with the anchors written back exactly (`smooth`)."""
    z = interpolate_from_indices(idx, vals, T, recompute_velocity=False)
    if mode == "linear":
        return z
    if mode == "smooth":
        if smooth_kernel is None:
            smooth_kernel = torch.tensor([0.25, 0.5, 0.25], dtype=z.dtype, device=z.device)
        z = smooth_latents(z, smooth_kernel)
        index = idx.long()[..., None].expand(-1, -1, z.shape[-1])
        return z.scatter(1, index, vals.to(z.dtype))
    if mode == "learned":
        raise NotImplementedError("video_interp_mode='learned' is not ported yet")
    raise ValueError(f"unknown interpolation mode {mode!r}")
