"""Per-frame geometric features from an anchor mask (port of
utils/frame_features.py).

[t_norm?, is_anchor, alpha, gap_norm, dist_mid] per frame, with
cummax/cummin neighbour-anchor propagation; a sample without any anchor
falls back to its two endpoints.
"""
from __future__ import annotations

import torch


def frame_features_from_mask(mask: torch.Tensor, include_time: bool = True) -> torch.Tensor:
    if mask.ndim != 2:
        raise ValueError("mask must be [B,T]")
    mask = mask.bool()
    B, T = mask.shape
    if T <= 1:
        return torch.zeros((B, T, 5 if include_time else 4), dtype=torch.float32,
                           device=mask.device)

    has_any = mask.any(dim=1, keepdim=True)
    fallback = torch.zeros_like(mask)
    fallback[:, 0] = fallback[:, -1] = True
    mask = torch.where(has_any, mask, fallback)

    t = torch.arange(T, dtype=torch.float32, device=mask.device)[None, :].expand(B, T)
    first = mask.int().argmax(dim=1).float()[:, None]
    last = (T - 1 - mask.flip(1).int().argmax(dim=1)).float()[:, None]

    left = torch.cummax(torch.where(mask, t, torch.full_like(t, -1e9)), dim=1).values
    right = torch.cummin(torch.where(mask, t, torch.full_like(t, 1e9)).flip(1), dim=1).values.flip(1)
    left = torch.where(left < 0.0, first, left)
    right = torch.where(right > float(T - 1), last, right)

    gap = torch.clamp(right - left, min=1.0)
    alpha = torch.clamp((t - left) / gap, 0.0, 1.0)
    dist = torch.minimum(torch.clamp(t - left, min=0.0), torch.clamp(right - t, min=0.0))
    dist_mid = torch.clamp(2.0 * dist / gap, 0.0, 1.0)
    gap_norm = gap / float(max(1, T - 1))
    feats = [mask.float(), alpha, gap_norm, dist_mid]
    if include_time:
        feats = [t / float(max(1, T - 1))] + feats
    return torch.stack(feats, dim=-1)
