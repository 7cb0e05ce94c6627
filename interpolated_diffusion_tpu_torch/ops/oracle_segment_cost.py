"""Oracle segment costs on video latents: exact interior-frame interp MSE
(port of ops/oracle_segment_cost.py).

For every (i, j) anchor pair, the exact (not subsampled) squared error
between each interior frame and its linear interpolation from the endpoints:
the ground-truth cost that the learned D_phi approximates. The residual is
formed directly, one frame at a time in frame order, and summed in f32: an
expansion into Gram terms cancels catastrophically at large D.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class OracleSegPrecompute(NamedTuple):
    seg_i: torch.Tensor    # [S]
    seg_j: torch.Tensor    # [S]
    alpha: torch.Tensor    # [S, T] lerp weight per frame (0 outside interior)
    member: torch.Tensor   # [S, T] 1 if frame is interior to the segment
    count: torch.Tensor    # [S] number of interior frames (≥0)


def build_oracle_seg_precompute(T: int) -> OracleSegPrecompute:
    seg_i, seg_j = [], []
    for i in range(T - 1):
        for j in range(i + 1, T):
            seg_i.append(i)
            seg_j.append(j)
    seg_i = np.asarray(seg_i, np.int64)
    seg_j = np.asarray(seg_j, np.int64)
    t = np.arange(T)
    member = (t[None, :] > seg_i[:, None]) & (t[None, :] < seg_j[:, None])
    gap = np.maximum(seg_j - seg_i, 1).astype(np.float32)
    alpha = np.where(member, (t[None, :] - seg_i[:, None]) / gap[:, None], 0.0)
    return OracleSegPrecompute(
        seg_i=torch.as_tensor(seg_i), seg_j=torch.as_tensor(seg_j),
        alpha=torch.as_tensor(alpha.astype(np.float32)),
        member=torch.as_tensor(member.astype(np.float32)),
        count=torch.as_tensor(member.sum(1).astype(np.float32)))


def compute_oracle_cost_seg_mse(z: torch.Tensor, pre: OracleSegPrecompute,
                                normalize: bool = True) -> torch.Tensor:
    """z: [B, T, D] (flattened latents) -> cost [B, S].

    cost(i,j) = Σ_{t interior} mean_D (z_t − lerp(z_i, z_j, α_t))², optionally
    divided by the interior count (mean over frames). One [B, S, D] residual
    per frame, accumulated over the frames in order (the JAX scan's order)."""
    B, T, D = z.shape
    z32 = z.float()
    z_i = z32[:, pre.seg_i]                    # [B, S, D]
    z_j = z32[:, pre.seg_j]
    cost = torch.zeros((B, pre.seg_i.shape[0]), dtype=torch.float32, device=z.device)
    for t in range(T):
        a_t, m_t = pre.alpha[:, t], pre.member[:, t]
        lerp = (1.0 - a_t)[None, :, None] * z_i + a_t[None, :, None] * z_j
        cost = cost + ((z32[:, t, None, :] - lerp) ** 2).sum(-1) * m_t[None, :]
    cost = cost / D
    if normalize:
        cost = cost / torch.clamp(pre.count[None], min=1.0)
    return cost
