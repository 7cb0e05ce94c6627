"""Best-of-N anchor search: collision scoring and chain-DP candidate mixing
(port of ops/anchor_search.py).

Shared by the sampler's `stage1_best_of` (sample/generate.py) and the
Stage-2 trainer's best-of bootstrap (train/train_interp_levels.py
`--bootstrap_best_of`), so that scheduled-sampling anchors come from the
distribution the sampler serves.
"""
from __future__ import annotations

import torch

from ..eval.metrics import _pos_to_cell
from .keyframes import interpolate_from_indices


def collision_score(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Per-sample occupancy-hit rate of a trajectory: [B, T, >=2], [B, h, w]
    -> [B] (the cell and out-of-bounds rules of compute_metrics_batch)."""
    h, w = occ.shape[-2:]
    i, j, oob = _pos_to_cell(x[..., :2], h, w)
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return ((occ[b, i, j] > 0.5) | oob).float().mean(dim=1)


def dp_mix_anchors(z_cands: torch.Tensor, idx: torch.Tensor, occ: torch.Tensor,
                   T: int) -> torch.Tensor:
    """Chain-DP candidate mixing: z_cands [N, B, K, D], idx [B, K], occ
    [B, h, w] -> z_mix [B, K, D].

    Interpolation is linear between consecutive anchors, so a segment's
    collision cost depends only on its two anchors: the best per-anchor
    assignment over all N^K combinations is a shortest path over a K-node
    chain with N states, O(K N^2). Node cost: the anchor frame's own hit;
    edge cost: hits of the strictly interior frames of the lerp between the
    chosen pair. Ties go to the lowest candidate index, as jnp.argmin's do.
    """
    N, B, K, D = z_cands.shape
    h, w = occ.shape[-2:]
    b_ix = torch.arange(B, device=z_cands.device)
    ni, nj, noob = _pos_to_cell(z_cands[..., :2], h, w)
    node = ((occ[b_ix[None, :, None], ni, nj] > 0.5) | noob).float()       # [N, B, K]
    gap = (idx[:, 1:] - idx[:, :-1]).float()                               # [B, K-1]
    offs = torch.arange(T, dtype=torch.float32, device=z_cands.device)

    def edge(s):
        """Interior-lerp collision counts of segment s: [B, N_a, N_c]; one
        segment at a time keeps the transient at O(B N^2 T)."""
        g = gap[:, s]
        alpha = offs[None, :] / torch.clamp(g[:, None], min=1.0)           # [B, T]
        interior = (offs[None, :] > 0) & (offs[None, :] < g[:, None])
        pa = z_cands[:, :, s, :2].transpose(0, 1)                          # [B, N, 2]
        pc = z_cands[:, :, s + 1, :2].transpose(0, 1)
        a = alpha[:, None, None, :, None]
        pts = pa[:, :, None, None, :] * (1.0 - a) + pc[:, None, :, None, :] * a
        pi, pj, poob = _pos_to_cell(pts, h, w)
        hit = (occ[b_ix[:, None, None, None], pi, pj] > 0.5) | poob
        return (hit & interior[:, None, None, :]).sum(-1).float()

    V = node[:, :, 0].T                                                    # [B, N]
    back = []
    for s in range(K - 1):
        tot = V[:, :, None] + edge(s)                                      # [B, N_a, N_c]
        back.append(torch.argmin(tot, dim=1))                              # [B, N_c]
        V = tot.amin(dim=1) + node[:, :, s + 1].T
    choice = [torch.argmin(V, dim=1)]
    for s in range(K - 2, -1, -1):
        choice.append(torch.gather(back[s], 1, choice[-1][:, None])[:, 0])
    choice = torch.stack(choice[::-1], dim=1)                              # [B, K]
    z_bkd = z_cands.permute(1, 2, 0, 3)                                    # [B, K, N, D]
    return torch.gather(z_bkd, 2, choice[:, :, None, None].expand(B, K, 1, D))[:, :, 0]


def pick_anchors(z_cands: torch.Tensor, idx: torch.Tensor, occ: torch.Tensor, T: int,
                 mode: str = "dp", recompute_velocity: bool = False) -> torch.Tensor:
    """Best-of-N anchors [B, K, D] from z_cands [N, B, K, D]: the chain-DP mix
    under mode "dp", else the whole candidate set whose interpolation
    collides least (the first on a tie)."""
    if mode == "dp":
        return dp_mix_anchors(z_cands, idx, occ, T)
    N, B, K, D = z_cands.shape
    rep = lambda t: t.repeat(N, *([1] * (t.ndim - 1)))
    x = interpolate_from_indices(rep(idx), z_cands.reshape(N * B, K, D), T,
                                 recompute_velocity=recompute_velocity)
    best = torch.argmin(collision_score(x, rep(occ)).view(N, B), dim=0)
    return z_cands[best, torch.arange(B, device=z_cands.device)]
