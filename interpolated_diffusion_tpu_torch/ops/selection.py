"""Segment-cost precompute, SNR weights and DP keypoint selection (port of
ops/selection.py).

SNR weights and log-SNR timestep subsampling (host numpy), the all-pairs
segment tables, segment features, batched interp-MSE segment costs, cost
matrices, the DP shortest-path keypoint selection and the keypoint features.

The DP is the JAX package's: K-1 steps of one masked min over the [B, T, T]
cost matrix each (the argmin keeps the parents; `torch.argmin` returns the
first index of a tie, as `jnp.argmin` does), then a backtrack through the
parents. Invalid entries hold 1e30 (not inf), in f32, so the DP only adds
and compares and gives the same indices on every device for the same costs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .schedules import make_alpha_bars, make_beta_schedule

_POS_INF = 1e30


class SegmentPrecompute(NamedTuple):
    """All-pairs (i < j) segment tables; S = T·(T−1)/2 rows."""

    seg_i: torch.Tensor    # [S] long left anchor
    seg_j: torch.Tensor    # [S] long right anchor
    seg_len: torch.Tensor  # [S] long gap
    t_idx: torch.Tensor    # [S, P] long interior sample frames
    alpha: torch.Tensor    # [S, P] f32 lerp weights of the samples
    weight: torch.Tensor   # [S] f32 interior/P weight
    seg_id: torch.Tensor   # [T, T] long row id or −1

    def to(self, device) -> "SegmentPrecompute":
        return SegmentPrecompute(*(t.to(device) for t in self))


def build_snr_weights(schedule: str, n_train: int, s_min: float, s_max: float,
                      gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(snr [n_train], clip(snr, s_min, s_max) ** gamma), f32."""
    alpha_bar = make_alpha_bars(make_beta_schedule(schedule, n_train)).alpha_bar
    snr = alpha_bar / torch.clamp(1.0 - alpha_bar, min=1e-8)
    return snr, torch.clamp(snr, s_min, s_max) ** gamma


def sample_timesteps_log_snr(snr, num_steps: int) -> np.ndarray:
    """Host-side: timesteps spaced uniformly in log-SNR (static output)."""
    snr = snr.cpu().numpy() if isinstance(snr, torch.Tensor) else np.asarray(snr)
    if num_steps <= 1:
        return np.array([0], dtype=np.int64)
    log_snr = np.log(np.clip(snr, 1e-12, None))
    targets = np.linspace(log_snr.max(), log_snr.min(), num_steps)
    idx = np.abs(log_snr[None, :] - targets[:, None]).argmin(axis=1)
    idx = np.unique(idx)
    if idx.size < num_steps:
        idx = np.unique(np.concatenate([idx, [0, log_snr.shape[0] - 1]]))
    return np.sort(idx)


def snr_weight_scale(weights: torch.Tensor, t_idx: np.ndarray) -> float:
    """The trainers' weight scale: the sum of the weights at t_idx (an f32
    numpy sum, as the JAX trainers take it)."""
    return float(weights.cpu().numpy()[t_idx].sum())


def build_segment_precompute(T: int, samples_per_seg: int) -> SegmentPrecompute:
    """Host-side static tables for every segment (i, j), i < j."""
    seg_i, seg_j, seg_len, t_idx, alpha, weight = [], [], [], [], [], []
    for i in range(T - 1):
        for j in range(i + 1, T):
            gap = j - i
            seg_i.append(i)
            seg_j.append(j)
            seg_len.append(gap)
            if gap <= 1:
                t_idx.append(np.full((samples_per_seg,), i, dtype=np.int64))
                alpha.append(np.zeros((samples_per_seg,), dtype=np.float32))
                weight.append(0.0)
            else:
                interior = gap - 1
                offs = (np.arange(samples_per_seg, dtype=np.float32) + 0.5) / samples_per_seg
                offs = np.floor(offs * interior).astype(np.int64)
                ts = i + 1 + offs
                t_idx.append(ts)
                alpha.append(((ts - float(i)) / float(gap)).astype(np.float32))
                weight.append(float(interior) / float(samples_per_seg))
    seg_i = np.asarray(seg_i, dtype=np.int64)
    seg_j = np.asarray(seg_j, dtype=np.int64)
    seg_id = np.full((T, T), -1, dtype=np.int64)
    seg_id[seg_i, seg_j] = np.arange(seg_i.shape[0])
    return SegmentPrecompute(
        seg_i=torch.as_tensor(seg_i), seg_j=torch.as_tensor(seg_j),
        seg_len=torch.as_tensor(np.asarray(seg_len, dtype=np.int64)),
        t_idx=torch.as_tensor(np.stack(t_idx)),
        alpha=torch.as_tensor(np.stack(alpha)),
        weight=torch.as_tensor(np.asarray(weight, dtype=np.float32)),
        seg_id=torch.as_tensor(seg_id))


def build_segment_features(T: int, seg_i: torch.Tensor, seg_j: torch.Tensor) -> torch.Tensor:
    """[S, 3] features [i/(T-1), j/(T-1), (j-i)/(T-1)]."""
    denom = float(max(1, T - 1))
    i_norm = seg_i.float() / denom
    j_norm = seg_j.float() / denom
    return torch.stack([i_norm, j_norm, j_norm - i_norm], dim=-1)


def build_segment_features_from_idx(idx: torch.Tensor, T: int,
                                    seg_feat_dim: int = 3) -> torch.Tensor:
    """Per-consecutive-segment [i/T, j/T, gap/T] features from [B, K] idx."""
    if idx.ndim != 2:
        raise ValueError("idx must be [B, K]")
    B, K = idx.shape
    if seg_feat_dim <= 0:
        return torch.zeros((B, K - 1, 0), device=idx.device)
    denom = float(max(1, T - 1))
    i = idx[:, :-1].float() / denom
    j = idx[:, 1:].float() / denom
    feat = torch.stack([i, j, j - i], dim=-1)
    if seg_feat_dim <= 3:
        return feat[:, :, :seg_feat_dim]
    pad = torch.zeros((B, K - 1, seg_feat_dim - 3), dtype=feat.dtype, device=feat.device)
    return torch.cat([feat, pad], dim=-1)


def compute_segment_costs_batch(x_pos: torch.Tensor, precomp: SegmentPrecompute,
                                weight_scale: float = 1.0) -> torch.Tensor:
    """Interp-MSE cost per segment: sum over sampled interior frames of
    ‖x_t − lerp(x_i, x_j, α_t)‖² × (interior/P). x_pos: [B, T, ≥2] -> [B, S]."""
    B = x_pos.shape[0]
    if x_pos.shape[-1] < 2:
        raise ValueError("x_pos must have at least 2 dims")
    xy = x_pos[..., :2].float()
    x_i = xy[:, precomp.seg_i]          # [B, S, 2]
    x_j = xy[:, precomp.seg_j]
    mu = x_i[:, :, None, :] + precomp.alpha[None, :, :, None] * (x_j - x_i)[:, :, None, :]
    x_t = xy[:, precomp.t_idx.reshape(-1)].reshape(B, *precomp.t_idx.shape, 2)
    sq = ((x_t - mu) ** 2).sum(dim=-1)      # [B, S, P]
    cost = sq.sum(dim=-1) * precomp.weight[None, :]
    if weight_scale != 1.0:
        cost = cost * weight_scale
    return cost


def build_cost_matrix_from_segments(cost_seg: torch.Tensor, precomp: SegmentPrecompute,
                                    T: int) -> torch.Tensor:
    """[S] or [B, S] segment costs -> [T, T] / [B, T, T] matrix (1e30 elsewhere)."""
    if cost_seg.ndim == 1:
        C = torch.full((T, T), _POS_INF, dtype=cost_seg.dtype, device=cost_seg.device)
        C[precomp.seg_i, precomp.seg_j] = cost_seg
        return C
    C = torch.full((cost_seg.shape[0], T, T), _POS_INF, dtype=cost_seg.dtype,
                   device=cost_seg.device)
    C[:, precomp.seg_i, precomp.seg_j] = cost_seg
    return C


build_cost_matrix_from_segments_batch = build_cost_matrix_from_segments


def dp_select_indices_batch(C: torch.Tensor, K: int) -> torch.Tensor:
    """Min-cost K-anchor path 0 → T−1 through cost matrix C [B, T, T].

    dp[k, j] = min_{i<j} dp[k−1, i] + C[i, j]; returns sorted idx [B, K]
    (long). Each k-step is one [B, T, T] masked min; the argmin keeps the
    parents (first index on ties)."""
    if C.ndim == 2:
        return dp_select_indices(C, K)
    B, T, _ = C.shape
    if K < 2:
        raise ValueError("K must be >= 2")
    K = min(K, T)
    tril = torch.tril(torch.ones((T, T), dtype=torch.bool, device=C.device))
    C_masked = torch.where(tril[None], torch.full_like(C, _POS_INF), C)
    dp = torch.full((B, T), _POS_INF, dtype=C.dtype, device=C.device)
    dp[:, 0] = 0.0
    parents = []
    for _ in range(K - 1):
        cand = dp[:, :, None] + C_masked            # cand[b, i, j]
        parent = torch.argmin(cand, dim=1)          # [B, T]
        dp = torch.gather(cand, 1, parent[:, None, :])[:, 0, :]
        parents.append(parent)
    cur = torch.full((B,), T - 1, dtype=torch.long, device=C.device)
    path = [cur]
    for parent in reversed(parents):
        cur = torch.gather(parent, 1, cur[:, None])[:, 0]
        path.append(cur)
    return torch.stack(path[::-1], dim=1)


def dp_select_indices(C: torch.Tensor, K: int) -> torch.Tensor:
    """Single-sample variant; C: [T, T] -> idx [K]."""
    return dp_select_indices_batch(C[None], K)[0]


def build_kp_feat_batch(idx: torch.Tensor, T: int) -> torch.Tensor:
    """Per-keypoint [left-gap, right-gap, t_norm] features from [B, K] idx."""
    if idx.ndim != 2:
        raise ValueError("idx must be [B, K]")
    B, K = idx.shape
    denom = float(max(1, T - 1))
    t_norm = idx.float() / denom
    zero = torch.zeros((B, 1), device=idx.device)
    if K > 1:
        gaps = (idx[:, 1:] - idx[:, :-1]).float() / denom
        left = torch.cat([zero, gaps], dim=1)
        right = torch.cat([gaps, zero], dim=1)
    else:
        left = right = torch.zeros((B, K), device=idx.device)
    return torch.stack([left, right, t_norm], dim=-1)


def build_kp_feat(idx: torch.Tensor, T: int) -> torch.Tensor:
    return build_kp_feat_batch(idx[None], T)[0]


def build_kp_feat_full(idx: torch.Tensor, T: int, kp_feat_dim: int,
                       seg_cost: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channels [left_gap, right_gap, t_norm, left_cost, right_cost][:kp_feat_dim],
    zero-padded above. The cost channels are the D_phi segment cost of each
    keypoint's left / right consecutive segment (`seg_cost` [B, K-1]); they
    are filled only when kp_feat_dim >= 5 and seg_cost is given, and stay zero
    otherwise."""
    feat = build_kp_feat_batch(idx, T)
    if kp_feat_dim >= 5 and seg_cost is not None:
        zero = torch.zeros((idx.shape[0], 1), dtype=seg_cost.dtype, device=seg_cost.device)
        left = torch.cat([zero, seg_cost], dim=1)     # 0 at the first keypoint
        right = torch.cat([seg_cost, zero], dim=1)    # 0 at the last
        feat = torch.cat([feat, left[..., None].to(feat.dtype),
                          right[..., None].to(feat.dtype)], dim=-1)
    if kp_feat_dim > feat.shape[-1]:
        feat = torch.nn.functional.pad(feat, (0, kp_feat_dim - feat.shape[-1]))
    return feat[:, :, :kp_feat_dim]
