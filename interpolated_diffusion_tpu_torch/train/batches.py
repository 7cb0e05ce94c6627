"""Training batch construction for Stage 1 (keypoints) and Stage 2 (levels)
(port of train/batches.py).

As in the JAX package every level is computed and the sampled level gathered
(levels is small and every branch has fixed shapes). Randomness is explicit:
see `Rng` below.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from ..ops.keyframes import (build_nested_masks_batch, interpolate_from_indices,
                             recompute_velocity_channels, sample_fixed_k_indices_batch)
from ..ops.normalize import logit_pos
from ..ops.video_keyframes import distance_alpha


def gather_keypoints(x0: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x0 [B, T, D], idx [B, K] -> [B, K, D]."""
    return torch.gather(x0, 1, idx.long()[..., None].expand(-1, -1, x0.shape[-1]))


def build_known_mask_values(idx: torch.Tensor, cond: Dict[str, torch.Tensor],
                            D: int, T: int, clamp_endpoints: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Known-endpoint mask/values over keypoint slots.

    Position dims (0:2) of tokens sitting at frame 0 / frame T-1 are known and
    clamped to start/goal; velocity dims stay free.
    """
    B, K = idx.shape
    known_mask = torch.zeros((B, K, D), dtype=torch.bool, device=idx.device)
    known_values = torch.zeros((B, K, D), dtype=torch.float32, device=idx.device)
    if clamp_endpoints and D >= 2:
        if "start_goal" not in cond:
            raise ValueError("clamp_endpoints=True but start_goal missing from cond")
        sg = cond["start_goal"].to(torch.float32)
        start, goal = sg[:, None, :2], sg[:, None, 2:]
        mask_start = (idx == 0)[..., None]
        mask_goal = (idx == T - 1)[..., None]
        known_mask[:, :, :2] = (mask_start | mask_goal).expand(B, K, 2)
        pos_vals = torch.where(mask_start, start, torch.zeros_like(start))
        known_values[:, :, :2] = torch.where(mask_goal, goal, pos_vals)
    return known_mask, known_values


# ---------------------------------------------------------------------------
# Random draws: a torch.Generator, or the draws themselves
# ---------------------------------------------------------------------------
#
# Every function below takes `rng`: a torch.Generator (draws are made on its
# device, in a fixed order) or a dict of named draws, so that a test can hand
# in the draws another framework made. Names and shapes are listed with each
# function.

Rng = Union[torch.Generator, Dict]


def draw(rng: Rng, name: str, kind: str, shape, low: int = 0, high: int = 0) -> torch.Tensor:
    """The draw `name`: rng[name] from a dict, else `kind` ("uniform" in
    [0, 1), "normal", or "randint" in [low, high)) of `shape` from the generator."""
    if isinstance(rng, dict):
        return rng[name]
    if kind == "uniform":
        return torch.rand(shape, generator=rng, device=rng.device)
    if kind == "normal":
        return torch.randn(shape, generator=rng, device=rng.device)
    return torch.randint(low, high, shape, generator=rng, device=rng.device)


def sub_rng(rng: Rng, name: str) -> Rng:
    """The draws of one sub-step: rng[name] from a dict, else the generator."""
    return rng[name] if isinstance(rng, dict) else rng


def build_keypoint_batch(rng: Rng, x0: torch.Tensor, K: int, cond: Dict[str, torch.Tensor],
                         logit_space: bool = False, logit_eps: float = 1e-5,
                         clamp_endpoints: bool = True,
                         idx_override: Optional[torch.Tensor] = None):
    """Returns (z0 [B,K,D], idx [B,K], known_mask [B,K,D], known_values).
    Draw: "idx_rand" uniform [B, T-2] (unless idx_override is given)."""
    B, T, D = x0.shape
    if idx_override is None:
        idx, _ = sample_fixed_k_indices_batch(
            B, T, K, ensure_endpoints=True,
            rand=draw(rng, "idx_rand", "uniform", (B, T - 2)).to(x0.device))
    else:
        idx = idx_override.long()
    z0 = gather_keypoints(x0, idx)
    known_mask, known_values = build_known_mask_values(idx, cond, D, T, clamp_endpoints)
    if logit_space:
        z0 = logit_pos(z0, eps=logit_eps)
        known_values = logit_pos(known_values, eps=logit_eps)
    return z0, idx, known_mask, known_values


# ---------------------------------------------------------------------------
# Stage-2 level corruption
# ---------------------------------------------------------------------------

def compute_sigma_for_level(K_s: int, K_min: int, sigma_max: float, sigma_min: float,
                            sigma_pow: float) -> float:
    """sigma(K_s) = sigma_max (K_min / K_s)^pow, clipped to [sigma_min, sigma_max]."""
    if sigma_max <= 0.0:
        return 0.0
    ratio = float(max(1, K_min)) / float(max(1, K_s))
    sigma = float(sigma_max) * (ratio ** float(sigma_pow))
    return max(float(sigma_min), min(float(sigma_max), sigma))


def compute_jitter_for_level(K_s: int, K_min: int, jitter_max: int, jitter_pow: float) -> int:
    if jitter_max <= 0:
        return 0
    ratio = float(max(1, K_min)) / float(max(1, K_s))
    jitter = int(round(float(jitter_max) * (ratio ** float(jitter_pow))))
    return max(0, min(int(jitter_max), jitter))


def parse_policy_mix(spec: str) -> List[Tuple[str, float]]:
    """Parse "dp:0.7,uniform:0.2,random:0.1" into normalized (name, w) pairs."""
    if not spec:
        return []
    mix = []
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        if ":" not in part:
            raise ValueError(f"Invalid policy mix entry: {part}")
        name, weight = part.split(":", 1)
        mix.append((name.strip(), float(weight)))
    total = sum(w for _, w in mix)
    if total <= 0:
        raise ValueError("policy mix weights must sum to > 0")
    return [(n, w / total) for n, w in mix]


def _add_pos(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """x with `delta` added to its first two (position) dims."""
    return torch.cat([x[..., :2] + delta, x[..., 2:]], dim=-1)


def corrupt_from_anchors(rng: Rng, source: torch.Tensor, idx: torch.Tensor, T: int,
                         sigma: float, anchor_sigma: float, index_jitter: int,
                         index_jitter_prob: float, mode: str, clamp_endpoints: bool,
                         recompute_velocity: bool, return_prenoise: bool = False):
    """Interp-corrupt with optional anchor-index jitter, anchor-value noise,
    and distance-scaled Gaussian noise on the interpolated positions.

    With return_prenoise, also returns the interpolation before the iid
    per-frame dist/gauss noise (anchor jitter and anchor noise still applied):
    the segment-smooth signal a velocity recompute should read.

    Draws, each only when its corruption is on: "jit" randint [B, K] in
    [-index_jitter, index_jitter], "use" uniform [B, K], "anchor" normal
    [B, K, 2], "noise" normal [B, T, 2].
    """
    B, _, D = source.shape
    idx = idx.long()
    K = idx.shape[1]
    dev = source.device
    idx_j = idx
    if index_jitter > 0 and index_jitter_prob > 0.0:
        jit = draw(rng, "jit", "randint", (B, K), -index_jitter, index_jitter + 1).to(dev).long()
        use = draw(rng, "use", "uniform", (B, K)).to(dev) < float(index_jitter_prob)
        if clamp_endpoints:
            use = use & (idx != 0) & (idx != T - 1)
        idx_j = torch.clamp(torch.where(use, idx + jit, idx), 0, T - 1)
    # values come from the (possibly jittered) frames, but the anchors keep
    # their own positions in the interpolation
    vals = gather_keypoints(source, idx_j)
    if anchor_sigma > 0.0:
        noise = draw(rng, "anchor", "normal", (B, K, 2)).to(source) * float(anchor_sigma)
        if clamp_endpoints:
            end = ((idx == 0) | (idx == T - 1))[..., None]
            noise = torch.where(end, torch.zeros_like(noise), noise)
        vals = _add_pos(vals, noise)
    x = interpolate_from_indices(idx, vals, T, recompute_velocity=False)
    x_prenoise = x
    if sigma > 0.0:
        alpha = distance_alpha(idx, T) if mode == "dist" else 1.0
        noise = draw(rng, "noise", "normal", (B, T, 2)).to(source) * float(sigma)
        x = _add_pos(x, noise * alpha)
    if recompute_velocity and D == 4:
        x = recompute_velocity_channels(x, T)
    if return_prenoise:
        return x, x_prenoise
    return x


CORRUPTION_DEFAULTS = dict(
    corrupt_mode="none", corrupt_sigma_max=0.0, corrupt_sigma_min=0.0, corrupt_sigma_pow=1.0,
    corrupt_anchor_frac=0.0, corrupt_index_jitter_max=0, corrupt_index_jitter_prob=0.0,
    corrupt_index_jitter_pow=1.0, clamp_endpoints=True, pos_clip=False, pos_clip_min=0.0,
    pos_clip_max=1.0, corrupt_vel=False)


def _level_interp(rng: Rng, source: torch.Tensor, idx_s: torch.Tensor, T: int, K_min: int,
                  recompute_velocity: bool, corrupt_mode: str, corrupt_sigma_max: float,
                  corrupt_sigma_min: float, corrupt_sigma_pow: float,
                  corrupt_anchor_frac: float, corrupt_index_jitter_max: int,
                  corrupt_index_jitter_prob: float, corrupt_index_jitter_pow: float,
                  clamp_endpoints: bool, pos_clip: bool, pos_clip_min: float,
                  pos_clip_max: float, corrupt_vel: bool = False) -> torch.Tensor:
    K_s = idx_s.shape[1]
    if corrupt_mode != "none":
        sigma = compute_sigma_for_level(K_s, K_min, corrupt_sigma_max, corrupt_sigma_min,
                                        corrupt_sigma_pow)
        jitter = compute_jitter_for_level(K_s, K_min, corrupt_index_jitter_max,
                                          corrupt_index_jitter_pow)
        xs, xs_prenoise = corrupt_from_anchors(
            rng, source, idx_s, T, sigma, sigma * float(corrupt_anchor_frac), jitter,
            corrupt_index_jitter_prob, corrupt_mode, clamp_endpoints,
            recompute_velocity=False, return_prenoise=True)
    else:
        xs = interpolate_from_indices(idx_s, gather_keypoints(source, idx_s), T,
                                      recompute_velocity=False)
        xs_prenoise = xs
    if pos_clip:
        clip = lambda x: torch.cat([torch.clamp(x[..., :2], pos_clip_min, pos_clip_max),
                                    x[..., 2:]], dim=-1)
        xs, xs_prenoise = clip(xs), clip(xs_prenoise)
    # Velocities from the clipped positions, and by default (corrupt_vel
    # False) from the positions before the iid dist/gauss noise: a finite
    # difference of iid noise, times T, is an artifact that neither clean data
    # nor sampling-time inputs contain.
    if recompute_velocity and source.shape[-1] == 4:
        vsrc = xs if corrupt_vel else xs_prenoise
        xs = torch.cat([xs[..., :2], recompute_velocity_channels(vsrc, T)[..., 2:]], dim=-1)
    return xs


def _masks_and_levels(rng: Rng, B: int, T: int, K_min: int, levels: int, masks_levels,
                      idx_levels, s_idx, device):
    if masks_levels is None or idx_levels is None:
        masks_levels, idx_levels = build_nested_masks_batch(
            B, T, K_min, levels, rand=draw(rng, "mask_rand", "uniform", (B, T - 2)).to(device))
    if s_idx is None:
        s_idx = draw(rng, "s_idx", "randint", (B,), 1, levels + 1).to(device)
    return masks_levels, idx_levels, s_idx.long()


def _take_level(masks_levels: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """masks_levels [B, S, T], s [B] -> [B, T]."""
    T = masks_levels.shape[-1]
    return torch.gather(masks_levels, 1, s[:, None, None].expand(-1, 1, T))[:, 0]


def build_interp_level_batch(rng: Rng, x0: torch.Tensor, K_min: int, levels: int,
                             recompute_velocity: bool = False,
                             x0_override: Optional[torch.Tensor] = None,
                             masks_levels: Optional[torch.Tensor] = None,
                             idx_levels: Optional[List[torch.Tensor]] = None,
                             s_idx: Optional[torch.Tensor] = None, **corruption):
    """x_s = Interp(x0 | M_s) at a sampled level s per sample.

    Returns (x_s, mask_s, s_idx, masks_levels, idx_levels). Every level is
    computed, then the sampled level is gathered. Draws: "mask_rand" uniform
    [B, T-2] and "s_idx" randint [B] in [1, levels] unless given; "levels": a
    list indexed by level s of corrupt_from_anchors' draws.
    """
    B, T, D = x0.shape
    masks_levels, idx_levels, s_idx = _masks_and_levels(
        rng, B, T, K_min, levels, masks_levels, idx_levels, s_idx, x0.device)
    source = x0_override if x0_override is not None else x0
    corr = {**CORRUPTION_DEFAULTS, **corruption}
    lvl = sub_rng(rng, "levels")
    x_all = torch.stack([
        _level_interp(lvl[s] if isinstance(lvl, list) else lvl, source, idx_levels[s], T, K_min,
                      recompute_velocity, **corr)
        for s in range(1, levels + 1)], dim=0)             # [levels, B, T, D]
    b = torch.arange(B, device=x0.device)
    return x_all[s_idx - 1, b], _take_level(masks_levels, s_idx), s_idx, masks_levels, idx_levels


def build_interp_adjacent_batch(rng: Rng, x0: torch.Tensor, K_min: int, levels: int,
                                recompute_velocity: bool = False,
                                x0_override: Optional[torch.Tensor] = None,
                                masks_levels: Optional[torch.Tensor] = None,
                                idx_levels: Optional[List[torch.Tensor]] = None,
                                s_idx: Optional[torch.Tensor] = None,
                                clean_target: bool = True, **corruption):
    """Adjacent-level pair (x_s, x_{s-1}) for delta-prediction training.

    Returns (x_s, x_prev, mask_s, mask_prev, s_idx, masks_levels, idx_levels).
    With clean_target (the default) the target level x_{s-1} is the clean
    interpolation: the corruption noise is zero-mean, so an independently
    noised target adds only variance that the model can never fit.
    clean_target=False draws an independent corruption for the target.
    Draws as for build_interp_level_batch, "levels" indexed 0 .. levels.
    """
    B, T, D = x0.shape
    masks_levels, idx_levels, s_idx = _masks_and_levels(
        rng, B, T, K_min, levels, masks_levels, idx_levels, s_idx, x0.device)
    source = x0_override if x0_override is not None else x0
    corr = {**CORRUPTION_DEFAULTS, **corruption}
    lvl = sub_rng(rng, "levels")
    x_all = torch.stack([
        _level_interp(lvl[s] if isinstance(lvl, list) else lvl, source, idx_levels[s], T, K_min,
                      recompute_velocity, **corr)
        for s in range(levels + 1)], dim=0)                # [levels+1, B, T, D]
    b = torch.arange(B, device=x0.device)
    x_s = x_all[s_idx, b]
    if clean_target and corr["corrupt_mode"] != "none":
        clean = dict(corr, corrupt_mode="none")
        x_clean = torch.stack([
            _level_interp({}, source, idx_levels[s], T, K_min, recompute_velocity, **clean)
            for s in range(levels)], dim=0)                # only levels 0 .. levels-1 are targets
        x_prev = x_clean[s_idx - 1, b]
    else:
        x_prev = x_all[s_idx - 1, b]
    return (x_s, x_prev, _take_level(masks_levels, s_idx), _take_level(masks_levels, s_idx - 1),
            s_idx, masks_levels, idx_levels)
