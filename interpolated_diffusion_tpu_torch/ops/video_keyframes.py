"""Interpolation corruption for video latents and token grids (port of
ops/video_keyframes.py).

Segment lerp with an optional smoothing or learned (`interp_fn`)
refinement, anchors re-scattered exactly; `distance_alpha`, the noise scale of the distance-scaled corruption;
and the Phase-2 corruption batch builders for flat latents [B, T, D] and
token grids [B, T, N, D]: level (x0 mode) and adjacent-level (adj mode)
batches with student-anchor replacement (noisy teacher values, or
precomputed Phase-1 anchors joined by frame index), per-frame confidence and
Gaussian or distance-scaled noise attenuated at the anchors. Every level is
computed and the sampled one gathered, as in the JAX package.

Every random draw is an argument: the builders take the dict of
`make_video_interp_draws` (the nested masks' uniforms, the sampled level, and
per level the replacement uniforms, the student noise and the corruption
noise), so that a test can hand in JAX's draws.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .keyframes import build_nested_masks_batch, compute_k_schedule, interpolate_from_indices

Draws = Dict[str, object]


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
                                   smooth_kernel: Optional[torch.Tensor] = None,
                                   interp_fn: Optional[Callable[[torch.Tensor], torch.Tensor]]
                                   = None) -> torch.Tensor:
    """idx [B, K] sorted anchor frames, vals [B, K, D] -> [B, T, D]: segment
    lerp (`linear`), the lerp smoothed by `smooth_kernel` (default
    [0.25, 0.5, 0.25]; `smooth`) or refined by `interp_fn` ([B, T, D] ->
    [B, T, D]; `learned`), the anchors written back exactly after either."""
    z = interpolate_from_indices(idx, vals, T, recompute_velocity=False)
    if mode == "linear":
        return z
    if mode == "smooth":
        if smooth_kernel is None:
            smooth_kernel = torch.tensor([0.25, 0.5, 0.25], dtype=z.dtype, device=z.device)
        z = smooth_latents(z, smooth_kernel)
    elif mode == "learned":
        if interp_fn is None:
            raise ValueError("interp_fn is required for mode='learned'")
        z = interp_fn(z)
    else:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    index = idx.long()[..., None].expand(-1, -1, z.shape[-1])
    return z.scatter(1, index, vals.to(z.dtype))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] at frames idx [B, K] -> [B, K, D]."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def _gather_anchor_values(anchor_values: torch.Tensor, anchor_idx: Optional[torch.Tensor],
                          idx: torch.Tensor, T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals [B, K, D'], valid [B, K]): precomputed student anchors matched to
    this level's frames idx [B, K]. `anchor_values` is a full grid [B, T, D']
    (anchor_idx None) or the values at anchor_idx [B, Ka, D']; a frame that
    is not among anchor_idx is not valid."""
    B, K = idx.shape
    if anchor_values.shape[1] == T and anchor_idx is None:
        return _take(anchor_values, idx), torch.ones((B, K), dtype=torch.bool, device=idx.device)
    if anchor_idx is None:
        raise ValueError("anchor_idx required when anchor_values is [B,Ka,D']")
    Ka = anchor_idx.shape[1]
    lookup = torch.full((B, T), -1, dtype=torch.long, device=idx.device)
    lookup.scatter_(1, anchor_idx.long(),
                    torch.arange(Ka, device=idx.device).expand(B, Ka).contiguous())
    pos = torch.gather(lookup, 1, idx.long())
    return _take(anchor_values, torch.clamp(pos, min=0)), pos >= 0


def _level_video_interp(z0: torch.Tensor, idx: torch.Tensor, mask_s: torch.Tensor, T: int,
                        draws: Dict[str, torch.Tensor], *, corrupt_mode: str,
                        corrupt_sigma: float, anchor_noise_frac: float,
                        student_replace_prob: float, student_noise_std: float,
                        anchor_values: Optional[torch.Tensor],
                        anchor_idx: Optional[torch.Tensor], conf_anchor: float,
                        conf_student: float, conf_endpoints: float, conf_missing: float,
                        clamp_endpoints: bool, interp_mode: str,
                        smooth_kernel: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's corrupted interpolation [B, T, D] and per-frame confidence
    [B, T]. draws: "rep" [B, K] uniforms, "noise_a" [B, K, D] and "noise"
    [B, T, D] standard normals."""
    B, _, D = z0.shape
    K = idx.shape[1]
    vals = _take(z0, idx)
    replace_mask = torch.zeros((B, K), dtype=torch.bool, device=z0.device)
    if student_replace_prob > 0.0:
        replace_mask = draws["rep"].to(z0.device) < float(student_replace_prob)
        if clamp_endpoints:
            replace_mask = replace_mask & (idx != 0) & (idx != T - 1)
        noise_a = draws["noise_a"].to(device=z0.device, dtype=vals.dtype)
        if anchor_values is not None:
            student_vals, valid = _gather_anchor_values(anchor_values, anchor_idx, idx, T)
            replace_mask = replace_mask & valid
            if student_noise_std > 0.0:
                student_vals = student_vals + noise_a.to(student_vals.dtype) * float(
                    student_noise_std)
            vals = torch.where(replace_mask[..., None], student_vals.to(vals.dtype), vals)
        else:
            vals = torch.where(replace_mask[..., None], vals + noise_a * float(student_noise_std),
                               vals)

    zs = interpolate_video_from_indices(idx, vals, T, mode=interp_mode,
                                        smooth_kernel=smooth_kernel)
    if corrupt_mode != "none" and corrupt_sigma > 0.0:
        noise = draws["noise"].to(device=zs.device, dtype=zs.dtype) * float(corrupt_sigma)
        if corrupt_mode == "dist":
            noise = noise * distance_alpha(idx, T).to(zs.dtype)
        if anchor_noise_frac < 1.0:
            scale = torch.where(mask_s, float(anchor_noise_frac), 1.0).to(zs.dtype)
            zs = zs + noise * scale[..., None]
        else:
            zs = zs + noise

    conf = torch.full((B, T), float(conf_missing), device=z0.device)
    conf_vals = torch.where(replace_mask, float(conf_student), float(conf_anchor)).float()
    conf = conf.scatter(1, idx.long(), conf_vals)
    if clamp_endpoints:
        conf[:, 0] = float(conf_endpoints)
        conf[:, -1] = float(conf_endpoints)
    return zs, conf


_DEFAULTS = dict(
    corrupt_mode="gauss", corrupt_sigma=0.02, anchor_noise_frac=0.25,
    student_replace_prob=0.5, student_noise_std=0.02,
    anchor_values=None, anchor_idx=None,
    conf_anchor=0.95, conf_student=0.5, conf_endpoints=1.0, conf_missing=0.0,
    clamp_endpoints=True, interp_mode="linear", smooth_kernel=None,
)


def make_video_interp_draws(generator: torch.Generator, B: int, T: int, D: int, K_min: int,
                            levels: int, adjacent: bool, k_schedule: str = "doubling"
                            ) -> Draws:
    """The corruption batch's random draws from `generator` (on its device):
    "mask_rand" [B, T - 2] uniforms (the nested masks' interior order),
    "s_idx" [B] levels in 1..levels, and "levels" {s: {"rep" [B, K_s],
    "noise_a" [B, K_s, D], "noise" [B, T, D]}} for every level the builder
    computes (1..levels, or 0..levels when `adjacent`)."""
    dev = generator.device
    K_list = compute_k_schedule(T, K_min, levels, schedule=k_schedule)
    per_level = {}
    for s in range(0 if adjacent else 1, levels + 1):
        K = K_list[s]
        per_level[s] = {"rep": torch.rand((B, K), generator=generator, device=dev),
                        "noise_a": torch.randn((B, K, D), generator=generator, device=dev),
                        "noise": torch.randn((B, T, D), generator=generator, device=dev)}
    return {"mask_rand": torch.rand((B, T - 2), generator=generator, device=dev),
            "s_idx": torch.randint(1, levels + 1, (B,), generator=generator, device=dev),
            "levels": per_level}


def _all_levels(draws: Draws, z0: torch.Tensor, K_min: int, levels: int, first: int,
                masks_levels, idx_levels, s_idx, kwargs):
    opts = {**_DEFAULTS, **kwargs}
    B, T, _ = z0.shape
    if masks_levels is None or idx_levels is None:
        masks_levels, idx_levels = build_nested_masks_batch(
            B, T, K_min, levels, rand=draws["mask_rand"].to(z0.device))
    if s_idx is None:
        s_idx = draws["s_idx"]
    s_idx = s_idx.long().to(z0.device)
    zs_all, conf_all = [], []
    for s in range(first, levels + 1):
        zs, conf = _level_video_interp(z0, idx_levels[s], masks_levels[:, s], T,
                                       draws["levels"][s], **opts)
        zs_all.append(zs)
        conf_all.append(conf)
    return (torch.stack(zs_all), torch.stack(conf_all), masks_levels, idx_levels, s_idx,
            torch.arange(B, device=z0.device))


def build_video_interp_level_batch(draws: Draws, z0_flat: torch.Tensor, K_min: int, levels: int,
                                   masks_levels: Optional[torch.Tensor] = None,
                                   idx_levels: Optional[List[torch.Tensor]] = None,
                                   s_idx: Optional[torch.Tensor] = None, **kwargs):
    """x0-mode corruption batch for flat video latents [B, T, D].

    Returns (z_interp, mask_s, s_idx, masks_levels, idx_levels, conf_s)."""
    zs_all, conf_all, masks_levels, idx_levels, s_idx, b = _all_levels(
        draws, z0_flat, K_min, levels, 1, masks_levels, idx_levels, s_idx, kwargs)
    mask_s = masks_levels[b, s_idx]
    return zs_all[s_idx - 1, b], mask_s, s_idx, masks_levels, idx_levels, conf_all[s_idx - 1, b]


def build_video_interp_adjacent_batch(draws: Draws, z0_flat: torch.Tensor, K_min: int,
                                      levels: int, masks_levels: Optional[torch.Tensor] = None,
                                      idx_levels: Optional[List[torch.Tensor]] = None,
                                      s_idx: Optional[torch.Tensor] = None, **kwargs):
    """Adjacent-mode corruption batch: returns (z_s, z_prev, mask_s,
    mask_prev, s_idx, masks_levels, idx_levels, conf_s, conf_prev)."""
    zs_all, conf_all, masks_levels, idx_levels, s_idx, b = _all_levels(
        draws, z0_flat, K_min, levels, 0, masks_levels, idx_levels, s_idx, kwargs)
    return (zs_all[s_idx, b], zs_all[s_idx - 1, b], masks_levels[b, s_idx],
            masks_levels[b, s_idx - 1], s_idx, masks_levels, idx_levels, conf_all[s_idx, b],
            conf_all[s_idx - 1, b])


def _tokens_to_flat(z: torch.Tensor) -> torch.Tensor:
    B, T, N, D = z.shape
    return z.reshape(B, T, N * D)


def _flat_to_tokens(z: torch.Tensor, N: int, D: int) -> torch.Tensor:
    B, T, _ = z.shape
    return z.reshape(B, T, N, D)


def _flat_anchor_kwargs(kwargs: Dict) -> Dict:
    av = kwargs.get("anchor_values")
    if av is not None and av.ndim == 4:
        kwargs = dict(kwargs, anchor_values=av.reshape(av.shape[0], av.shape[1], -1))
    return kwargs


def build_video_token_interp_level_batch(draws: Draws, z0_tokens: torch.Tensor, K_min: int,
                                         levels: int, **kwargs):
    """Token-grid x0-mode corruption ([B, T, N, D]); anchors are per frame.
    The spatial tokens fold into the feature dim (the interpolation is linear
    per feature) and the confidence and mask broadcast per frame to
    [B, T, N]. Returns the flat builder's tuple with token-shaped z and conf."""
    B, T, N, D = z0_tokens.shape
    z, mask_s, s_idx, masks_levels, idx_levels, conf_s = build_video_interp_level_batch(
        draws, _tokens_to_flat(z0_tokens), K_min, levels, **_flat_anchor_kwargs(kwargs))
    expand = lambda m: m[..., None].expand(B, T, N)
    return (_flat_to_tokens(z, N, D), expand(mask_s), s_idx, masks_levels, idx_levels,
            expand(conf_s))


def build_video_token_interp_adjacent_batch(draws: Draws, z0_tokens: torch.Tensor, K_min: int,
                                            levels: int, **kwargs):
    """Token-grid adjacent-mode corruption: the adjacent builder's tuple with
    token-shaped z_s, z_prev and [B, T, N] masks and confidences."""
    B, T, N, D = z0_tokens.shape
    (z_s, z_prev, mask_s, mask_prev, s_idx, masks_levels, idx_levels, conf_s,
     conf_prev) = build_video_interp_adjacent_batch(
        draws, _tokens_to_flat(z0_tokens), K_min, levels, **_flat_anchor_kwargs(kwargs))
    expand = lambda m: m[..., None].expand(B, T, N)
    return (_flat_to_tokens(z_s, N, D), _flat_to_tokens(z_prev, N, D), expand(mask_s),
            expand(mask_prev), s_idx, masks_levels, idx_levels, expand(conf_s),
            expand(conf_prev))
