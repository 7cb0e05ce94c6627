"""K-schedules, nested keyframe masks and segment-lerp (port of ops/keyframes.py).

Index tensors are int64 here (torch's gather/scatter need it) where the JAX
package keeps int32. Random priorities come from an explicit `rand` draw or a
`torch.Generator`, so a test can inject the exact draw JAX made.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def compute_k_schedule(T: int, K_min: int, levels: int, schedule: str = "doubling",
                       geom_gamma: Optional[float] = None) -> List[int]:
    """Anchor counts per level, K_list[s] for s = 0 (finest) .. levels (coarsest).

    Host-side, identical to the JAX package's compute_k_schedule.
    """
    K_min = min(K_min, T)
    K_list = [0 for _ in range(levels + 1)]
    K_list[levels] = K_min
    if levels <= 0:
        return K_list
    if schedule == "doubling":
        for s in range(levels, 0, -1):
            K_list[s - 1] = min(T, max(K_list[s] + 1, 2 * K_list[s]))
        return K_list
    if schedule == "linear":
        for s in range(levels - 1, -1, -1):
            frac = float(levels - s) / float(levels)
            target = int(round(K_min + frac * (T - K_min)))
            K_list[s] = min(T, max(K_list[s + 1] + 1, target))
        return K_list
    if schedule == "geom":
        if geom_gamma is None:
            geom_gamma = (float(T) / float(K_min)) ** (1.0 / float(levels)) if K_min > 0 else 1.0
        for s in range(levels - 1, -1, -1):
            target = int(round(K_min * (geom_gamma ** float(levels - s))))
            K_list[s] = min(T, max(K_list[s + 1] + 1, target))
        return K_list
    raise ValueError(f"Unknown k schedule: {schedule}")


def _mask_from_idx(idx: torch.Tensor, T: int) -> torch.Tensor:
    """[B, K] int indices -> [B, T] bool mask."""
    mask = torch.zeros((idx.shape[0], T), dtype=torch.bool, device=idx.device)
    return mask.scatter(1, idx.long(), True)


def sample_fixed_k_indices_batch(
    B: int, T: int, K: int, ensure_endpoints: bool = True,
    rand: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K sorted random anchor indices per sample (endpoints forced by default).

    Returns (idx [B, K] int64, mask [B, T] bool). The interior anchors are
    the K - 2 lowest of a uniform draw [B, T - 2] ([B, T] without endpoints):
    `rand` when given, else drawn from `generator`.
    """
    if T <= 0 or K <= 0:
        raise ValueError("T and K must be positive")
    if ensure_endpoints and (T < 2 or K < 2):
        raise ValueError("T and K must be >= 2 when ensure_endpoints is True")
    K = min(K, T)
    interior = ensure_endpoints and T > 2 and K > 2
    n = T - 2 if ensure_endpoints else T
    if rand is None and (interior or not ensure_endpoints):
        if generator is None:
            raise ValueError("sample_fixed_k_indices_batch needs rand or a generator")
        rand = torch.rand((B, n), generator=generator, device=generator.device)
    if ensure_endpoints:
        device = rand.device if rand is not None else (generator.device if generator else None)
        ends = [torch.zeros((B, 1), dtype=torch.long, device=device),
                torch.full((B, 1), T - 1, dtype=torch.long, device=device)]
        if interior:
            chosen = torch.argsort(rand, dim=1, stable=True)[:, :K - 2] + 1
            idx = torch.cat([ends[0], chosen, ends[1]], dim=1)
        else:
            idx = torch.cat(ends, dim=1)
    else:
        idx = torch.argsort(rand, dim=1, stable=True)[:, :K]
    idx = torch.sort(idx, dim=1).values
    return idx, _mask_from_idx(idx, T)


def sample_fixed_k_indices_uniform_batch(
    B: int, T: int, K: int, ensure_endpoints: bool = True, jitter: float = 0.0,
    rand: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniformly spaced anchors with optional jitter; strictly increasing.

    Returns (idx [B, K] int64, mask [B, T] bool). The jitter's uniform draw
    [B, K] in [0, 1) is `rand` when given (a test hands in the JAX draw), else
    drawn from `generator`. Forward and backward monotonic repair sweeps as in
    the JAX package; positions and rounding (half to even) in f32.
    """
    if T <= 0 or K <= 0:
        raise ValueError("T and K must be positive")
    if ensure_endpoints and (T < 2 or K < 2):
        raise ValueError("T and K must be >= 2 when ensure_endpoints is True")
    K = min(K, T)
    if rand is not None:
        device = rand.device
    base = torch.linspace(0.0, T - 1, K, device=device)
    if jitter and K > 2 and T > 2:
        spacing = float(T - 1) / float(K - 1)
        max_jitter = spacing * float(jitter) * 0.5
        if rand is None:
            rand = torch.rand((B, K), generator=generator,
                              device=generator.device if generator is not None else device)
        noise = (rand.to(base) - 0.5) * 2.0 * max_jitter
        noise[:, 0] = 0.0
        noise[:, -1] = 0.0
        pos = base[None, :] + noise
    else:
        pos = base[None, :].expand(B, K)
    idx = torch.clamp(torch.round(pos).long(), 0, T - 1)
    if ensure_endpoints and K >= 2:
        idx[:, 0], idx[:, -1] = 0, T - 1
    cols = [idx[:, k] for k in range(K)]
    for k in range(1, K):
        cols[k] = torch.maximum(cols[k], cols[k - 1] + 1)
    # anchor the top end before the backward sweep: with large jitter the
    # forward sweep can push past T - 1, and a later clip would duplicate anchors
    cols[K - 1] = torch.clamp(cols[K - 1], max=T - 1)
    for k in range(K - 2, -1, -1):
        cols[k] = torch.minimum(cols[k], cols[k + 1] - 1)
    idx = torch.clamp(torch.stack(cols, dim=1), 0, T - 1)
    if ensure_endpoints and K >= 2:
        idx[:, 0], idx[:, -1] = 0, T - 1
    return idx, _mask_from_idx(idx, T)


def _nested_from_order(order: torch.Tensor, T: int, K_list: Sequence[int]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Nested masks/idx from a per-sample priority order [B, T]: the level-s
    anchors are order[:, :K_s], so the levels nest by construction."""
    masks, idx_levels = [], []
    for s in range(len(K_list)):
        K_s = max(int(K_list[s]), 2)
        idx_s = torch.sort(order[:, :K_s].long(), dim=1).values
        idx_levels.append(idx_s)
        masks.append(_mask_from_idx(idx_s, T))
    return torch.stack(masks, dim=1), idx_levels


def build_nested_masks_batch(
    B: int, T: int, K_min: int, levels: int, *, k_schedule: str = "doubling",
    k_geom_gamma: Optional[float] = None, rand: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Random nested masks M_S within ... within M_0, endpoints always included.

    The interior frames are ranked by a uniform draw [B, T - 2] (`rand`, or
    drawn from `generator`); level s takes the endpoints and the first
    K_s - 2 of that order. Returns (masks_levels [B, levels+1, T] bool,
    idx_levels list of [B, K_s]).
    """
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if T < 2:
        raise ValueError("T must be >= 2 when using endpoints")
    K_list = compute_k_schedule(T, K_min, levels, schedule=k_schedule, geom_gamma=k_geom_gamma)
    if rand is None:
        if generator is None:
            raise ValueError("build_nested_masks_batch needs rand or a generator")
        rand = torch.rand((B, T - 2), generator=generator, device=generator.device)
    perm = torch.argsort(rand, dim=1, stable=True) + 1
    ends = torch.tensor([0, T - 1], dtype=torch.long, device=rand.device).expand(B, 2)
    return _nested_from_order(torch.cat([ends, perm], dim=1), T, K_list)


def build_nested_masks_from_base(
    idx_base: torch.Tensor, T: int, levels: int, *,
    k_schedule: str = "doubling", k_geom_gamma: Optional[float] = None,
    rand: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Nested masks whose coarsest level is idx_base [B, K_base].

    Base anchors get priority 2 (ties broken by position, as the stable
    argsort does in JAX); the other positions are ranked by `rand` [B, T]
    uniforms, drawn from `generator` when not given.
    Returns (masks_levels [B, levels+1, T] bool, idx_levels list of [B, K_s]).
    """
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if idx_base.ndim != 2:
        raise ValueError("idx_base must be [B, K]")
    B, K_base = idx_base.shape
    K_list = compute_k_schedule(T, K_base, levels, schedule=k_schedule,
                                geom_gamma=k_geom_gamma)
    if rand is None:
        if generator is None:
            raise ValueError("build_nested_masks_from_base needs rand or a generator")
        rand = torch.rand((B, T), generator=generator, device=idx_base.device)
    base_mask = _mask_from_idx(idx_base, T)
    pri = torch.where(base_mask, torch.full_like(rand, 2.0), rand)
    order = torch.argsort(-pri, dim=1, stable=True)
    return _nested_from_order(order, T, K_list)


def build_nested_masks_from_logits(
    logits: torch.Tensor, K_min: int, levels: int, k_schedule: str = "doubling",
    k_geom_gamma: Optional[float] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Nested masks ranked by selector logits [B, T]; endpoints always first,
    the interior frames by descending logit (ties by position).
    Returns (masks_levels [B, levels+1, T] bool, idx_levels list of [B, K_s])."""
    if logits.ndim != 2:
        raise ValueError("logits must be [B, T]")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    B, T = logits.shape
    if T < 2:
        raise ValueError("T must be >= 2 when using endpoints")
    K_list = compute_k_schedule(T, K_min, levels, schedule=k_schedule, geom_gamma=k_geom_gamma)
    if K_list[levels] < 2:
        raise ValueError("K_min must be >= 2 to include endpoints")
    interior = torch.argsort(-logits[:, 1:-1], dim=1, stable=True) + 1
    ends = torch.tensor([0, T - 1], dtype=torch.long, device=logits.device).expand(B, 2)
    return _nested_from_order(torch.cat([ends, interior], dim=1), T, K_list)


def build_nested_masks_from_level_logits(
    logits_levels: torch.Tensor, K_min: int, levels: int, k_schedule: str = "doubling",
    k_geom_gamma: Optional[float] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Nested masks from per-level logits [B, levels+1, T]: walking coarse to
    fine, each level adds its top (K_s - already selected) positions among
    those not yet selected (ties to the lower index, as jax.lax.top_k).
    Returns (masks_levels [B, levels+1, T] bool, idx_levels list of [B, K_s])."""
    if logits_levels.ndim != 3:
        raise ValueError("logits_levels must be [B, L, T]")
    B, L, T = logits_levels.shape
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if L != levels + 1:
        raise ValueError(f"logits_levels second dim must be levels+1 ({levels + 1}), got {L}")
    if T < 2:
        raise ValueError("T must be >= 2 when using endpoints")
    K_list = compute_k_schedule(T, K_min, levels, schedule=k_schedule, geom_gamma=k_geom_gamma)
    selected = torch.zeros((B, T), dtype=torch.bool, device=logits_levels.device)
    selected[:, 0] = selected[:, -1] = True
    count = 2
    masks = [None] * (levels + 1)
    for s in range(levels, -1, -1):
        need = K_list[s] - count
        if need < 0:
            raise ValueError("K_schedule produced decreasing K values; ensure nestedness.")
        if need > 0:
            row = logits_levels[:, s].float()
            scores = torch.where(selected, torch.full_like(row, -1e9), row)
            top = torch.argsort(-scores, dim=1, stable=True)[:, :need]
            selected = selected | _mask_from_idx(top, T)
            count = K_list[s]
        masks[s] = selected
    masks_levels = torch.stack(masks, dim=1)
    # the K_s selected positions of each level, ascending
    pos = torch.arange(T, device=logits_levels.device)
    idx_levels = [torch.sort(torch.where(masks_levels[:, s], pos, T), dim=1).values[:, :K_list[s]]
                  for s in range(levels + 1)]
    return masks_levels, idx_levels


def interpolate_from_indices(idx: torch.Tensor, vals: torch.Tensor, T: int,
                             recompute_velocity: bool = False) -> torch.Tensor:
    """Piecewise-linear fill between sorted anchors.

    idx: [B, K] sorted anchor positions; vals: [B, K, D] anchor values.
    Returns [B, T, D] with anchors preserved exactly: searchsorted(right)-1
    segment lookup, gap-clamped lerp weights, exact anchor scatter, optional
    velocity recompute for D == 4 ([pos(2), vel(2)] layout).
    """
    if idx.ndim != 2:
        raise ValueError("idx must be [B, K]")
    if vals.ndim != 3:
        raise ValueError("vals must be [B, K, D]")
    idx = idx.long()
    B, K = idx.shape
    D = vals.shape[-1]
    t_grid = torch.arange(T, dtype=torch.long, device=idx.device)
    seg = torch.searchsorted(idx.contiguous(), t_grid.expand(B, T).contiguous(),
                             right=True) - 1
    seg = torch.clamp(seg, 0, K - 2)
    left_idx = torch.gather(idx, 1, seg)
    right_idx = torch.gather(idx, 1, seg + 1)
    left_val = torch.gather(vals, 1, seg[..., None].expand(B, T, D))
    right_val = torch.gather(vals, 1, (seg + 1)[..., None].expand(B, T, D))
    denom = torch.clamp(right_idx - left_idx, min=1).to(vals.dtype)[..., None]
    w = (t_grid[None, :] - left_idx).to(vals.dtype)[..., None] / denom
    y = left_val + w * (right_val - left_val)
    y = y.scatter(1, idx[..., None].expand(B, K, D), vals)
    if recompute_velocity and D == 4:
        y = recompute_velocity_channels(y, T)
    return y


def recompute_velocity_channels(y: torch.Tensor, T: int) -> torch.Tensor:
    """Finite-difference velocity for [.., T, 4] = [pos(2), vel(2)] layouts."""
    pos = y[..., :2]
    dt = 1.0 / float(T)
    v = torch.cat([(pos[..., 1:, :] - pos[..., :-1, :]) / dt,
                   torch.zeros_like(pos[..., :1, :])], dim=-2)
    return torch.cat([pos, v], dim=-1)
