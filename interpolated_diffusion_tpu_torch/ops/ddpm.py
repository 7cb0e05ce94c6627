"""DDPM forward noising and DDIM core math (port of ops/ddpm.py: q_sample and
the sampling subset).

The JAX reverse scan (`jax.lax.scan`) is a Python loop here. Only the
deterministic DDIM solver without block caching is ported; the other solvers
raise NotImplementedError in `run_solver`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .schedules import DiffusionSchedule


def _gather(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients, right-padded for broadcasting.

    t may be [B] (per-sample timestep) or [B, T] (per-token timestep).
    """
    out = table[t.long()]
    while out.ndim < ndim:
        out = out[..., None]
    return out


def q_sample(x0: torch.Tensor, t: torch.Tensor, schedule: DiffusionSchedule,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward noising: x_t = sqrt(a_bar_t) x0 + sqrt(1 - a_bar_t) eps.
    Returns (x_t, eps); eps is `noise` when given, else drawn from `generator`."""
    if noise is None:
        if generator is None:
            raise ValueError("q_sample needs either explicit noise or a generator")
        noise = torch.randn(x0.shape, generator=generator, device=generator.device).to(x0)
    sab = _gather(schedule.sqrt_alpha_bar, t, x0.ndim)
    somab = _gather(schedule.sqrt_one_minus_alpha_bar, t, x0.ndim)
    return sab * x0 + somab * noise, noise


def predict_x0_from_eps(xt: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
                        schedule: DiffusionSchedule) -> torch.Tensor:
    sab = _gather(schedule.sqrt_alpha_bar, t, xt.ndim)
    somab = _gather(schedule.sqrt_one_minus_alpha_bar, t, xt.ndim)
    return (xt - somab * eps) / torch.clamp(sab, min=1e-8)


def ddim_step(xt: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor, schedule: DiffusionSchedule,
              x0_clip: Optional[float] = None) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM update from t to t_prev.

    x0_clip bounds the intermediate x0 estimate to ±x0_clip (see the JAX
    ddim_step for why the cosine-1000 terminal step needs it).
    """
    ab_t = _gather(schedule.alpha_bar, t, xt.ndim)
    ab_prev = _gather(schedule.alpha_bar, t_prev, xt.ndim)
    x0 = (xt - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
    if x0_clip is not None and x0_clip > 0:
        x0 = torch.clamp(x0, -float(x0_clip), float(x0_clip))
    return torch.sqrt(ab_prev) * x0 + torch.sqrt(1.0 - ab_prev) * eps


def make_timesteps(n_train: int, steps: int, schedule: str = "linear") -> np.ndarray:
    """Descending timestep subsequence (host-side, static).

    Matches the reference's linear / quadratic / sqrt spacings including the
    dedup + forced-{0, n_train-1} endpoints, returned high-to-low.
    """
    if steps <= 1:
        return np.array([n_train - 1, 0], dtype=np.int32)
    if steps >= n_train:
        return np.arange(n_train - 1, -1, -1, dtype=np.int32)
    if schedule == "quadratic":
        t = np.linspace(0.0, 1.0, steps)
        times = (t * t * (n_train - 1)).astype(np.int64)
    elif schedule == "sqrt":
        t = np.linspace(0.0, 1.0, steps)
        times = (np.sqrt(t) * (n_train - 1)).astype(np.int64)
    else:
        times = np.linspace(0, n_train - 1, steps).astype(np.int64)
    times = np.unique(times)
    if times[0] != 0:
        times = np.concatenate([[0], times])
    if times[-1] != n_train - 1:
        times = np.concatenate([times, [n_train - 1]])
    return times[::-1].astype(np.int32).copy()


EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_scan(eps_fn: EpsFn, z: torch.Tensor, times, schedule: DiffusionSchedule,
              post: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              x0_clip: Optional[float] = None) -> torch.Tensor:
    """DDIM reverse loop over consecutive pairs of `times` (descending).

    eps_fn(z, t_b) -> eps; post(z) runs after every step (known-value
    clamping, position clipping). One model evaluation per pair.
    """
    B = z.shape[0]
    times = [int(t) for t in np.asarray(times)]
    for t_now, t_prev in zip(times[:-1], times[1:]):
        t_b = torch.full((B,), t_now, dtype=torch.long, device=z.device)
        tp_b = torch.full((B,), t_prev, dtype=torch.long, device=z.device)
        z = ddim_step(z, eps_fn(z, t_b), t_b, tp_b, schedule, x0_clip=x0_clip)
        if post is not None:
            z = post(z)
    return z


SOLVERS = ("ddim", "pfdiff", "dpm")


def run_solver(solver: str, eps_fn: EpsFn, z: torch.Tensor, times,
               schedule: DiffusionSchedule, post=None, cache_interval: int = 1,
               x0_clip: Optional[float] = None) -> torch.Tensor:
    """Dispatch point for the reverse-scan solver family (ddim only so far)."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; pick from {SOLVERS}")
    if solver != "ddim":
        raise NotImplementedError(f"stage1_solver={solver!r} is not ported yet")
    if cache_interval > 1:
        raise NotImplementedError("stage1_cache_interval > 1 is not ported yet")
    return ddim_scan(eps_fn, z, times, schedule, post=post, x0_clip=x0_clip)
