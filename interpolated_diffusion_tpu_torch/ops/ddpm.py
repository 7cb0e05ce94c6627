"""DDPM forward noising, DDIM core math and the reverse-scan solver family
(port of ops/ddpm.py: q_sample, DDIM with FORA block caching, PFDiff,
DPM-Solver++(2M) and run_solver).

The JAX reverse scans (`jax.lax.scan`) are Python loops here.
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


EpsFn = Callable[..., torch.Tensor]
Post = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _full(B: int, t, device) -> torch.Tensor:
    return torch.full((B,), int(t), dtype=torch.long, device=device)


def _stacked(ys):
    return torch.stack(ys, dim=0) if ys else None


def ddim_scan(eps_fn: EpsFn, z: torch.Tensor, times, schedule: DiffusionSchedule,
              post: Post = None, cache_interval: int = 1,
              delta0: Optional[torch.Tensor] = None, collect: bool = False,
              x0_clip: Optional[float] = None):
    """DDIM reverse loop over consecutive pairs of `times` (descending), with
    optional FORA-style block caching.

    eps_fn(z, t_b, *, blocks_delta=None, return_delta=False) -> eps; post(z)
    runs after every step (known-value clamping, position clipping). With
    cache_interval > 1 the model's block stack runs only at every
    interval-th step (return_delta=True gives its residual) and the residual
    is reused in between (blocks_delta=...); `delta0` is the residual's shape
    and is required, as in the JAX package, though a first full step always
    replaces it. Returns z, or (z, stacked per-step states [S, ...]) with
    collect=True.
    """
    B = z.shape[0]
    times = [int(t) for t in np.asarray(times)]
    interval = max(1, int(cache_interval))
    if interval > 1 and delta0 is None:
        raise ValueError("cache_interval > 1 needs delta0 (residual shape)")
    delta, ys = delta0, []
    for i, (t_now, t_prev) in enumerate(zip(times[:-1], times[1:])):
        t_b = _full(B, t_now, z.device)
        if interval == 1:
            eps = eps_fn(z, t_b)
        elif i % interval == 0:
            eps, delta = eps_fn(z, t_b, return_delta=True)
        else:
            eps = eps_fn(z, t_b, blocks_delta=delta)
        z = ddim_step(z, eps, t_b, _full(B, t_prev, z.device), schedule, x0_clip=x0_clip)
        if post is not None:
            z = post(z)
        if collect:
            ys.append(z)
    return (z, _stacked(ys)) if collect else z


def pfdiff_scan(eps_fn: EpsFn, z: torch.Tensor, times, schedule: DiffusionSchedule,
                post: Post = None, collect: bool = False, x0_clip: Optional[float] = None):
    """PFDiff-style DDIM scan: ~half the model evaluations for the same grid.

    A warm-up DDIM step over the first interval; then per pair of intervals
    (t_i, t_mid, t_next) a "springboard" hop t_i -> t_mid with the PAST eps,
    one fresh evaluation at that state, and a double-length jump t_i ->
    t_next from the original state with it; an odd tail takes a plain step.
    NFE = 1 + ceil((S - 1) / 2) for S intervals. For an eps that does not
    change between grid points this is plain DDIM on the same grid. collect
    stacks one state per springboard group (plus the odd tail), None when
    there is no group. Not composable with FORA block caching.
    """
    B = z.shape[0]
    post = post or (lambda x: x)
    times = [int(t) for t in np.asarray(times)]
    n_int = len(times) - 1
    if n_int < 2:
        return ddim_scan(eps_fn, z, times, schedule, post=post, collect=collect,
                         x0_clip=x0_clip)
    tb = lambda t: _full(B, t, z.device)
    step = lambda z, eps, t, tn: post(ddim_step(z, eps, tb(t), tb(tn), schedule,
                                                x0_clip=x0_clip))
    eps_past = eps_fn(z, tb(times[0]))
    z = step(z, eps_past, times[0], times[1])
    rem = n_int - 1
    ys = []
    for g in range(rem // 2):
        t_i, t_mid, t_next = times[1 + 2 * g: 4 + 2 * g]
        # post() on the springboard state too: the denoiser sees the same
        # invariant as before every other evaluation
        z_mid = step(z, eps_past, t_i, t_mid)
        eps_past = eps_fn(z_mid, tb(t_mid))
        z = step(z, eps_past, t_i, t_next)
        ys.append(z)
    if rem % 2 == 1:
        z = step(z, eps_fn(z, tb(times[-2])), times[-2], times[-1])
        if ys:
            ys.append(z)
    return (z, _stacked(ys)) if collect else z


def dpm_solver_pp_scan(eps_fn: EpsFn, z: torch.Tensor, times, schedule: DiffusionSchedule,
                       post: Post = None, collect: bool = False,
                       x0_clip: Optional[float] = None):
    """DPM-Solver++(2M): second-order multistep ODE solver, one evaluation a
    step (Lu et al., arXiv 2211.01095 sec. 4). With lambda = log(alpha /
    sigma), h_i = lambda_i - lambda_{i-1}, r_i = h_{i-1} / h_i and m the x0
    prediction:

        x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i (e^{-h_i} - 1)
              [(1 + 1 / (2 r_i)) m_{i-1} - 1 / (2 r_i) m_{i-2}]

    The first transition is first order (DDIM when x0 does not move). The
    tables are alpha_bar at `times` in f32 with the 1e-8 floor on alpha, as in
    the JAX package. collect stacks the states after the first transition
    (that one alone when the grid has one interval).
    """
    B = z.shape[0]
    post = post or (lambda x: x)
    times = [int(t) for t in np.asarray(times)]
    n_t = len(times)
    if n_t < 2:
        return (z, None) if collect else z
    ab = schedule.alpha_bar[torch.tensor(times, device=schedule.alpha_bar.device)]
    alpha, sigma = torch.sqrt(ab), torch.sqrt(1.0 - ab)
    lam = torch.log(alpha) - torch.log(sigma)
    tb = lambda i: _full(B, times[i], z.device)

    def x0_of(z, i):
        m = (z - sigma[i] * eps_fn(z, tb(i))) / torch.clamp(alpha[i], min=1e-8)
        if x0_clip is not None and x0_clip > 0:
            m = torch.clamp(m, -float(x0_clip), float(x0_clip))
        return m

    m_prev = x0_of(z, 0)
    h_prev = lam[1] - lam[0]
    z = post((sigma[1] / sigma[0]) * z - alpha[1] * (torch.exp(-h_prev) - 1.0) * m_prev)
    if n_t == 2:
        return (z, z[None]) if collect else z
    ys = []
    for i in range(1, n_t - 1):
        h = lam[i + 1] - lam[i]
        m = x0_of(z, i)
        r = h_prev / h
        D = (1.0 + 1.0 / (2.0 * r)) * m - (1.0 / (2.0 * r)) * m_prev
        z = post((sigma[i + 1] / sigma[i]) * z - alpha[i + 1] * (torch.exp(-h) - 1.0) * D)
        m_prev, h_prev = m, h
        ys.append(z)
    return (z, _stacked(ys)) if collect else z


SOLVERS = ("ddim", "pfdiff", "dpm")


def run_solver(solver: str, eps_fn: EpsFn, z: torch.Tensor, times,
               schedule: DiffusionSchedule, post: Post = None, collect: bool = False,
               cache_interval: int = 1, delta0: Optional[torch.Tensor] = None,
               x0_clip: Optional[float] = None):
    """One dispatch point for the reverse-scan solver family.

    ddim    exact baseline; composes with FORA block caching
            (cache_interval > 1 + delta0).
    pfdiff  past-score springboard: NFE 1 + ceil((S - 1) / 2) on the same grid.
    dpm     DPM-Solver++(2M): one evaluation a step, second order.

    pfdiff and dpm replace the evaluation structure themselves, so they refuse
    FORA caching. Returns z, or (z, per-step states or None) with collect=True.
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; pick from {SOLVERS}")
    if solver != "ddim":
        if cache_interval > 1:
            raise ValueError(f"solver {solver!r} and cache_interval > 1 both substitute "
                             "model evals — pick one")
        fn = pfdiff_scan if solver == "pfdiff" else dpm_solver_pp_scan
        return fn(eps_fn, z, times, schedule, post=post, collect=collect, x0_clip=x0_clip)
    return ddim_scan(eps_fn, z, times, schedule, post=post, cache_interval=cache_interval,
                     delta0=delta0, collect=collect, x0_clip=x0_clip)
