"""Rectified flow: straight-path velocity matching, training and sampler
(port of ops/rectified_flow.py).

  x_t = (1 - t) x0 + t eps,  target velocity v = eps - x0,
  loss = |v_theta(x_t, t) - v|^2,
  sampling = Euler (or midpoint) integration from eps at t = 1 down to t = 0.

The KeypointDenoiser's eps head doubles as the velocity head; callers scale
the continuous t onto its integer timestep embedding. The JAX scan is a
Python loop here, and its time grid is computed on the host in f32 exactly
as the compiled `jnp.linspace(1, 0, steps + 1)` computes it (1 - i * (1 /
steps): XLA turns the division by the constant into a product with its
reciprocal; the last point is 0), so that the truncated integer timesteps a
caller derives from it match the JAX sampler's: one ulp below an integer
truncates to the integer below.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Post = Optional[Callable[[torch.Tensor], torch.Tensor]]


def rf_interpolate(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear path point and its target velocity; t in [0, 1], shape [B]."""
    tt = t.reshape(t.shape + (1,) * (x0.ndim - 1))
    return (1.0 - tt) * x0 + tt * noise, noise - x0


def rf_loss(v_pred: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Velocity-matching MSE. mask may be per position ([B, T] / [B, T, 1]) or
    full-shape; the masked mean is over the selected elements."""
    se = (v_pred - (noise - x0)) ** 2
    if mask is None:
        return se.mean()
    mask = mask.to(se.dtype)
    while mask.ndim < se.ndim:
        mask = mask[..., None]
    mask = mask.expand(se.shape)
    return (se * mask).sum() / (mask.sum() + 1e-8)


def rf_time_grid(steps: int) -> np.ndarray:
    """The compiled jnp.linspace(1.0, 0.0, steps + 1) in f32, value for value."""
    i = np.arange(steps, dtype=np.float32)
    head = np.float32(1.0) - i * (np.float32(1.0) / np.float32(steps))
    return np.concatenate([head, np.zeros(1, np.float32)]).astype(np.float32)


def rf_integrate(velocity_fn: VelocityFn, x: torch.Tensor, steps: int,
                 method: str = "euler", post: Post = None) -> torch.Tensor:
    """Integrate dx/dt = v_theta(x, t) from the given state at t = 1 down to
    t = 0. velocity_fn(x, t [B] f32) -> v; `post` runs after every committed
    state (and after the midpoint's half step), as ddim_scan's does."""
    B = x.shape[0]
    post = post or (lambda z: z)
    ts = rf_time_grid(steps)
    full = lambda t: torch.full((B,), float(t), dtype=torch.float32, device=x.device)
    for i in range(steps):
        t_now = ts[i]
        dt = np.float32(ts[i + 1] - t_now)              # negative
        v = velocity_fn(x, full(t_now))
        if method == "midpoint":
            x_mid = post(x + float(np.float32(0.5) * dt) * v)
            v = velocity_fn(x_mid, full(np.float32(t_now + np.float32(0.5) * dt)))
        x = post(x + float(dt) * v)
    return x


def _integrate(velocity_fn: VelocityFn, x: torch.Tensor, steps: int, method: str,
               keep_mask: Optional[torch.Tensor]) -> torch.Tensor:
    post = None
    if keep_mask is not None:
        post = lambda z: z * (~keep_mask)[..., None]
    return rf_integrate(velocity_fn, x, steps, method, post)


def _normal(shape, noise: Optional[torch.Tensor], generator: Optional[torch.Generator]):
    if noise is not None:
        return noise.float()
    if generator is None:
        raise ValueError("pass the noise draw or a generator")
    return torch.randn(shape, generator=generator, device=generator.device)


def rf_sample(velocity_fn: VelocityFn, shape, steps: int = 20, method: str = "euler",
              keep_mask: Optional[torch.Tensor] = None, *, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Integrate from t = 1 (the normal draw `noise` [shape], else drawn from
    `generator`) to t = 0; keep_mask [B, T] zeroes its frames every step."""
    x = _normal(shape, noise, generator)
    if keep_mask is not None:
        x = x * (~keep_mask)[..., None]
    return _integrate(velocity_fn, x, steps, method, keep_mask)


def reflow_pair(velocity_fn: VelocityFn, shape, steps: int = 20, *,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noise, generated) coupling for ReFlow distillation rounds."""
    noise = _normal(shape, noise, generator)
    return noise, _integrate(velocity_fn, noise, steps, "euler", None)
