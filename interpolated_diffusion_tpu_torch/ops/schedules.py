"""Diffusion beta schedules and alpha-bar tables (port of ops/schedules.py).

Tables are float32, computed as the JAX package computes them, so a schedule
made here matches the JAX one to f32 rounding.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class DiffusionSchedule(NamedTuple):
    """Precomputed per-timestep tables, each of shape [n_timesteps]."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bar: torch.Tensor
    sqrt_alpha_bar: torch.Tensor
    sqrt_one_minus_alpha_bar: torch.Tensor

    @property
    def n_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(t.to(device) for t in self))


def linear_beta_schedule(n_timesteps: int, beta_start: float = 1e-4,
                         beta_end: float = 2e-2) -> torch.Tensor:
    return torch.linspace(beta_start, beta_end, n_timesteps, dtype=torch.float32)


def cosine_beta_schedule(n_timesteps: int, s: float = 0.008) -> torch.Tensor:
    steps = n_timesteps + 1
    x = torch.linspace(0.0, n_timesteps, steps, dtype=torch.float32)
    alphas_cumprod = torch.cos(((x / n_timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return torch.clamp(betas, 1e-8, 0.999)


def make_beta_schedule(name: str, n_timesteps: int) -> torch.Tensor:
    if name == "linear":
        return linear_beta_schedule(n_timesteps)
    if name == "cosine":
        return cosine_beta_schedule(n_timesteps)
    raise ValueError(f"Unknown schedule {name}")


def make_alpha_bars(betas: torch.Tensor) -> DiffusionSchedule:
    alphas = 1.0 - betas
    alpha_bar = torch.cumprod(alphas, dim=0)
    return DiffusionSchedule(
        betas=betas,
        alphas=alphas,
        alpha_bar=alpha_bar,
        sqrt_alpha_bar=torch.sqrt(alpha_bar),
        sqrt_one_minus_alpha_bar=torch.sqrt(1.0 - alpha_bar),
    )


def make_schedule(name: str, n_timesteps: int,
                  device: Optional[torch.device] = None) -> DiffusionSchedule:
    """Betas + alpha-bar tables in one call, placed on `device`."""
    sched = make_alpha_bars(make_beta_schedule(name, n_timesteps))
    return sched if device is None else sched.to(device)
