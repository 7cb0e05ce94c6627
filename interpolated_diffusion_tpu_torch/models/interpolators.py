"""Learned latent interpolators, the temporal-conv and lerp-residual families
(port of models/interpolators.py).

`TinyTemporalInterpolator` is a depthwise temporal convolution stack over
[B, T, D]: flax's `nn.Conv(features=D, kernel_size=(k,), padding="SAME",
feature_group_count=D)` with kernel [k, 1, D] is `nn.Conv1d(D, D, k,
groups=D, padding=k // 2)` with weight [D, 1, k] (both cross-correlate).
Its state-dict names are the original reference's (`net.0`, `net.2`, ...:
conv, SiLU, conv, SiLU).

`LatentLerpResidualInterpolator` is an endpoint-locked residual on the lerp,
z(alpha) = lerp + alpha (1 - alpha) res([z_a, z_b, lerp, alpha]), with a
zero-initialised residual head and a per-position log-sigma head; it keeps
the flax names (fc_0 .., res_out, unc_out).

Parameters and compute dtype are separate (`models/transformer.
set_compute_dtype`), as in the other modules of the port.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import Linear


class DepthwiseConv1d(nn.Conv1d):
    """Depthwise temporal conv over [B, D, T] ("SAME" zero padding, odd k)
    that casts its input and parameters to `compute_dtype`."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, channels: int, kernel_size: int):
        super().__init__(channels, channels, kernel_size, padding=kernel_size // 2,
                         groups=channels)

    def init_seeded(self, uniform_) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        uniform_(self.weight, bound)
        uniform_(self.bias, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class TinyTemporalInterpolator(nn.Module):
    """Per-channel (depthwise) temporal conv stack over [B, T, D]; each conv
    is followed by SiLU. The output has the input's dtype."""

    def __init__(self, data_dim: int, kernel_size: int = 3, n_layers: int = 2):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd for symmetric padding")
        layers = []
        for _ in range(n_layers):
            layers += [DepthwiseConv1d(data_dim, kernel_size), nn.SiLU()]
        self.net = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.net(z.transpose(1, 2)).transpose(1, 2).to(z.dtype)


class LatentLerpResidualInterpolator(nn.Module):
    """ẑ(alpha) = lerp(z_a, z_b, alpha) + alpha (1 - alpha) res(...), plus a
    log-sigma head (zeros without `with_uncertainty`). The alpha (1 - alpha)
    gate makes the endpoints exact by construction."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, data_dim: int, hidden_dim: int = 256, n_layers: int = 3,
                 with_uncertainty: bool = True):
        super().__init__()
        self.n_hidden, self.with_uncertainty = n_layers - 1, with_uncertainty
        width = 3 * data_dim + 1
        for i in range(self.n_hidden):
            setattr(self, f"fc_{i}", Linear(width, hidden_dim))
            width = hidden_dim
        self.res_out = Linear(width, data_dim)
        self.res_out.zero_init = True
        nn.init.zeros_(self.res_out.weight)
        nn.init.zeros_(self.res_out.bias)
        if with_uncertainty:
            self.unc_out = Linear(width, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.res_out.weight.dtype

    def forward(self, z_a: torch.Tensor, z_b: torch.Tensor, alpha: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z_a / z_b [..., D]; alpha [..., 1] or [...]. Returns (ẑ in z_a's
        dtype, log_sigma [..., 1] f32)."""
        dt = self.dtype
        if alpha.ndim < z_a.ndim:
            alpha = alpha[..., None]
        alpha = alpha.to(dt)
        lerp = (1.0 - alpha) * z_a + alpha * z_b
        h = torch.cat([z_a.to(dt), z_b.to(dt), lerp, alpha], dim=-1)
        for i in range(self.n_hidden):
            h = F.silu(getattr(self, f"fc_{i}")(h))
        z_hat = lerp + alpha * (1.0 - alpha) * self.res_out(h)
        if self.with_uncertainty:
            log_sigma = self.unc_out(h)
        else:
            log_sigma = torch.zeros_like(z_hat[..., :1])
        return z_hat.to(z_a.dtype), log_sigma.float()
