"""Seeded construction of the port's modules without the global RNG.

torch's layer constructors initialise their weights from the global RNG.
`build_model` constructs on the meta device (no values, no RNG), allocates
on the target device, and fills every parameter from an explicit
`torch.Generator` with `init_parameters` (a CUDA generator draws on the card,
which is how a full-width Wan2.1-1.3B model is made in seconds).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def init_parameters(module: nn.Module, generator: torch.Generator,
                    zero_init_scale: float = 0.0) -> nn.Module:
    """Fill every parameter of `module` from `generator` (drawn on its device).

    Linear / Conv2d / Conv3d weights and biases: U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (torch's default bound); Embedding: N(0, 1); a module
    with its own parameters defines `init_seeded(uniform_)`. A module with
    `zero_init = True`, and a module's parameters named in its
    `zero_init_params`, get zeros, or U(-zero_init_scale, zero_init_scale)
    when that is > 0 (a smoke run that must see those leaves act).
    """
    def uniform_(p: torch.Tensor, bound: float) -> None:
        vals = torch.empty(p.shape, dtype=torch.float32, device=generator.device).uniform_(
            -bound, bound, generator=generator)
        p.copy_(vals)

    def zero_(p: torch.Tensor) -> None:
        if zero_init_scale > 0:
            uniform_(p, zero_init_scale)
        else:
            p.zero_()

    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "zero_init", False):
                for p in m.parameters(recurse=False):
                    zero_(p)
            elif hasattr(m, "init_seeded"):
                m.init_seeded(uniform_)
            elif isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                for p in m.parameters(recurse=False):
                    uniform_(p, 1.0 / math.sqrt(fan_in))
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                           device=generator.device))
            for name in getattr(m, "zero_init_params", ()):
                if getattr(m, name, None) is not None:
                    zero_(getattr(m, name))
    return module


def build_model(cls, *, generator: torch.Generator,
                device: Optional[torch.device] = None,
                dtype: Optional[torch.dtype] = None, zero_init_scale: float = 0.0,
                **kwargs) -> nn.Module:
    """cls(**kwargs) with parameters drawn from `generator`, on `device`, in `dtype`."""
    with torch.device("meta"):
        model = cls(**kwargs)
    model = model.to_empty(device=device or "cpu")
    init_parameters(model, generator, zero_init_scale)
    return model.to(dtype) if dtype is not None else model
