"""Seeded construction of the port's modules without the global RNG.

torch's layer constructors initialise their weights from the global RNG.
`build_model` constructs on the meta device (no values, no RNG), allocates
on the target device, and fills every parameter from an explicit
`torch.Generator` with `init_parameters`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of `module` from a CPU `generator`.

    Linear / Conv2d weights and biases: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (torch's default bound); Embedding: N(0, 1); a module with its own
    parameters defines `init_seeded(uniform_)`. A module with
    `zero_init = True` gets zero weights and bias.
    """
    def uniform_(p: torch.Tensor, bound: float) -> None:
        vals = torch.empty(p.shape, dtype=torch.float32).uniform_(
            -bound, bound, generator=generator)
        p.copy_(vals)

    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "zero_init", False):
                for p in m.parameters(recurse=False):
                    p.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                for p in m.parameters(recurse=False):
                    uniform_(p, 1.0 / math.sqrt(fan_in))
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif hasattr(m, "init_seeded"):
                m.init_seeded(uniform_)
    return module


def build_model(cls, *, generator: torch.Generator,
                device: Optional[torch.device] = None,
                dtype: Optional[torch.dtype] = None, **kwargs) -> nn.Module:
    """cls(**kwargs) with parameters drawn from `generator`, on `device`, in `dtype`."""
    with torch.device("meta"):
        model = cls(**kwargs)
    model = model.to_empty(device=device or "cpu")
    init_parameters(model, generator)
    return model.to(dtype) if dtype is not None else model
