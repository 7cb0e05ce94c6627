"""Seeded weights made by the benchmark, on the device, in a few large draws.

A spec lists every leaf (name, shape, mean, std, dtype). One normal draw per
dtype, of all that dtype's leaves at once, from a torch.Generator on the
device, is cut into the leaves and scaled in place. The same seed on the same
device gives the same values, so the program and the plain reference are
handed identical weights, the reference after the program's state is freed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    std: float
    mean: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


def make_weights(spec: Sequence[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    dtypes: List[torch.dtype] = []
    for leaf in spec:
        if leaf.dtype not in dtypes:
            dtypes.append(leaf.dtype)
    for dtype in dtypes:
        leaves = [leaf for leaf in spec if leaf.dtype == dtype]
        flat = torch.randn(sum(leaf.numel for leaf in leaves), generator=gen, device=device,
                           dtype=dtype)
        off = 0
        for leaf in leaves:
            view = flat[off:off + leaf.numel].view(leaf.shape)
            off += leaf.numel
            view.mul_(leaf.std).add_(leaf.mean)
            out[leaf.name] = view
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor], prefix: str = "") -> int:
    """Copy the benchmark's weights into a module's parameters, which must
    match them name for name and shape for shape. Returns the leaves set."""
    params = dict(module.named_parameters())
    names = {prefix + n for n in params}
    mine = {n for n in weights if n.startswith(prefix)}
    if names != mine:
        missing, extra = sorted(names - mine)[:5], sorted(mine - names)[:5]
        raise ValueError(f"weights do not match the module: missing {missing}, extra {extra}")
    with torch.no_grad():
        for n, p in params.items():
            w = weights[prefix + n]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{n}: module {tuple(p.shape)} vs weights {tuple(w.shape)}")
            p.copy_(w)
    return len(params)
