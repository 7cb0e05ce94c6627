"""Expert parallelism for the Switch-MoE FFN (port of parallel/ep.py).

The JAX package shards the leading expert axis of SwitchFFN's stacked
parameters over an `expert` mesh axis and lets GSPMD insert the all-to-all
pair. Here every rank loads the full parameters (as the TP / EP / PP ranks
of the port all do: the same JAX parameters then give the same function on
1 and on N ranks) and `shard_experts` keeps its own slice of the expert
axis; models/moe.SwitchFFN then runs the all_to_all pair around the expert
products. The ranks of the expert group each bring their own tokens (the
expert group doubles as a data group, as in JAX's (data, expert) mesh);
every other parameter stays replicated.
"""
from __future__ import annotations

from torch import nn

from ..models.moe import SwitchFFN
from .collectives import Group, axis_index, axis_size

# SwitchFFN's stacked expert leaves; dim 0 is the expert axis
EXPERT_LEAVES = ("ffn_in", "ffn_in_bias", "ffn_out")


def shard_experts(model: nn.Module, group: Group) -> nn.Module:
    """Keep this rank's E / n experts of every SwitchFFN under `model` (in
    place) and route their tokens over `group`. E must divide by n."""
    n, r = axis_size(group), axis_index(group)
    for m in model.modules():
        if not isinstance(m, SwitchFFN):
            continue
        E = m.n_experts
        if E % n:
            raise ValueError(f"{E} experts do not split over an expert group of {n} ranks")
        lo, hi = r * E // n, (r + 1) * E // n
        for name in EXPERT_LEAVES:
            p = getattr(m, name)
            setattr(m, name, nn.Parameter(p.detach()[lo:hi].clone(),
                                          requires_grad=p.requires_grad))
        m.expert_sharded, m.expert_group = True, group
    return model
