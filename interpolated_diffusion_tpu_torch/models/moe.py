"""Switch-style mixture-of-experts FFN (port of models/moe.py).

Top-1 routing (Switch Transformer, arXiv 2101.03961) by an f32 router, a
fixed capacity C = max(1, ceil(N / E * capacity_factor)) per expert with
each token's slot taken by a cumulative count in token order and the
overflow dropped (its output is zero: the block's residual passes it
through), tanh-GELU between the two expert products with the JAX module's
round trip through the compute dtype, the combine weighted by the router's
gate, and the load-balancing loss aux = E * sum_e f_e * p_e returned beside
the output (the JAX block sows it; no trainer reads it).

The JAX module dispatches and combines with [N, E, C] one-hot einsums, the
shape GSPMD shards well. Here the dispatch is an index scatter into an
[E, C, D] buffer and the combine an index gather: each output element of
those einsums has exactly one nonzero term, so the f32 results are the same,
and at Wan width (N = 15600 tokens, E = 8, C = 2438) no [N, E, C] tensor
(1.2 GB in f32, per block) is ever made. The expert products are batched
matmuls over the expert axis (JAX's are einsums outside any Pallas kernel).

Expert parallelism (parallel/ep.py): once `shard_experts` ran, this rank
holds the experts [r E/n, (r+1) E/n) of the stacked parameters and its own
tokens; slots are numbered over all ranks' tokens in rank order (the global
token order of the JAX module's data-sharded batch), and the all_to_all pair
of parallel/collectives carries the dispatch buffer to the experts' owners
and their outputs back.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather, all_to_all, axis_index, axis_size, psum


class SwitchFFN(nn.Module):
    """Top-1 routed expert FFN: [..., dim] -> ([..., dim], aux loss).

    Parameters in the JAX layout: router (Linear dim -> E, f32), ffn_in
    [E, dim, ffn], ffn_in_bias [E, ffn], ffn_out [E, ffn, dim] (no output
    bias)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, dim: int, ffn_dim: int, n_experts: int, capacity_factor: float = 1.25):
        super().__init__()
        self.dim, self.ffn_dim, self.n_experts = dim, ffn_dim, n_experts
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(dim, n_experts)
        self.ffn_in = nn.Parameter(torch.empty(n_experts, dim, ffn_dim))
        self.ffn_in_bias = nn.Parameter(torch.empty(n_experts, ffn_dim))
        self.ffn_out = nn.Parameter(torch.empty(n_experts, ffn_dim, dim))
        self.expert_sharded = False  # parallel/ep.shard_experts sets both
        self.expert_group = None     # (None there: the default group)

    def init_seeded(self, uniform_) -> None:
        # flax's variance_scaling(1, fan_in) over a stacked [E, in, out]
        # kernel counts E into the fan-in; a uniform of the same variance
        uniform_(self.ffn_in, math.sqrt(3.0 / (self.n_experts * self.dim)))
        self.ffn_in_bias.zero_()
        uniform_(self.ffn_out, math.sqrt(3.0 / (self.n_experts * self.ffn_dim)))

    def route(self, probs: torch.Tensor) -> torch.Tensor:
        """Each token's expert: the argmax of its router probabilities (a
        discrete choice; a comparison of two numerical paths replays one
        path's routes in the other through this method)."""
        return torch.argmax(probs, dim=-1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        D, E = self.dim, self.n_experts
        group = self.expert_group
        n = axis_size(group) if self.expert_sharded else 1
        x2 = x.reshape(-1, D)
        N_loc = x2.shape[0]
        N = N_loc * n                                       # every rank holds N_loc tokens
        C = max(1, math.ceil(N / E * self.capacity_factor))

        logits = F.linear(x2.float(), self.router.weight.float(), self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)               # [N_loc, E]
        expert = self.route(probs)
        gate = probs.gather(1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, E).float()
        counts = onehot.sum(dim=0)
        pos = (torch.cumsum(onehot, dim=0) - 1.0).gather(1, expert[:, None])[:, 0]
        if n > 1:     # the ranks before this one fill each expert's first slots
            before = all_gather(counts[None].detach(), group, dim=0)[:axis_index(group)]
            pos = pos + before.sum(dim=0).gather(0, expert)
        pos = pos.long()
        keep = pos < C
        e_k, p_k = expert[keep], pos[keep]

        xe = x2.new_zeros((E, C, D), dtype=torch.float32).index_put((e_k, p_k),
                                                                    x2[keep].float())
        if n > 1:     # to the experts' owners: chunk j of E to rank j, summed over senders
            xe = all_to_all(xe, group).view(n, E // n, C, D).sum(dim=0)
        dtype = self.compute_dtype or x.dtype
        h = torch.bmm(xe, self.ffn_in.float()) + self.ffn_in_bias.float()[:, None, :]
        h = F.gelu(h.to(dtype), approximate="tanh").float()
        ye = torch.bmm(h, self.ffn_out.float())             # [E_loc, C, D]
        if n > 1:     # every owner's outputs back to every rank: [E, C, D]
            ye = all_to_all(ye.repeat(n, 1, 1), group)
        y = x2.new_zeros((N_loc, D), dtype=torch.float32).index_put(
            (keep.nonzero()[:, 0],), ye[e_k, p_k] * gate[keep, None])

        # load balancing: E * sum_e (fraction routed to e) (mean router prob of e)
        frac = psum(counts, group) / N if n > 1 else onehot.mean(dim=0)
        mean_p = psum(probs.sum(dim=0), group) / N if n > 1 else probs.mean(dim=0)
        aux = E * torch.sum(frac * mean_p)
        return y.reshape(x.shape).to(x.dtype), aux
