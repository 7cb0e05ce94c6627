"""Pipeline parallelism over a `pipe` process group, GPipe schedule (port
of parallel/pp.py).

Each rank of the group is one stage: its contiguous slice of a layer stack.
The batch is cut into M microbatches that stream through the stages in
M + S - 1 ticks: at tick t stage s works on microbatch t - s, and every
tick ends with one `ppermute` hand-off to the next stage, on every rank,
whether its stage worked that tick or not (a fill or drain tick passes the
activation through untouched). The last stage's outputs reach every rank by
a masked sum. Bubble fraction (S - 1) / (M + S - 1).

Differentiable, so the same function trains: a hop's backward is the
reverse hop. That backward is a collective, so every rank must run the
hops' backward in the same order. Here each rank's ticks form one chain
(tick t's input is tick t-1's hop, selected with `torch.where` on stage 0,
which still carries the hop in the graph), and every rank's outputs take
its last M ticks (masked to zero off the last stage), so the chain on every
rank reaches the loss and autograd walks it tick by tick, last first, on
all ranks alike. The inputs (activations and the batched context) enter
through `copy_to` and the outputs leave through `reduce_from`
(parallel/collectives.py): every rank then computes the same whole loss,
and the replicated parameters before and after the pipeline get the whole
gradient on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from .collectives import Group, axis_index, axis_size, copy_to, ppermute, reduce_from, ring_perm

# stage_fn(x_microbatch, ctx_microbatch) -> x_microbatch: this rank's layers
StageFn = Callable[[torch.Tensor, Any], torch.Tensor]


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def pipeline_blocks(stage_fn: StageFn, x: torch.Tensor, ctx: Any, group: Group,
                    n_microbatches: int) -> torch.Tensor:
    """Apply the whole stage stack to x [B, ...] pipelined over `group`:
    this rank runs `stage_fn`, its own stage. ctx: a tree of tensors handed
    to every stage; leaves whose leading dimension is B are microbatched
    with x, the rest (tables) passed whole. B must divide by n_microbatches.
    Returns [B, ...] on every rank, the sequential stack's result."""
    S, s, M = axis_size(group), axis_index(group), n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_microbatches={M}")
    enter = lambda t: copy_to(t, group) if t.requires_grad else t
    x = enter(x)
    ctx = _map(ctx, lambda t: enter(t) if isinstance(t, torch.Tensor) else t)
    batched = lambda t: isinstance(t, torch.Tensor) and t.dim() > 0 and t.shape[0] == B
    x_mb = x.chunk(M, dim=0)
    ctx_mb = [_map(ctx, lambda t, i=i: t.chunk(M, dim=0)[i] if batched(t) else t)
              for i in range(M)]
    first, last = torch.tensor(s == 0), torch.tensor(s == S - 1)
    perm = ring_perm(S, shift=1)                 # stage i -> i + 1
    recv = torch.zeros_like(x_mb[0])
    outs: List[torch.Tensor] = []
    for t in range(M + S - 1):
        mb = t - s
        cur = torch.where(first.to(x.device), x_mb[min(max(mb, 0), M - 1)], recv)
        if 0 <= mb < M:
            cur = stage_fn(cur, ctx_mb[mb])
        if t >= S - 1:                           # the last stage's output of microbatch t - S + 1
            outs.append(torch.where(last.to(x.device), cur, torch.zeros_like(cur)))
        recv = ppermute(cur, group, perm)
    return reduce_from(torch.cat(outs, dim=0), group)
