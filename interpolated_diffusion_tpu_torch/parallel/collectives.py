"""Differentiable collectives over a process group: the port's counterparts
of jax.lax.ppermute / psum / pmean / all_gather and of the all-to-all that
GSPMD inserts for expert parallelism.

JAX's `axis_name` becomes an explicit `torch.distributed` process group
(None: the default group). Every function here follows JAX's transpose
rules, so ring attention, ring-SLA's linear branch and the expert-parallel
FFN build on them without writing backward communication of their own:

  ppermute    backward is the inverse permutation
  psum        backward is psum (every rank holds the same replicated result)
  all_gather  backward is a reduce-scatter: psum, then this rank's slice
  all_to_all  (equal splits of dim 0) backward is the same all-to-all

psum's backward fits a sum whose result feeds every member's own part of
the computation (the members' losses add up: ring-SLA's linear branch, a
norm over features split across members). Tensor and pipeline parallelism
end in a loss every member computes whole; for them the Megatron pair is
the rule: `copy_to` (identity forward, psum backward) where a replicated
tensor enters the split computation, `reduce_from` (psum forward, identity
backward) where the members' partial results leave it.

A group of one member, or a run with no process group, makes each of them
the identity (ppermute of a pair that maps a rank to itself, included).

Transport: NCCL moves CUDA tensors directly. Gloo has no point-to-point send
of CUDA tensors, so under a gloo group a CUDA tensor is copied to host
memory, moved, and copied back: the transport of that backend, chosen by the
group's backend (two ranks that share one GPU cannot use NCCL). It is not a
fallback: nothing here changes backend because something failed.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def axis_size(group: Group = None) -> int:
    """Members of `group` (1 without a process group)."""
    return dist.get_world_size(group) if _active() else 1


def axis_index(group: Group = None) -> int:
    """This process's position in `group` (0 without a process group)."""
    return dist.get_rank(group) if _active() else 0


def _global_rank(group: Group, i: int) -> int:
    return i if group is None else dist.get_global_rank(group, i)


def _via_host(x: torch.Tensor, group: Group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _stage(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The buffer the backend moves: contiguous, on the host under gloo."""
    x = x.detach().contiguous()
    return x.cpu() if _via_host(x, group) else x


def _ppermute(x: torch.Tensor, group: Group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    me = axis_index(group)
    buf = _stage(x, group)
    out = torch.zeros_like(buf)       # a rank that receives nothing gets zeros, as in JAX
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(buf)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, buf, _global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _ppermute(g, ctx.group, inverse), None, None


def ppermute(x: torch.Tensor, group: Group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send x from rank src to rank dst for each (src, dst) of `perm` (ranks
    of `group`); a rank no pair sends to receives zeros."""
    if axis_size(group) == 1:
        return x
    return _PPermute.apply(x, group, [tuple(p) for p in perm])


def ring_perm(n: int, shift: int = -1) -> List[Tuple[int, int]]:
    """The ring hop i -> (i + shift) % n."""
    return [(i, (i + shift) % n) for i in range(n)]


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    buf = _stage(x, group).clone()
    dist.all_reduce(buf, dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Sum of x over the members of `group`, on every member."""
    if axis_size(group) == 1:
        return x
    return _PSum.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """x as it is; its gradient summed over the members (a replicated input
    of a computation the members split)."""
    if axis_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The members' partial results summed; the gradient passes as it is
    (every member's loss is the same whole)."""
    if axis_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def pmean(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    return psum(x, group) / axis_size(group)


def _all_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    buf = _stage(x, group)
    parts = [torch.empty_like(buf) for _ in range(axis_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, axis_index(ctx.group) * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, group: Group = None, dim: int = 0) -> torch.Tensor:
    """The members' x concatenated along `dim` in rank order (JAX's tiled
    all_gather)."""
    if axis_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.dim())


def _all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    buf = _stage(x, group)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Dim 0 cut into one equal chunk per member: chunk j goes to member j,
    which stores what member i sent it as its chunk i."""
    if axis_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)
