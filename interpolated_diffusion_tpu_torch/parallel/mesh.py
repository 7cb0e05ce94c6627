"""Process mesh and batch-sharding rules (port of parallel/mesh.py).

The JAX package lays its devices out as a (data, model) `Mesh` and lets
GSPMD split the batch. The port runs one process per GPU (torchrun), so the
mesh is a layout of ranks: rank = data_index * n_model + model_index (model
fastest-varying, as JAX puts ICI-adjacent devices on `model`), with one
process group per row and per column. `shard_batch` / `shard_superbatch`
keep this rank's rows; `replicate` broadcasts from the data group's first
rank.

Data parallelism in a train step (train/state.py) runs the loss on the
rank's rows inside `data_parallel_step`, which makes two things global:

  * random draws: a draw from the step's generator whose leading dimension
    is the local batch is drawn at the global batch and sliced to this
    rank's rows, so every rank consumes the generator exactly as one process
    would at the global batch and N ranks reproduce one (`GlobalDraws`);
  * batch reductions the loss cannot split into per-rank means: `dp_sum`
    and `dp_mean` are differentiable sums over the data group (psum, whose
    backward is psum), so a ratio of masked sums or a batch statistic comes
    out as the global-batch value on every rank.

The step then averages the gradients over the data group before the
global-norm clip, as the JAX step clips the global batch's gradient.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from . import multihost
from .collectives import Group, psum


class Mesh:
    """A (data, model) layout of the ranks; `data_group` / `model_group` are
    this rank's row and column (None: the default group or no group)."""

    def __init__(self, n_data: int, n_model: int, data_group: Group, model_group: Group):
        self.n_data, self.n_model = n_data, n_model
        self.data_group, self.model_group = data_group, model_group
        rank = multihost.process_index()
        self.data_index, self.model_index = divmod(rank, n_model)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    def __repr__(self) -> str:
        return f"Mesh(data={self.n_data}, model={self.n_model})"


_MESHES: Dict[Tuple[int, int], Mesh] = {}


def _launch_hint(n: int) -> str:
    return f"launch one process per shard: torchrun --nproc_per_node {n} -m <module> ..."


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over every process of the run (one per GPU).

    n_data defaults to world // n_model. The port has one process per
    device, so the mesh must cover the world exactly: there is no idle
    device to leave out, and a shortfall of processes is an error that
    names torchrun, never a silent shrink. Built once per shape (creating
    groups is collective: every rank makes the same calls)."""
    world = multihost.process_count()
    if n_data is None:
        n_data = max(1, world // n_model)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} processes, this run "
                         f"has {world}: {_launch_hint(n_data * n_model)}")
    key = (n_data, n_model)
    if key not in _MESHES:
        data_group = model_group = None
        if n_model > 1:
            rank = multihost.process_index()
            for m in range(n_model):     # columns: one data group per model index
                g = dist.new_group([d * n_model + m for d in range(n_data)])
                if rank % n_model == m:
                    data_group = g
            for d in range(n_data):      # rows: one model group per data index
                g = dist.new_group([d * n_model + m for m in range(n_model)])
                if rank // n_model == d:
                    model_group = g
        _MESHES[key] = Mesh(n_data, n_model, data_group, model_group)
    return _MESHES[key]


def make_mesh_for_batch(batch_size: int, n_data: Optional[int] = None,
                        n_model: int = 1) -> Mesh:
    """Mesh whose data axis divides the batch: n_data defaults to
    gcd(world // n_model, batch), the JAX rule. A width the processes cannot
    fill (more shards than processes, or a batch the world does not divide)
    raises instead of shrinking: every process of the run is a shard."""
    world = multihost.process_count()
    if n_data is None:
        n_data = math.gcd(max(1, world // n_model), batch_size) or 1
        if n_data * n_model != world:
            raise ValueError(f"--batch {batch_size} does not split over the {world} processes "
                             f"of this run: pick a batch divisible by {world // n_model} or "
                             f"{_launch_hint(n_data * n_model)}")
    if batch_size % n_data:
        raise ValueError(f"--batch {batch_size} is not divisible by --n_data_shards {n_data}")
    return make_mesh(n_data, n_model)


def _rows(x: Any, mesh: Mesh, axis: int) -> Any:
    if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim <= axis:
        return x
    n = x.shape[axis]
    if n % mesh.n_data:
        raise ValueError(f"batch axis of length {n} does not split over {mesh.n_data} data shards")
    per = n // mesh.n_data
    idx = [slice(None)] * axis + [slice(mesh.data_index * per, (mesh.data_index + 1) * per)]
    return x[tuple(idx)]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every leaf's leading (batch) axis; scalars and
    0-d leaves pass through (a dict, or one array)."""
    if mesh.n_data == 1:
        return batch
    if isinstance(batch, dict):
        return {k: _rows(v, mesh, 0) for k, v in batch.items()}
    return _rows(batch, mesh, 0)


def shard_superbatch(batch: Dict, mesh: Mesh) -> Dict:
    """[S, B, ...] superbatches: every step kept, this rank's rows of B."""
    if mesh.n_data == 1:
        return batch
    return {k: _rows(v, mesh, 1) for k, v in batch.items()}


@torch.no_grad()
def replicate(tensors: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of a (nested) dict or list, in place, from the
    first rank of this rank's data group; returns the same tree."""
    if mesh.n_data == 1:
        return tensors
    src = dist.get_global_rank(mesh.data_group, 0) if mesh.data_group is not None else 0
    host = dist.get_backend(mesh.data_group) == dist.Backend.GLOO
    for t in _leaves(tensors):
        staged = host and t.is_cuda
        buf = t.detach().cpu() if staged else t.detach()
        dist.broadcast(buf, src, group=mesh.data_group)
        if staged:
            t.detach().copy_(buf)
    return tensors


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# ---------------------------------------------------------------------------
# the data-parallel step context
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


class GlobalDraws(TorchFunctionMode):
    """torch.rand / randn / randint from `generator` whose leading dimension
    is the local batch are drawn at the global batch (n_data times as many
    rows) and sliced to this rank's rows; every other draw is made as it
    is. Each rank thus advances the generator as one process at the global
    batch does. Every draw a loss makes from the step's generator must lead
    with the batch axis when it depends on the batch."""

    _FUNCS = (torch.rand, torch.randn, torch.randint)

    def __init__(self, generator: torch.Generator, mesh: Mesh, local_batch: int):
        super().__init__()
        self.generator, self.mesh, self.local_batch = generator, mesh, local_batch

    def __torch_function__(self, func, types, args=(), kwargs=None):
        # the mode is off while this runs: the calls below are plain torch
        kwargs = kwargs or {}
        if func not in self._FUNCS or kwargs.get("generator") is not self.generator:
            return func(*args, **kwargs)
        args = list(args)
        if func is torch.randint:        # randint([low,] high, size)
            shape = tuple(args[-1])
        else:                            # rand / randn(*size) or (size)
            shape = tuple(args[0]) if len(args) == 1 and not isinstance(args[0], int) \
                else tuple(args)
        if not shape or shape[0] != self.local_batch:
            return func(*args, **kwargs)
        big = (shape[0] * self.mesh.n_data,) + shape[1:]
        args = args[:-1] + [big] if func is torch.randint else [big]
        i = self.mesh.data_index
        return func(*args, **kwargs)[i * shape[0]:(i + 1) * shape[0]]


@contextlib.contextmanager
def data_parallel_step(mesh: Optional[Mesh], rng: Any, local_batch: int):
    """The context a loss runs in on one data shard: global draws from `rng`
    (a torch.Generator) and `dp_sum` / `dp_mean` over the data group. A mesh
    of one data shard (or None) changes nothing."""
    global _ACTIVE
    if mesh is None or mesh.n_data == 1:
        yield
        return
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        if isinstance(rng, torch.Generator):
            with GlobalDraws(rng, mesh, local_batch):
                yield
        else:
            yield
    finally:
        _ACTIVE = prev


def shard_draws(rng: Any, mesh: Optional[Mesh], local_batch: int) -> Any:
    """Injected draws (a dict of global-batch tensors, nested in dicts and
    lists) cut to this rank's rows: tensors whose leading dimension is the
    global batch."""
    if mesh is None or mesh.n_data == 1 or not isinstance(rng, dict):
        return rng
    g = local_batch * mesh.n_data

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(cut(x) for x in v)
        if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == g:
            return _rows(v, mesh, 0)
        return v

    return cut(rng)


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data group of the running data-parallel step
    (differentiable; backward psum); x itself outside one."""
    if _ACTIVE is None:
        return x
    return psum(x, _ACTIVE.data_group)


def dp_mean(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """The global-batch mean of x (over `dim`, or over every element) inside
    a data-parallel step, the plain mean outside one."""
    if _ACTIVE is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    count = x.numel() if dim is None else x.shape[dim]
    total = x.sum() if dim is None else x.sum(dim=dim)
    return dp_sum(total) / (count * _ACTIVE.n_data)
