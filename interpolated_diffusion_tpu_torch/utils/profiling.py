"""Profiling harness: torch.profiler traces, the program's spans, and
synchronised timing (port of utils/profiling.py).

`trace(log_dir)` records the enclosed block with torch.profiler (CPU, and
CUDA when a GPU is present) and writes `trace.json` (Chrome trace format,
viewable in chrome://tracing or Perfetto) into log_dir. `time_fn` gives
steady-state wall-clock seconds per call with its warm-up calls excluded,
synchronising the GPU around the timed loop.

`span(name)` and `backward_span(name, fn, *inputs)` mark the program's
phases in such a trace. They record only while a torch.profiler records (a
`trace` window, the Wan trainer's `--profile_dir`, or any profiler a caller
runs); otherwise `span` hands back one shared no-op context and
`backward_span` builds the autograd graph it would build without it. A span
is a host range of the profiler's own (`torch._C._profiler._RecordFunctionFast`,
an event of category `cpu_op` in the trace, on the clock of the kernels): a
kernel belongs to it when its launch lies inside the range. The spans, all
named `idt.*`:

- `idt.data.wait`: the train loop blocked on `DevicePrefetcher`'s queue (the
  next batch was not ready yet).
- `idt.train.step`: one train step (`train/state.make_train_step_frozen`,
  `make_train_step`), holding `idt.train.forward` (the loss),
  `idt.train.backward` (`torch.autograd.grad`; the autograd engine launches
  its kernels from its own thread while the range is open on the caller's)
  and `idt.train.optimizer` (global norm, clip, the update, EMA). A gap
  inside the step but outside its three children is the gradients'
  reduction across ranks or the step's own Python.
- `idt.wan.sla`: `kernels/sla.SparseLinearAttention`'s forward (again in
  the backward where activation recomputation replays it), holding
  `idt.wan.sla.block_map` (pooled scores and top-k LUT),
  `idt.wan.sla.sparse` (the bf16 casts and the block-sparse kernel) and
  `idt.wan.sla.linear` (the linear branch and `proj_l`);
  `idt.wan.sla.bwd` spans the module's backward, from its output's
  gradient to its inputs'.
- `idt.plan.call`: one call of `sample/generate.make_pipeline`'s planner,
  holding `idt.plan.encode` (both maze encoders), `idt.plan.stage1` (the
  Stage-1 solver loop), `idt.plan.lerp` (segment-lerp between the
  keypoints) and one `idt.plan.level` per Stage-2 level.
- `idt.block`: one `models/transformer.TransformerBlock` forward, whatever
  policy computes it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range `name` while a torch.profiler records, the shared
    no-op context otherwise. The range is the profiler's C++ one, not
    `torch.autograd.profiler.record_function`, whose enter and exit are two
    dispatched operators: under a recording profiler ~10-40 us a span against
    ~1.5, which a host-paced call of hundreds of spans would feel."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


class _BackwardOpen(torch.autograd.Function):
    """Identity on an output; its backward opens the backward span."""

    @staticmethod
    def forward(ctx, x, name, opened):
        ctx.name, ctx.opened = name, opened
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rf = _RecordFunctionFast(ctx.name)
        rf.__enter__()
        ctx.opened.append(rf)
        return g, None, None


class _BackwardClose(torch.autograd.Function):
    """Identity on the inputs; its backward, which runs once every input's
    gradient is made, closes the span."""

    @staticmethod
    def forward(ctx, opened, *xs):
        ctx.opened = opened
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.opened:
            ctx.opened.pop().__exit__(None, None, None)
        return (None, *gs)


def backward_span(name: str, fn: Callable[..., torch.Tensor], *inputs) -> torch.Tensor:
    """fn(*inputs), whose backward runs inside the span `name`: an identity
    node on the tensor inputs that need a gradient and one on the output
    bracket the nodes fn makes. Inserted only while a torch.profiler records
    and gradients are on; otherwise fn(*inputs) alone, node for node."""
    if not (torch.autograd._profiler_enabled() and torch.is_grad_enabled()):
        return fn(*inputs)
    grad = [i for i, x in enumerate(inputs) if isinstance(x, torch.Tensor) and x.requires_grad]
    if not grad:
        return fn(*inputs)
    opened: List = []
    args = list(inputs)
    for i, x in zip(grad, _BackwardClose.apply(opened, *(inputs[i] for i in grad))):
        args[i] = x
    out = fn(*args)
    return _BackwardOpen.apply(out, name, opened) if out.requires_grad else out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    log_dir/trace.json; yields the profiler (key_averages() for tables)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        _sync()
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Tuple[float, object]:
    """Steady-state timing: (seconds per call over `iters` calls, last output);
    the `warmup` calls before are not timed."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters, out
