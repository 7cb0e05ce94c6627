"""The benchmark's own tracing: named spans around calls into the program's
layers, a torch.profiler segment, and the reduction of its trace to device
time, busy and idle time, time inside spans, and the breakdown.

Spans are record_function ranges opened and closed by module hooks, so they
bracket whatever kernels implement a module. A backward span is opened by the
gradient of the module's output and closed by the gradient of its inputs
(identity autograd nodes on both sides): the autograd engine runs the nodes
made inside the module's forward between those two. A kernel belongs to a
span when the host call that launched it lies inside the span on the same
thread (the profiler's correlation ids join the two).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import torch

SEGMENT = "pb.segment"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class _BackwardOpen(torch.autograd.Function):
    """Identity on a module's output; its backward opens the module's
    backward span."""

    @staticmethod
    def forward(ctx, x, spans, label):
        ctx.spans, ctx.label = spans, label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.spans._open(ctx.label)
        return g, None, None


class _BackwardClose(torch.autograd.Function):
    """Identity on a module's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, spans, label, *xs):
        ctx.spans, ctx.label = spans, label
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.spans._close(ctx.label)
        return (None, None, *gs)


class Spans:
    """Spans around modules: `<label>.fwd` around every forward call (the
    recomputed forward of an activation checkpoint included) and, with
    backward=True, `<label>.bwd` around the backward of the tensors the
    module made."""

    def __init__(self):
        self._handles = []
        self._open_ranges: Dict[str, List] = defaultdict(list)

    def _open(self, name: str) -> None:
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        self._open_ranges[name].append(rf)

    def _close(self, name: str) -> None:
        if self._open_ranges[name]:
            self._open_ranges[name].pop().__exit__(None, None, None)

    def around(self, module: torch.nn.Module, label: str, backward: bool = False) -> None:
        fwd = f"{label}.fwd"
        bwd = f"{label}.bwd"

        def pre(mod, args, kwargs):
            self._open(fwd)
            if not (backward and torch.is_grad_enabled()):
                return None
            tensors = [i for i, a in enumerate(args)
                       if isinstance(a, torch.Tensor) and a.requires_grad]
            if not tensors:
                return None
            wrapped = _BackwardClose.apply(self, bwd, *(args[i] for i in tensors))
            new = list(args)
            for i, w in zip(tensors, wrapped):
                new[i] = w
            return tuple(new), kwargs

        def post(mod, args, kwargs, out):
            self._close(fwd)
            if (backward and torch.is_grad_enabled() and isinstance(out, torch.Tensor)
                    and out.requires_grad):
                return _BackwardOpen.apply(out, self, bwd)
            return None

        self._handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
        self._handles.append(module.register_forward_hook(post, with_kwargs=True))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()


@dataclass
class Trace:
    """The reduced trace of one profiled segment (seconds throughout)."""

    t_start: float
    t_end: float
    device: List[Tuple[str, float, float, int]]      # (name, start, end, correlation)
    ranges: Dict[str, List[Tuple[float, float, int]]]  # label -> (start, end, tid)
    launches: Dict[int, Tuple[float, int]]            # correlation -> (time, tid)
    host: List[Tuple[str, float, float, int]]         # host events (name, start, end, tid)
    units: Dict[str, float] = field(default_factory=dict)   # steps / calls in the segment

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(s, self.t_start), min(e, self.t_end)) for _, s, e, _ in self.device
                       if e > self.t_start and s < self.t_end)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernels_in(self, prefix: str) -> List[Tuple[str, float, float, int]]:
        """Device operations launched inside a range whose label starts with
        `prefix`, on the range's own thread."""
        by_tid: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        for label, rs in self.ranges.items():
            if label.startswith(prefix):
                for s, e, tid in rs:
                    by_tid[tid].append((s, e))
        for tid in by_tid:
            by_tid[tid].sort()
        starts = {tid: [s for s, _ in rs] for tid, rs in by_tid.items()}
        out = []
        for op in self.device:
            launch = self.launches.get(op[3])
            if launch is None or launch[1] not in by_tid:
                continue
            t, tid = launch
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and by_tid[tid][i][0] <= t <= by_tid[tid][i][1]:
                out.append(op)
        return out

    def device_s(self, ops) -> float:
        return sum(e - s for _, s, e, _ in ops)

    def range_count(self, label: str) -> int:
        return len(self.ranges.get(label, []))

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device:
            total[name[:160]] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest gaps with no device operation inside the segment,
        each named by the innermost host event, on any thread (the backward
        runs on autograd's), that covers the gap's middle."""
        busy = self.busy_intervals()
        if not busy:
            return []
        t1 = self.t_end
        gaps, prev = [], self.t_start
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((prev, t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            inner = [h for h in self.host if h[1] <= mid <= h[2] and h[0] != SEGMENT]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host outside any op"
            out.append([name[:160], e - s])
        return out

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def parse_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    device, launches, host = [], {}, []
    ranges: Dict[str, List[Tuple[float, float, int]]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ev.get("name", "?"), s, e, int(args.get("correlation", -1))))
        elif cat in LAUNCH_CATS:
            launches[int(args.get("correlation", -1))] = (s, ev.get("tid"))
        elif cat in HOST_CATS:
            name = ev.get("name", "?")
            if cat == "user_annotation" and name.startswith("pb."):
                ranges[name].append((s, e, ev.get("tid")))
            host.append((name, s, e, ev.get("tid")))
    if SEGMENT in ranges:
        t_start, t_end = ranges[SEGMENT][0][:2]
    else:
        t_start = min((d[1] for d in device), default=0.0)
        t_end = max((d[2] for d in device), default=0.0)
    return Trace(t_start, t_end, device, dict(ranges), launches, host)


@contextmanager
def profiled_segment(device="cuda") -> Iterator[Dict[str, Trace]]:
    """Profile the body (host and, on the card, CUDA activity), synchronised
    at both ends; the reduced trace is left in the yielded dict under
    "trace". The raw trace goes to a temporary file under TMPDIR and is
    deleted at once."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    holder: Dict[str, Trace] = {}
    sync()
    with profile(activities=activities) as prof:
        with torch.autograd.profiler.record_function(SEGMENT):
            yield holder
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder["trace"] = parse_chrome_trace(path)
    finally:
        os.unlink(path)
