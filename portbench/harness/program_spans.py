"""The program's own spans in a parsed trace: the `idt.*` host ranges the
port opens while a profiler records (its utils/profiling.py lists them),
found by name among the trace's host events, whatever their category.

Two rules attribute a device operation to spans of a name:
- `ops_in`: launched inside such a span on the span's own thread
  (`Trace.kernels_in` over the spans' union), memory copies included;
- `kernels_while_open`: a kernel launched while such a span is open on any
  thread. A backward span opens on the caller's thread while the autograd
  engine launches the backward's kernels from its own; copies are left out,
  since the loader's thread copies the next batch during the step and
  belongs to no phase.

A program without the spans (one older than them) yields no ranges, and
every reader built on these returns None.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

from portbench.harness.trace import Trace

PREFIX = "idt."


def spans(trace: Trace, name: str) -> List[Tuple[float, float, int]]:
    """(start, end, tid) of every span called exactly `name`."""
    return [(s, e, tid) for n, s, e, tid in trace.host if n == name]


def count(trace: Trace, name: str) -> int:
    return len(spans(trace, name))


def host_s(trace: Trace, name: str) -> float:
    """Seconds the host spent inside spans called `name`, summed."""
    return sum(e - s for s, e, _ in spans(trace, name))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def ops_in(trace: Trace, *names: str) -> List[Tuple[str, float, float, int]]:
    """Device operations launched inside a span of one of `names`, on that
    span's thread. Nested or repeated spans are merged per thread first, so
    an operation is found once, whichever of them holds it."""
    by_tid: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for name in names:
        for s, e, tid in spans(trace, name):
            by_tid[tid].append((s, e))
    ranges = {PREFIX: [(s, e, tid) for tid, rs in by_tid.items() for s, e in _union(rs)]}
    return dataclasses.replace(trace, ranges=ranges).kernels_in(PREFIX)


def is_kernel(name: str) -> bool:
    low = name.lower()
    return "memcpy" not in low and "memset" not in low


def kernels_while_open(trace: Trace, *names: str) -> List[Tuple[str, float, float, int]]:
    """Kernels launched, from any thread, while a span of one of `names` was
    open on any thread."""
    union = _union([(s, e) for name in names for s, e, _ in spans(trace, name)])
    starts = [s for s, _ in union]
    out = []
    for op in trace.device:
        launch = trace.launches.get(op[3])
        if launch is None or not is_kernel(op[0]):
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and launch[0] <= union[i][1]:
            out.append(op)
    return out


def any_spans(trace: Trace) -> bool:
    return any(n.startswith(PREFIX) for n, _, _, _ in trace.host)


def traced(run, kind: str):
    """The run's parsed trace when it is of `kind` ("train" or "plan") and
    holds the program's spans; else None."""
    trace = run.get("trace") if run.get("kind") == kind else None
    return trace if trace is not None and any_spans(trace) else None


def per_unit_ms(trace: Trace, ops, unit: str) -> float:
    """Device milliseconds of `ops` per traced step or call."""
    return 1e3 * trace.device_s(ops) / trace.units[unit]
