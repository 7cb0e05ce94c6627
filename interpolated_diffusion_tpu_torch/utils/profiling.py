"""Profiling harness: torch.profiler traces and synchronised timing (port of
utils/profiling.py).

`trace(log_dir)` records the enclosed block with torch.profiler (CPU, and
CUDA when a GPU is present) and writes `trace.json` (Chrome trace format,
viewable in chrome://tracing or Perfetto) into log_dir. `time_fn` gives
steady-state wall-clock seconds per call with its warm-up calls excluded,
synchronising the GPU around the timed loop.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch


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
