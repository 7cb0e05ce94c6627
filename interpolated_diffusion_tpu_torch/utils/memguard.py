"""Pre-OOM host-RAM guard for streaming trainers (own copy of the JAX
package's utils/memguard.py).

Tar shard streaming with large shuffle buffers is the known way to run the
host out of memory, and a hard kernel OOM loses the run without a
checkpoint. Aborting with a clear error at a configurable threshold lets a
watchdog restart from the last checkpoint with smaller buffers.

The check is host-side and cheap (one psutil call); trainers call it once
per step. psutil is optional: without it the guard is a no-op.
"""
from __future__ import annotations

import argparse


def add_memguard_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--max_cpu_mem_percent", type=float, default=98.0,
        help="Abort before the host OOMs (streaming shuffle-buffer failure "
             "mode); 0 disables the guard.",
    )


def check_cpu_mem(max_percent: float) -> None:
    """Raise before the host OOMs; no-op when disabled or psutil is absent."""
    if not max_percent or max_percent <= 0:
        return
    try:
        import psutil
    except ImportError:
        return
    pct = float(psutil.virtual_memory().percent)
    if pct >= float(max_percent):
        raise RuntimeError(
            f"host RAM usage {pct:.1f}% >= --max_cpu_mem_percent="
            f"{max_percent:.1f} — aborting before the kernel OOM-kills the "
            "run. Reduce --shuffle_buffer and/or the loader worker count, "
            "then resume from the latest checkpoint."
        )
