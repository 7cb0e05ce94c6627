#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in BENCHMARK.json; its configuration, traffic
mix, generator and per-layer metric readers are found by the names there
(portbench/configs, traffic, generators, metrics). With --trace 0 the line
carries the cell's end-to-end metrics, with --trace 1 its per-layer metrics
(from a profiled segment after the measured window). The last line of
standard output is the JSON result; the numbers compared for `correct`, each
beside its limit, are the last lines of standard error and the last key of
the result. Exits non-zero, printing no result, without enough CUDA devices,
or if JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import core  # noqa: E402  (stdlib only: torch is imported later)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    core.prepare_environment()
    cell = core.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    outcome = core.generator_module(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                                              device="cuda")
    line = core.result_line(cell, outcome, bool(args.trace))
    loaded = core.forbidden_loaded()
    if loaded:
        print(f"portbench: forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 3
    print(f"[result] correct {line['correct']}, attempted {line['attempted']}, "
          f"failed {line['failed']}", file=sys.stderr)
    for c in outcome.checks:
        print(f"[check] {c.name} {c.value!r} limit {c.limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
