#!/usr/bin/env python3
"""The spread of a cell's end-to-end metrics over sets of runs, for setting
and checking bounds.

    python3 portbench/spread.py --set s1_*.out --set s2_*.out

Each file is a run's standard output (its last line is the result). For each
metric and set: the median and the spread, (Q3 - Q1) / median with the
quartiles of statistics.quantiles(n=4); then the wider of the sets' spreads,
five times it (the bound that spread suggests, never under 1%), and the
second set's median against the first's.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness.core import quartile_spread  # noqa: E402


def read(path: str) -> dict:
    line = Path(path).read_text().strip().splitlines()[-1]
    return {k: v["value"] for k, v in json.loads(line)["metrics"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--set", nargs="+", action="append", required=True)
    args = p.parse_args(argv)
    sets = [[read(f) for f in files] for files in args.set]
    for name in sorted(set().union(*(r.keys() for runs in sets for r in runs))):
        values = [[r[name] for r in runs if name in r] for runs in sets]
        meds = [statistics.median(v) for v in values]
        spreads = [quartile_spread(v) if len(v) >= 2 else float("nan") for v in values]
        wide = max(spreads)
        print(json.dumps({"metric": name, "medians": meds, "spreads": spreads, "widest": wide,
                          "bound_at_5x": max(0.01, 5 * wide),
                          "second_vs_first": meds[-1] / meds[0] - 1 if len(meds) > 1 else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
