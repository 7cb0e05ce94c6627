#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision below the configuration's (float8
e4m3 products for the bfloat16 models), on the inputs a run of the cell makes
from each seed, judged by the cell's own comparison against the float32
reference. It has to come out not correct. Prints one JSON line per seed
with the compared numbers and their limits.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

With --program-mode MODE (Wan cells) the program itself runs instead, with
its self-attention switched to MODE (sage_sla: int8 Q K^T), for a short
window, and its numbers are printed the same way; with --fault NAME the
program runs with that fault of portbench/faults.py planted underneath.

Not part of a benchmark run; the benchmark's runs never call it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import core  # noqa: E402


def wan_control(cell: core.Cell, seed: int, device, precision: str):
    import torch
    from interpolated_diffusion_tpu_torch.data.dataset import BatchLoader

    from portbench.generators import wan_train as g

    cfg, tr = cell.config, cell.traffic
    C, H, W = tr["latents"]
    data = g.SyntheticWan(core.sub_seed(seed, 2), tr["T"], C, H, W, tr["text_len"],
                          cfg["text_dim"])
    loader = iter(BatchLoader(data, batch_size=tr["batch"], seed=core.sub_seed(seed, 3) % (1 << 32)))
    batches = [next(loader) for _ in range(int(tr["check_steps"]))]
    rng = torch.Generator(device=device).manual_seed(core.sub_seed(seed, 4))
    p = cfg["patch_size"][1]
    states = []
    for _ in batches:
        states.append(rng.get_state())
        g.draws(rng, tr["batch"], tr["K"], (H // p) * (W // p), C * p * p, cfg["n_train"])
    w_seed = core.sub_seed(seed, 1)
    ref = g.reference_run(cfg, tr, w_seed, batches, states, device, "f32")
    low = g.reference_run(cfg, tr, w_seed, batches, states, device, precision)
    return g.compare(low, ref)


def maze_control(cell: core.Cell, seed: int, device, precision: str, n_calls: int = 100):
    from portbench.generators import maze_plan as g

    cfg, tr = cell.config, cell.traffic
    picked = g.sample_rows(seed, n_calls, tr["batch"], int(tr["check_rows"]))
    ref_x, ref_z = g.reference_plans(cfg, tr, seed, picked, device, "f32")
    low_x, low_z = g.reference_plans(cfg, tr, seed, picked, device, precision)
    found = g.gaps(low_x, low_z, ref_x, ref_z)
    print(f"[control] gaps {found}", file=sys.stderr, flush=True)
    return [core.Check(k, found[k], v) for k, v in g.LIMITS.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program-mode", default=None)
    p.add_argument("--fault", default=None, help="a fault of portbench/faults.py, planted in the program")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    core.prepare_environment()
    cell = core.find_cell(args.workload)
    gen = cell.traffic["generator"]
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:
            from portbench.faults import FAULTS

            with FAULTS[args.fault]():
                checks = core.generator_module(cell).run(cell, seed, args.seconds, False,
                                                         args.device).checks
            what = f"program with fault {args.fault}"
        elif args.program_mode:
            cell.config = dict(cell.config, attn_mode=args.program_mode)
            checks = core.generator_module(cell).run(cell, seed, args.seconds, False,
                                                     args.device).checks
            what = f"program {args.program_mode}"
        elif gen == "wan_train":
            checks = wan_control(cell, seed, args.device, "fp8")
            what = "reference fp8"
        else:
            checks = maze_control(cell, seed, args.device, "fp8")
            what = "reference fp8"
        print(json.dumps({"workload": args.workload, "seed": seed, "control": what,
                          "correct": all(c.ok for c in checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
