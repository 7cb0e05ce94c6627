#!/usr/bin/env python3
"""The control of the HunyuanVideo and Wan Phase-2 cells' comparisons
(generators hy_train and wan_p2_train), as portbench/control.py is the
other cells': the plain reference put in the program's place one precision
below the configuration's (float8 e4m3 products), judged by the cell's own
comparison against the float32 reference, which has to come out not
correct; or the program with a fault planted underneath (`--fault`:
state_unchanged, the step returns its state as it was; half_batch, the loss
sees the first half of each batch; mask_ignored, HunyuanVideo attends to the
padded prompt tokens too); or the program as it is (`--sound`),
the readings the limits' lower ends come from. Prints one JSON line per seed
with the compared numbers and their limits.

    python3 portbench/control_video.py --workload <cell> --seeds 1,2,3 \\
        [--fault NAME | --sound] [--seconds 0]

With --fault or --sound the cell's generator runs whole, its window
--seconds long (0: the checked steps and the comparison only). Not part of a
benchmark run; the benchmark's runs never call it.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import core  # noqa: E402

TRAINERS = {"hy_train": ("interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth",
                         "phase1_loss"),
            "wan_p2_train": ("interpolated_diffusion_tpu_torch.train.train_interp_levels_wansynth",
                             "phase2_loss")}


@contextlib.contextmanager
def _patched(module: str, name: str, make):
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    setattr(mod, name, make(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def fault(gen: str, name: str):
    """The fault `name` planted in the cell's trainer module."""
    import torch

    module, loss_name = TRAINERS[gen]
    if name == "state_unchanged":
        def make(real):
            def make_step(loss_fn, *args, **kwargs):
                def step(state, frozen, batch, rng):
                    loss, _ = loss_fn(state.params, frozen, batch, rng)
                    return state, {"loss": loss.detach()}
                return step
            return make_step
        return _patched(module, "make_train_step_frozen", make)
    edits = {"half_batch": lambda b: {k: v[: v.shape[0] // 2] for k, v in b.items()},
             "mask_ignored": lambda b: dict(b, text_mask=torch.ones_like(b["text_mask"]))}
    if name not in edits:
        raise ValueError(f"no fault {name!r}")

    def make(real):
        def loss(*args):
            *head, batch, rng = args
            return real(*head, edits[name](batch), rng)
        return loss
    return _patched(module, loss_name, make)


def reference_control(cell: core.Cell, seed: int, device, precision: str = "fp8"):
    """The reference at `precision` against the float32 reference, on the
    batches, weights and draws a run of the cell makes from `seed`."""
    import torch
    from interpolated_diffusion_tpu_torch.data.dataset import BatchLoader

    gen = cell.traffic["generator"]
    g = core.generator_module(cell)
    tr = cell.traffic
    C, H, W = tr["latents"]
    if gen == "hy_train":
        cfg = cell.config
        data = g.SyntheticHy(core.sub_seed(seed, 2), tr["T"], C, H, W, tr["text_len"],
                             cfg["text_embed_dim"], tr["text_valid"],
                             cfg["pooled_projection_dim"])
        p = cfg["patch_size"]
        size = lambda gen_: g.draws(gen_, tr["batch"], tr["K"], (H // p) * (W // p), C * p * p,
                                    cfg["n_train"])
    else:
        from portbench.reference import wan_p2_ref

        cfg = g.model_config(cell.config, tr)
        data = g.SyntheticWan(core.sub_seed(seed, 2), tr["T"], C, H, W, tr["text_len"],
                              cfg["text_dim"])
        p = cfg["patch_size"][1]
        size = lambda gen_: wan_p2_ref.draws(gen_, tr["batch"], tr["T"],
                                             (H // p) * (W // p) * C * p * p, tr["K_min"],
                                             tr["levels"])
    loader = iter(BatchLoader(data, batch_size=tr["batch"],
                              seed=core.sub_seed(seed, 3) % (1 << 32)))
    batches = [next(loader) for _ in range(int(tr["check_steps"]))]
    rng = torch.Generator(device=device).manual_seed(core.sub_seed(seed, 4))
    states = []
    for _ in batches:
        states.append(rng.get_state())
        size(rng)
    w_seed = core.sub_seed(seed, 1)
    ref = g.reference_run(cfg, tr, w_seed, batches, states, device, "f32")
    low = g.reference_run(cfg, tr, w_seed, batches, states, device, precision)
    return g.compare(low, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--sound", action="store_true")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    core.prepare_environment()
    cell = core.find_cell(args.workload)
    gen = cell.traffic["generator"]
    if gen not in TRAINERS:
        raise SystemExit(f"{args.workload}: generator {gen!r} is portbench/control.py's")
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault or args.sound:
            ctx = fault(gen, args.fault) if args.fault else contextlib.nullcontext()
            with ctx:
                checks = core.generator_module(cell).run(cell, seed, args.seconds, False,
                                                         args.device).checks
            what = f"program with fault {args.fault}" if args.fault else "program"
        else:
            checks = reference_control(cell, seed, args.device)
            what = "reference fp8"
        print(json.dumps({"workload": args.workload, "seed": seed, "control": what,
                          "correct": all(c.ok for c in checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
