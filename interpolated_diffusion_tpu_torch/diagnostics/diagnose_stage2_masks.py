"""Stage-2 nested-mask statistics (port of diagnostics/diagnose_stage2_masks.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.diagnose_stage2_masks \\
        [--T 64 --K_min 8 --levels 3 --batch 512] [--device cpu]

Reports per-level anchor counts, gap statistics and nestedness violations
for the two mask policies (random_nested; uniform_base: uniform anchors at
K_min grown by random priorities), as the oracle check that the corruption
matches the training assumptions. The uniforms are the `draws` argument of
`main` ({"mask_rand": [B, T-2], "base_rand": [B, T]}, so that a test hands in
the JAX CLI's), else drawn from a torch.Generator seeded by --seed on the
device. Prints the JSON report (and writes it to --out_json).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.keyframes import (
    build_nested_masks_batch,
    build_nested_masks_from_base,
    compute_k_schedule,
    sample_fixed_k_indices_uniform_batch,
)
from ..train.common import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diagnose_stage2_masks")
    p.add_argument("--T", type=int, default=64)
    p.add_argument("--K_min", type=int, default=8)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--k_schedule", type=str, default="doubling")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_json", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def main(argv=None, draws: Optional[Dict[str, torch.Tensor]] = None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    B, T = args.batch, args.T
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        draws = {"mask_rand": torch.rand((B, T - 2), generator=gen, device=device),
                 "base_rand": torch.rand((B, T), generator=gen, device=device)}
    draws = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).to(device)
             for k, v in draws.items()}
    report = {"k_list": compute_k_schedule(T, args.K_min, args.levels, args.k_schedule)}
    for policy in ("random_nested", "uniform_base"):
        if policy == "random_nested":
            masks, _ = build_nested_masks_batch(B, T, args.K_min, args.levels,
                                                k_schedule=args.k_schedule,
                                                rand=draws["mask_rand"])
        else:
            idx, _ = sample_fixed_k_indices_uniform_batch(B, T, args.K_min, device=device)
            masks, _ = build_nested_masks_from_base(idx, T, args.levels,
                                                    k_schedule=args.k_schedule,
                                                    rand=draws["base_rand"])
        m = masks.cpu().numpy()
        stats = {}
        violations = 0
        for s in range(args.levels + 1):
            counts = m[:, s].sum(1)
            pos = [np.where(row)[0] for row in m[:, s]]
            gaps = np.concatenate([np.diff(pp) for pp in pos])
            stats[f"level_{s}"] = {
                "count_mean": float(counts.mean()),
                "count_std": float(counts.std()),
                "gap_mean": float(gaps.mean()),
                "gap_max": int(gaps.max()),
            }
            if s >= 1:
                violations += int((m[:, s] & ~m[:, s - 1]).sum())
        stats["nestedness_violations"] = violations
        report[policy] = stats
    out = json.dumps(report, indent=2)
    print(out)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(out)
    return report


if __name__ == "__main__":
    main()
