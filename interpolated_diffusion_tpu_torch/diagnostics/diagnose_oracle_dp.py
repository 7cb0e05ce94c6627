"""Oracle-DP keypoint diversity (port of diagnostics/diagnose_oracle_dp.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.diagnose_oracle_dp \\
        [--T 21 --K 5 --batch 64 --latent_c 16 --latent_h 12 --latent_w 12] [--device cpu]

Runs the exact oracle-cost DP (ops/oracle_segment_cost, ops/selection) over
a batch of SyntheticWanDataset latents on the device and reports the anchor
indices' diversity: per-position histogram entropy, mean pairwise overlap,
the positions used. Degenerate selections point at a broken cost or DP.
`main(cost_matrix=...)` takes a [B, T, T] cost matrix in place of the one
computed here: the DP breaks near-ties by f32 order, so a test compares
index choices on one shared matrix. Prints the JSON report (and writes it to
--out_json).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ..data.wan_synth import SyntheticWanDataset
from ..ops.oracle_segment_cost import build_oracle_seg_precompute, compute_oracle_cost_seg_mse
from ..ops.selection import build_cost_matrix_from_segments, dp_select_indices_batch
from ..train.common import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diagnose_oracle_dp")
    p.add_argument("--T", type=int, default=21)
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--latent_c", type=int, default=16)
    p.add_argument("--latent_h", type=int, default=12)
    p.add_argument("--latent_w", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_json", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def oracle_cost_matrix(z: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, ...] latents -> the oracle lerp-MSE cost matrix [B, T, T]."""
    pre = build_oracle_seg_precompute(T)
    pre = type(pre)(*(t.to(z.device) for t in pre))
    cost = compute_oracle_cost_seg_mse(z.reshape(z.shape[0], T, -1), pre, normalize=False)
    return build_cost_matrix_from_segments(cost, pre, T)


def main(argv=None, cost_matrix: Optional[torch.Tensor] = None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if cost_matrix is None:
        ds = SyntheticWanDataset(n_samples=args.batch, T=args.T, C=args.latent_c,
                                 H=args.latent_h, W=args.latent_w, text_len=4,
                                 text_dim=8, seed=args.seed)
        z = torch.as_tensor(ds.get_batch(np.arange(args.batch))["latents"]).to(device)
        cost_matrix = oracle_cost_matrix(z, args.T)
    idx = dp_select_indices_batch(torch.as_tensor(cost_matrix).to(device), args.K).cpu().numpy()

    hist = np.zeros(args.T)
    for row in idx:
        hist[row] += 1
    probs = hist / hist.sum()
    nz = probs[probs > 0]
    entropy = float(-(nz * np.log(nz)).sum())
    sets = [set(map(int, r)) for r in idx]
    overlaps = [len(sets[i] & sets[j]) / args.K
                for i in range(len(sets)) for j in range(i + 1, len(sets))]
    report = {
        "index_entropy": entropy,
        "max_entropy": float(np.log(args.T)),
        "mean_pairwise_overlap": float(np.mean(overlaps)),
        "unique_index_positions": int((hist > 0).sum()),
        "histogram": hist.astype(int).tolist(),
    }
    out = json.dumps(report, indent=2)
    print(out)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(out)
    return report


if __name__ == "__main__":
    main()
