"""Global selector-vs-DP-label accuracy (port of diagnostics/diagnose_selector.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.diagnose_selector \\
        --ckpt RUN_OR_CKPT --prepared_path X.npz [--batch 512] [--device cpu]

Runs a trained KeypointSelector on a random batch of a prepared dataset
(drawn with numpy's RandomState(--seed) without replacement, as the JAX CLI
draws it) and reports the index MAE of sorted predictions against the
labels (the top level of kp_mask_levels, else kp_idx), the per-sample set
overlap and the most often chosen interior indices of both: did the
selector learn more than a global prior (diagnose_selector_per_maze.py
breaks it down by maze). Returns the report (and writes it to --out_json).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.dataset import PreparedTrajectoryDataset
from ..models.loading import load_selector_model
from ..models.selector import select_topk_indices
from ..train.common import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diagnose_selector")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--prepared_path", type=str, required=True)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_json", type=str, default=None)
    p.add_argument("--bf16", type=int, default=1,
                   help="1 (as the JAX CLI loads it): the selector computes in bf16; 0: f32")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    model, meta = load_selector_model(args.ckpt, bool(args.bf16), device=device)
    ds = PreparedTrajectoryDataset(args.prepared_path)
    T, K = int(meta["T"]), int(meta.get("K", 8))
    levels = int(meta.get("levels", 3))

    rng = np.random.RandomState(args.seed)
    B = min(args.batch, len(ds))
    batch = ds.get_batch(rng.choice(len(ds), size=B, replace=False))

    # labels: the top-level kp mask (K anchors) when per-level labels exist, else kp_idx
    if "kp_mask_levels" in batch:
        true_mask = np.asarray(batch["kp_mask_levels"])[:, levels]
        true = np.stack([np.nonzero(m)[0][:K] for m in true_mask])
    else:
        true = np.asarray(batch["kp_idx"])[:, :K]

    cond = {"occ": torch.as_tensor(batch["occ"]).to(device),
            "start_goal": torch.as_tensor(batch["start_goal"]).to(device)}
    if meta.get("use_sdf") and "sdf" in batch:
        cond["sdf"] = torch.as_tensor(batch["sdf"]).to(device)
    if meta.get("use_level"):
        cond["level"] = torch.full((B, 1), K / max(1, T - 1), device=device)
    with torch.no_grad():
        pred = select_topk_indices(model(cond), K).cpu().numpy()

    true_s = np.sort(true, axis=1)
    pred_s = np.sort(pred, axis=1)
    mae = float(np.abs(pred_s - true_s).mean())
    overlap = float(np.mean([
        len(set(pred[i].tolist()) & set(true[i].tolist())) / max(1, len(true[i]))
        for i in range(B)
    ]))
    hist_true = np.bincount(true.reshape(-1), minlength=T)
    hist_pred = np.bincount(pred.reshape(-1), minlength=T)
    top_true = (np.argsort(-hist_true[1:-1])[:10] + 1).tolist()
    top_pred = (np.argsort(-hist_pred[1:-1])[:10] + 1).tolist()

    print(f"selector mae={mae:.2f} overlap={overlap:.3f} (B={B}, K={K}, T={T})")
    print("top interior label idx:", top_true)
    print("top interior pred  idx:", top_pred)
    report = {"mae": mae, "overlap": overlap, "top_true": top_true,
              "top_pred": top_pred}
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
