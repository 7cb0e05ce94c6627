"""Per-maze selector accuracy (port of diagnostics/diagnose_selector_per_maze.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.diagnose_selector_per_maze \\
        --ckpt RUN_OR_CKPT --eval_npz X.npz [--batch_per_maze 256 --max_mazes 3] [--device cpu]

Groups a prepared dataset by the hash of its occupancy grid, runs a trained
KeypointSelector on each of the --max_mazes largest groups (a sample of
--batch_per_maze drawn with numpy's RandomState(--seed), as the JAX CLI
draws it) and reports the index MAE and set overlap of predicted against
DP-label keypoints with each maze's most chosen interior indices: "the
selector learned this maze" against "it learned a global prior". Returns
the list of per-maze reports (None when the data has one shared grid).
"""
from __future__ import annotations

import argparse
import hashlib

import numpy as np
import torch

from ..data.dataset import PreparedTrajectoryDataset
from ..models.loading import load_selector_model
from ..models.selector import select_topk_indices
from ..train.common import resolve_device


def _hash_occ(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _index_histogram(idx: np.ndarray, T: int) -> np.ndarray:
    return np.bincount(idx.reshape(-1), minlength=T)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diagnose_selector_per_maze")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--eval_npz", type=str, required=True)
    p.add_argument("--batch_per_maze", type=int, default=256)
    p.add_argument("--max_mazes", type=int, default=3)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--bf16", type=int, default=1,
                   help="1 (as the JAX CLI loads it): the selector computes in bf16; 0: f32")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    model, meta = load_selector_model(args.ckpt, bool(args.bf16), device=device)
    ds = PreparedTrajectoryDataset(args.eval_npz)
    occ = ds.arrays.get("occ")
    if occ is None or occ.ndim == 2 or occ.shape[0] != len(ds):
        print("occ is shared across the dataset or missing — "
              "no per-maze grouping possible.")
        return None

    groups = {}
    for i in range(len(ds)):
        groups.setdefault(_hash_occ(occ[i]), []).append(i)
    maze_keys = sorted(groups, key=lambda k: len(groups[k]), reverse=True)
    maze_keys = maze_keys[: max(1, args.max_mazes)]

    T, K = int(meta["T"]), int(meta.get("K", 8))
    levels = int(meta.get("levels", 3))

    report = []
    for mi, key in enumerate(maze_keys):
        ids = np.asarray(groups[key])
        B = min(args.batch_per_maze, len(ids))
        chosen = rng.choice(ids, size=B, replace=False)
        batch = ds.get_batch(chosen)
        cond = {"occ": torch.as_tensor(batch["occ"]).to(device),
                "start_goal": torch.as_tensor(batch["start_goal"]).to(device)}
        if "sdf" in batch and bool(meta.get("use_sdf", 0)):
            cond["sdf"] = torch.as_tensor(batch["sdf"]).to(device)

        # labels: the full-sparsity level of the nested masks when stored,
        # otherwise the flat DP kp_idx
        if "kp_mask_levels" in batch:
            true_mask = batch["kp_mask_levels"][:, levels]
            true = np.stack([np.flatnonzero(m)[:K] for m in true_mask], axis=0)
            if bool(meta.get("use_level", 0)):
                lv = (np.full((B, 1), 1.0, np.float32)
                      if meta.get("level_mode", "k_norm") == "s_norm"
                      else np.full((B, 1), K / max(1, T - 1), np.float32))
                cond["level"] = torch.as_tensor(lv).to(device)
        elif "kp_idx" in batch:
            true = batch["kp_idx"].astype(np.int64)
        else:
            raise ValueError("eval npz has neither kp_mask_levels nor kp_idx")

        with torch.no_grad():
            pred = select_topk_indices(model(cond), K).cpu().numpy()
        k_cmp = min(pred.shape[1], true.shape[1])
        mae = float(np.abs(np.sort(pred, 1)[:, :k_cmp] - np.sort(true, 1)[:, :k_cmp]).mean())
        overlap = float(np.mean([
            len(set(pred[i].tolist()) & set(true[i].tolist()))
            / max(1, len(set(true[i].tolist()))) for i in range(B)
        ]))
        h_true = _index_histogram(true, T)
        h_pred = _index_histogram(pred, T)
        top_true = (np.argsort(-h_true[1:-1])[:10] + 1).tolist()
        top_pred = (np.argsort(-h_pred[1:-1])[:10] + 1).tolist()
        print(f"maze[{mi}] n={len(ids)} sample={B} mae={mae:.2f} "
              f"overlap={overlap:.3f}")
        print(f"  top label idx: {top_true}")
        print(f"  top pred  idx: {top_pred}")
        report.append({"n": len(ids), "mae": mae, "overlap": overlap,
                       "top_true": top_true, "top_pred": top_pred})
    return report


if __name__ == "__main__":
    main()
