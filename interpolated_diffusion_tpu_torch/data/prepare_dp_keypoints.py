"""Offline DP keypoint preparation: costs -> DP indices (+ levels) -> npz
(port of data/prepare_dp_keypoints.py).

    python -m interpolated_diffusion_tpu_torch.data.prepare_dp_keypoints --out_path dp.npz [flags]

Per-sample segment costs from the ground truth (SNR-weighted interp MSE,
`--cost_source gt`) or from a trained D_phi checkpoint (`--cost_source
dphi`), the DP shortest-path selection of K anchors, optional per-level DP
masks (`--store_kp_mask_levels`: one DP per level K_s) and the keypoint
features, written with the raw data into one npz (the JAX package's keys:
x, occ, start_goal, kp_idx int32, kp_feat, [sdf], [kp_mask_levels]) and its
`.json` sidecar. `--prepared_path` annotates an existing prepared npz
instead of generating particle mazes. Costs and the DP run batched on the
GPU unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..ops.keyframes import compute_k_schedule
from ..ops.selection import (build_cost_matrix_from_segments, build_kp_feat_batch,
                             build_segment_features, build_segment_precompute,
                             build_snr_weights, compute_segment_costs_batch,
                             dp_select_indices_batch, sample_timesteps_log_snr,
                             snr_weight_scale)
from .dataset import ParticleMazeDataset, PreparedTrajectoryDataset


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("prepare_dp_keypoints")
    p.add_argument("--out_path", type=str, required=True)
    p.add_argument("--prepared_path", type=str, default=None,
                   help="annotate an existing prepared npz with the DP keypoint fields instead "
                        "of generating particle-maze data")
    p.add_argument("--T", type=int, default=64)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=10000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--maze_h", type=int, default=21)
    p.add_argument("--maze_w", type=int, default=21)
    p.add_argument("--with_velocity", type=int, default=0)
    p.add_argument("--use_sdf", type=int, default=0)
    p.add_argument("--data_seed", type=int, default=123)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--cost_source", type=str, default="gt", choices=["gt", "dphi"])
    p.add_argument("--dphi_ckpt", type=str, default=None)
    p.add_argument("--segment_cost_samples", type=int, default=16)
    p.add_argument("--snr_schedule", type=str, default="cosine")
    p.add_argument("--snr_N_train", type=int, default=1000)
    p.add_argument("--snr_min", type=float, default=0.1)
    p.add_argument("--snr_max", type=float, default=10.0)
    p.add_argument("--snr_gamma", type=float, default=1.0)
    p.add_argument("--t_steps", type=int, default=16)
    p.add_argument("--store_kp_mask_levels", type=int, default=0)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--k_schedule", type=str, default="doubling")
    p.add_argument("--k_geom_gamma", type=float, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def main(argv=None):
    from ..train.common import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if args.prepared_path:
        ds = PreparedTrajectoryDataset(args.prepared_path)
        if ds.T != args.T:
            raise ValueError(f"--T {args.T} != prepared T {ds.T}")
        if args.use_sdf and "sdf" not in ds.arrays:
            raise ValueError("--use_sdf 1 but prepared npz has no sdf")
    else:
        ds = ParticleMazeDataset(
            num_samples=args.num_samples, h=args.maze_h, w=args.maze_w, T=args.T,
            with_velocity=bool(args.with_velocity), use_sdf=bool(args.use_sdf),
            cache_dir=args.cache_dir, seed=args.data_seed)
    precomp = build_segment_precompute(args.T, args.segment_cost_samples).to(device)
    seg_feat = build_segment_features(args.T, precomp.seg_i, precomp.seg_j)
    snr, weights = build_snr_weights(args.snr_schedule, args.snr_N_train, args.snr_min,
                                     args.snr_max, args.snr_gamma)
    weight_scale = snr_weight_scale(weights, sample_timesteps_log_snr(snr, args.t_steps))

    dphi = None
    if args.cost_source == "dphi":
        if not args.dphi_ckpt:
            raise ValueError("--dphi_ckpt required for cost_source=dphi")
        from ..models.loading import load_segment_cost_model

        dphi = load_segment_cost_model(args.dphi_ckpt, bf16=False, device=device)

    k_list = compute_k_schedule(args.T, args.K, args.levels, args.k_schedule, args.k_geom_gamma)
    to_dev = lambda a: torch.as_tensor(a).to(device)

    all_x, all_occ, all_sg, all_sdf = [], [], [], []
    all_idx, all_feat, all_levels = [], [], []
    n = len(ds)
    with torch.no_grad():
        for lo in range(0, n, args.batch):
            idxs = np.arange(lo, min(n, lo + args.batch))
            batch = ds.get_batch(idxs)
            if dphi is None:
                cost = compute_segment_costs_batch(to_dev(batch["x"]), precomp, weight_scale)
            else:
                model, meta = dphi
                cond = {"occ": to_dev(batch["occ"]), "start_goal": to_dev(batch["start_goal"])}
                if args.use_sdf:
                    cond["sdf"] = to_dev(batch["sdf"])
                cost = model(cond, seg_feat)
                if meta.get("normalize_targets"):
                    cost = cost * meta["target_std"] + meta["target_mean"]
            C = build_cost_matrix_from_segments(cost, precomp, args.T)
            kp_idx = dp_select_indices_batch(C, args.K)
            all_idx.append(kp_idx.cpu().numpy().astype(np.int32))
            all_feat.append(build_kp_feat_batch(kp_idx, args.T).cpu().numpy())
            if args.store_kp_mask_levels:
                masks = np.zeros((len(idxs), args.levels + 1, args.T), dtype=bool)
                for s in range(args.levels + 1):
                    idx_s = dp_select_indices_batch(C, int(k_list[s])).cpu().numpy()
                    masks[np.arange(len(idxs))[:, None], s, idx_s] = True
                all_levels.append(masks)
            all_x.append(batch["x"])
            all_occ.append(batch["occ"])
            all_sg.append(batch["start_goal"])
            if args.use_sdf:
                all_sdf.append(batch["sdf"])
            print(f"prepared {min(n, lo + args.batch)}/{n}", flush=True)

    out = {
        "x": np.concatenate(all_x),
        "occ": np.concatenate(all_occ),
        "start_goal": np.concatenate(all_sg),
        "kp_idx": np.concatenate(all_idx),
        "kp_feat": np.concatenate(all_feat),
    }
    if args.use_sdf:
        out["sdf"] = np.concatenate(all_sdf)
    if args.store_kp_mask_levels:
        out["kp_mask_levels"] = np.concatenate(all_levels)
    os.makedirs(os.path.dirname(os.path.abspath(args.out_path)), exist_ok=True)
    np.savez_compressed(args.out_path, **out)
    with open(args.out_path + ".json", "w") as f:
        json.dump({"args": vars(args), "k_list": k_list}, f, indent=2)
    print(f"wrote {args.out_path}: " + ", ".join(f"{k}{v.shape}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main()
