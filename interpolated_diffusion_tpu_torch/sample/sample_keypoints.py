"""Stage-1-only sampler: keypoints, then their interpolation, metrics and plots
(port of sample/sample_keypoints.py).

    python -m interpolated_diffusion_tpu_torch.sample.sample_keypoints --kp_ckpt <run>

Samples K anchor positions with the keypoint model (DDIM, PFDiff or
DPM-Solver++ on `--time_spacing`; an rf checkpoint integrates its velocity
field), lerps them to a full trajectory, and writes metrics.csv,
summary.json, samples.npz and (`--plots`, matplotlib) samples.png. Anchor
indices come from the host RandomState (`--kp_index_mode`), the initial
noise [B, K, D] from a torch.Generator seeded by `--sample_seed`. A
checkpoint trained with kp_feat gets its index features, the cost channels
from `--dphi_ckpt`.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

from ..kernels.tuning import add_attn_policy_arg
from ..eval.metrics import compute_metrics_batch
from ..models.loading import load_keypoint_model, make_dphi_seg_cost_fn
from ..ops.ddpm import SOLVERS, make_timesteps, run_solver
from ..ops.keyframes import interpolate_from_indices
from ..ops.normalize import logit_pos, sigmoid_pos
from ..ops.rectified_flow import rf_integrate
from ..ops.schedules import make_schedule
from ..ops.selection import build_kp_feat_full
from ..train.batches import build_known_mask_values
from ..train.common import add_data_args, make_dataset, resolve_device, sample_idx_policy
from .generate import hoist_cond_vec


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sample_keypoints (Stage-1 only, GPU)")
    p.add_argument("--kp_ckpt", type=str, required=True)
    p.add_argument("--use_ema", type=int, default=1)
    p.add_argument("--num_batches", type=int, default=2)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--ddim_steps", type=int, default=20)
    p.add_argument("--solver", type=str, default="ddim", choices=list(SOLVERS),
                   help="pfdiff: ~half the model evals on the same grid; "
                        "dpm: DPM-Solver++(2M) 2nd-order accuracy per eval")
    p.add_argument("--time_spacing", type=str, default="quadratic",
                   choices=["linear", "quadratic", "sqrt"])
    p.add_argument("--kp_index_mode", type=str, default="uniform", choices=["random", "uniform"])
    p.add_argument("--pos_clip", type=int, default=1)
    p.add_argument("--dphi_ckpt", type=str, default=None,
                   help="segment-cost ckpt for the kp_feat cost channels")
    p.add_argument("--sample_seed", type=int, default=1234)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--plots", type=int, default=1)
    p.add_argument("--max_plots", type=int, default=8)
    p.add_argument("--out_dir", type=str, default="runs/samples_kp")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    add_attn_policy_arg(p)
    add_data_args(p)
    return p


def make_sampler(model, meta, args, device, dphi_fn=None):
    """sample(z [B, K, D] initial noise, idx [B, K], cond) -> (keypoints
    [B, K, D], trajectory [B, T, D])."""
    T, D = int(meta["T"]), int(meta["data_dim"])
    schedule = make_schedule(meta["schedule"], int(meta["N_train"]), device=device)
    times = make_timesteps(schedule.n_timesteps, args.ddim_steps, args.time_spacing)
    logit_space = bool(meta.get("logit_space", 0))
    kp_feat_dim = int(meta.get("kp_feat_dim", 0)) if meta.get("use_kp_feat") else 0

    @torch.inference_mode()
    def sample(z, idx, cond):
        if kp_feat_dim > 0:
            seg_cost = dphi_fn(cond, idx) if dphi_fn is not None else None
            cond = dict(cond, kp_feat=build_kp_feat_full(idx, T, kp_feat_dim, seg_cost))
        known_mask, known_values = build_known_mask_values(idx, cond, D, T,
                                                           bool(meta["clamp_endpoints"]))
        if logit_space:
            known_values = logit_pos(known_values)
        cond = hoist_cond_vec(model, cond)

        def post(z):
            z = torch.where(known_mask, known_values, z)
            if args.pos_clip:
                z = torch.cat([torch.clamp(z[..., :2], 0.0, 1.0), z[..., 2:]], dim=-1)
            return z

        z = torch.where(known_mask, known_values, z.float())
        if meta.get("objective", "eps") == "rf":
            n_tr = schedule.n_timesteps
            vel = lambda z, t: model(z, (t * (n_tr - 1)).to(torch.int32), idx, known_mask, cond, T)
            z = rf_integrate(vel, z, args.ddim_steps, post=post)
        else:
            eps_fn = lambda z, t_b, **kw: model(z, t_b, idx, known_mask, cond, T, **kw)
            z = run_solver(args.solver, eps_fn, z, times, schedule, post=post)
        if logit_space:
            z = sigmoid_pos(z)
        return z, interpolate_from_indices(idx, z, T)

    return sample


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    model, meta = load_keypoint_model(args.kp_ckpt, bool(args.bf16), bool(args.use_ema),
                                      device=device)
    model.set_attn_policy(args.attn_policy)
    T, K, D = int(meta["T"]), int(meta["K"]), int(meta["data_dim"])
    dphi_fn = None
    if args.dphi_ckpt:
        dphi_fn, _ = make_dphi_seg_cost_fn(args.dphi_ckpt, T, meta.get("use_sdf"),
                                           bool(args.bf16), device=device)
    elif meta.get("kp_feat_dphi"):
        raise ValueError("Stage-1 ckpt was trained with D_phi kp_feat cost channels (meta "
                         "kp_feat_dphi=1): pass --dphi_ckpt, or sampling runs off-distribution "
                         "(channels 3/4 zero)")
    sample = make_sampler(model, meta, args, device, dphi_fn)

    args.T = T  # for make_dataset
    ds, _ = make_dataset(args)
    host_rng = np.random.RandomState(args.sample_seed)
    gen = torch.Generator(device=device).manual_seed(args.sample_seed)
    to_dev = lambda a: torch.as_tensor(a).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    os.makedirs(args.out_dir, exist_ok=True)
    rows = []
    saved = {"keypoints": [], "interp": [], "idx": [], "gt": []}
    for bi in range(args.num_batches):
        batch = ds.get_batch(host_rng.randint(0, len(ds), size=args.batch))
        cond = {"occ": to_dev(batch["occ"]), "start_goal": to_dev(batch["start_goal"])}
        if "sdf" in batch and meta.get("use_sdf"):
            cond["sdf"] = to_dev(batch["sdf"])
        idx = to_dev(sample_idx_policy(host_rng, f"{args.kp_index_mode}:1.0", args.batch,
                                       T, K)).long()
        z0 = torch.randn((args.batch, K, D), generator=gen, device=device)
        sync()
        t0 = time.perf_counter()
        z, x = sample(z0, idx, cond)
        m = compute_metrics_batch(cond["occ"], x, cond["start_goal"][:, 2:], to_dev(batch["x"]))
        m = {k: v.cpu().numpy() for k, v in m.items()}
        dt = time.perf_counter() - t0
        for b in range(args.batch):
            rows.append({"batch": bi, "sample": b, **{k: float(v[b]) for k, v in m.items()}})
        x_np = x.float().cpu().numpy()
        saved["keypoints"].append(z.float().cpu().numpy())
        saved["interp"].append(x_np)
        saved["idx"].append(idx.int().cpu().numpy())
        saved["gt"].append(batch["x"])
        print(f"batch {bi}: {dt:.2f}s coll={m['collision_rate'].mean():.4f} "
              f"mse={m['mse_to_gt'].mean():.5f}", flush=True)
        if bi == 0 and args.plots:
            from ..eval.visualize import save_sample_grid

            save_sample_grid(batch["occ"], {"interp": x_np, "gt": batch["x"]},
                             os.path.join(args.out_dir, "samples.png"),
                             start_goal=batch["start_goal"], max_samples=args.max_plots)
    with open(os.path.join(args.out_dir, "metrics.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    summary = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k not in ("batch", "sample")}
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    from ..utils.run_config import archive_evidence, write_run_config

    write_run_config(args.out_dir, args)
    archive_evidence(args.out_dir)
    np.savez_compressed(os.path.join(args.out_dir, "samples.npz"),
                        **{k: np.concatenate(v) for k, v in saved.items()})
    print("summary:", json.dumps(summary, indent=2), flush=True)
    return summary


if __name__ == "__main__":
    main()
