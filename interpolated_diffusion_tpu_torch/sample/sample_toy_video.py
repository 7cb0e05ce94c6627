"""End-to-end toy-video generation: keypoints -> interpolation -> Stage-2
refinement (port of sample/sample_toy_video.py).

    python -m interpolated_diffusion_tpu_torch.sample.sample_toy_video --kp_ckpt DIR --interp_ckpt DIR [flags]

Conditions on the ground-truth first and last frames: K uniformly spaced
anchor frames (no jitter) are sampled by Stage 1 (ddim, pfdiff or dpm
through ops/ddpm.run_solver, the known frames clamped after every step),
lerped to T frames, and refined by the Stage-2 level loop (nested masks on
top of the anchors; adj mode walks levels .. 1, x0 mode runs the top level
once). The oracle variants lerp and refine the ground-truth anchor frames.
Reports the four MSEs against the ground truth and samples/s (batches after
the first), and writes summary.json, run_config.json and, with
`--decode_panels`, samples.npz (RGB panels of the first four clips).

Every draw is an argument of `make_toy_pipeline`'s pipeline: the Stage-1
noise and the nested masks' uniforms (the anchors are deterministic), so
that a test hands in JAX's. Runs on the GPU unless `--device cpu`; both
denoisers' blocks take the fused block kernel under `--attn_policy block`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..kernels.tuning import add_attn_policy_arg
from ..data.toy_video import MovingShapesVideoDataset, decode_latents
from ..ops.ddpm import make_timesteps, run_solver
from ..ops.keyframes import (build_nested_masks_from_base, interpolate_from_indices,
                             sample_fixed_k_indices_uniform_batch)
from ..ops.schedules import make_schedule
from ..train.batches import gather_keypoints

MSE_NAMES = ("interp", "refined", "oracle_interp", "oracle_refined")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sample_toy_video")
    p.add_argument("--kp_ckpt", type=str, required=True)
    p.add_argument("--interp_ckpt", type=str, required=True)
    p.add_argument("--use_ema", type=int, default=1)
    p.add_argument("--num_batches", type=int, default=2)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--ddim_steps", type=int, default=20)
    p.add_argument("--solver", type=str, default="ddim", choices=["ddim", "pfdiff", "dpm"],
                   help="pfdiff: ~half the Stage-1 model evals; dpm: DPM-Solver++(2M) "
                        "2nd-order accuracy per eval")
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--sample_seed", type=int, default=1234)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--decode_panels", type=int, default=1)
    p.add_argument("--out_dir", type=str, default="runs/samples_toy_video")
    add_attn_policy_arg(p, "both denoisers")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def make_toy_pipeline(kp_model, kp_meta: Dict, il_model, il_meta: Dict, solver: str = "ddim",
                      ddim_steps: int = 20):
    """pipeline(x0 [B, T, D], draws) -> (idx, z_pred, x_interp, x_refined,
    x_oracle_interp, x_oracle_refined). draws: "noise" [B, K, D] standard
    normals (Stage 1's start) and "mask_rand" [B, T] uniforms (the nested
    masks over the anchors, shared by both refinements)."""
    T, K = int(kp_meta["T"]), int(kp_meta["K"])
    levels = int(il_meta["levels"])
    anchor_conf = bool(il_meta.get("anchor_conf", 0))
    mode = il_meta.get("mode", "adj")
    dev = next(kp_model.parameters()).device
    schedule = make_schedule(kp_meta["schedule"], int(kp_meta["N_train"]), device=dev)
    times = make_timesteps(schedule.n_timesteps, ddim_steps, "linear")

    def stage1(noise, idx, x0):
        ends = ((idx == 0) | (idx == T - 1))[..., None]
        known_mask = ends.expand(noise.shape)
        known_values = torch.where(known_mask, gather_keypoints(x0, idx), torch.zeros_like(noise))
        post = lambda z: torch.where(known_mask, known_values, z)
        eps_fn = lambda z, t_b: kp_model(z, t_b, idx, known_mask, {}, T)
        return run_solver(solver, eps_fn, post(noise), times, schedule, post=post)

    def stage2(masks_levels, x):
        B = x.shape[0]
        for s in ([levels] if mode == "x0" else range(levels, 0, -1)):
            mask_s = masks_levels[:, s]
            chans = [mask_s.float()]
            if mode == "adj":
                chans.append(masks_levels[:, s - 1].float())
            if anchor_conf:
                conf = torch.where(mask_s, 0.95, 0.0)
                conf[:, 0] = 1.0
                conf[:, -1] = 1.0
                chans.append(conf)
            mask_in = torch.stack(chans, dim=-1) if len(chans) > 1 else mask_s
            s_level = torch.full((B,), s, dtype=torch.long, device=x.device)
            x = x + il_model(x, s_level, mask_in, {})
        return x

    @torch.no_grad()
    def pipeline(x0: torch.Tensor, draws: Dict[str, torch.Tensor]):
        B = x0.shape[0]
        idx, _ = sample_fixed_k_indices_uniform_batch(B, T, K, jitter=0.0, device=x0.device)
        z_pred = stage1(draws["noise"].to(x0), idx, x0)
        z_oracle = gather_keypoints(x0, idx)
        masks_levels, _ = build_nested_masks_from_base(idx, T, levels,
                                                       rand=draws["mask_rand"].to(x0))
        x_interp = interpolate_from_indices(idx, z_pred, T)
        x_oracle_interp = interpolate_from_indices(idx, z_oracle, T)
        return (idx, z_pred, x_interp, stage2(masks_levels, x_interp), x_oracle_interp,
                stage2(masks_levels, x_oracle_interp))

    return pipeline


def main(argv=None, draws: Optional[Iterable[Dict[str, np.ndarray]]] = None) -> Dict:
    """The summary. `draws` (one {"noise", "mask_rand"} per batch) replaces
    the draws of the CLI's generator, so that a test can hand in JAX's."""
    from ..models.loading import load_toy_video_model
    from ..train.common import resolve_device
    from ..utils.run_config import archive_evidence, write_run_config

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    kp_model, kp_meta = load_toy_video_model(args.kp_ckpt, "keypoints_toy_video",
                                             bool(args.bf16), bool(args.use_ema), device)
    il_model, il_meta = load_toy_video_model(args.interp_ckpt, "interp_levels_toy_video",
                                             bool(args.bf16), bool(args.use_ema), device)
    for m in (kp_model, il_model):
        m.set_attn_policy(args.attn_policy)
    T, K, D = int(kp_meta["T"]), int(kp_meta["K"]), int(kp_meta["data_dim"])
    pipeline = make_toy_pipeline(kp_model, kp_meta, il_model, il_meta, args.solver,
                                 args.ddim_steps)
    ds = MovingShapesVideoDataset(T=T, n_samples=args.num_samples, seed=args.sample_seed + 999,
                                  latent_size=int(kp_meta["latent_size"]))
    host_rng = np.random.RandomState(args.sample_seed)
    gen = torch.Generator(device=device).manual_seed(args.sample_seed)
    draws = iter(draws) if draws is not None else None
    os.makedirs(args.out_dir, exist_ok=True)
    agg = {k: [] for k in MSE_NAMES}
    panels = {}
    t_total, n_total = 0.0, 0
    for bi in range(args.num_batches):
        batch = ds.get_batch(host_rng.randint(0, len(ds), size=args.batch))
        x0 = torch.as_tensor(batch["x"]).to(device)
        if draws is not None:
            d = {k: torch.tensor(np.asarray(v)).to(device) for k, v in next(draws).items()}
        else:
            d = {"noise": torch.randn((args.batch, K, D), generator=gen, device=device),
                 "mask_rand": torch.rand((args.batch, T), generator=gen, device=device)}
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, z_pred, x_i, x_r, xo_i, xo_r = pipeline(x0, d)
        mses = [((a - x0) ** 2).mean(dim=(1, 2)).cpu().numpy()    # waits for the device
                for a in (x_i, x_r, xo_i, xo_r)]
        dt = time.perf_counter() - t0
        if bi > 0:
            t_total += dt
            n_total += args.batch
        for name, m in zip(MSE_NAMES, mses):
            agg[name].append(m)
        if bi == 0 and args.decode_panels:
            panels = {"gt": decode_latents(batch["x"][:4]),
                      "refined": decode_latents(x_r[:4].cpu().numpy()),
                      "interp": decode_latents(x_i[:4].cpu().numpy())}
        print(f"batch {bi}: {dt:.3f}s mse(interp)={float(np.mean(agg['interp'][-1])):.5f} "
              f"mse(refined)={float(np.mean(agg['refined'][-1])):.5f}", flush=True)

    summary = {f"{k}_mse_to_gt": float(np.mean(np.concatenate(v))) for k, v in agg.items()}
    if n_total:
        summary["samples_per_sec"] = n_total / t_total
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    write_run_config(args.out_dir, args)
    archive_evidence(args.out_dir)
    if panels:
        np.savez_compressed(os.path.join(args.out_dir, "samples.npz"), **panels)
    print("summary:", json.dumps(summary, indent=2), flush=True)
    return summary


if __name__ == "__main__":
    main()
