"""Keypoint selector trainer, BCE against DP labels (port of
train/train_keypoint_selector.py).

    python -m interpolated_diffusion_tpu_torch.train.train_keypoint_selector \
        --dataset prepared --prepared_path dp.npz [flags]

Per-frame BCE of the selector's logits against the DP keypoint labels of a
prepared dataset (data/prepare_dp_keypoints.py): `kp_mask_levels` (a random
level per sample, with level conditioning k_norm / s_norm) or `kp_idx`;
positive-class weight (T - K_s) / K_s; an optional KL-to-uniform term on the
tempered interior logits, the temperature annealed per step (`anneal_tau`).
AdamW behind a global-norm clip, no EMA (train/state.py). The model holds
f32 master parameters and computes in bf16 (`--bf16 1`). Runs on the GPU
unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict

import numpy as np
import torch

from ..models.selector import KeypointSelector
from ..ops.keyframes import compute_k_schedule
from .batches import Rng, draw
from .common import (add_data_args, add_train_args, build_seeded, check_train_args_ported,
                     make_dataset, make_loader, model_params, resolve_device, resume_state,
                     run_training)
from .state import TrainState, init_train_state, make_optimizer, make_train_multi_step


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_keypoint_selector")
    p.add_argument("--T", type=int, default=64)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=512)
    p.add_argument("--n_layers_sel", type=int, default=2)
    p.add_argument("--pos_dim", type=int, default=64)
    p.add_argument("--maze_channels", type=str, default="32,64,128,128")
    p.add_argument("--cond_start_goal", type=int, default=1)
    p.add_argument("--use_sg_map", type=int, default=1)
    p.add_argument("--use_sg_token", type=int, default=1)
    p.add_argument("--use_goal_dist_token", type=int, default=0)
    p.add_argument("--use_cond_bias", type=int, default=0)
    p.add_argument("--cond_bias_mode", type=str, default="memory", choices=["memory", "encoder"])
    p.add_argument("--use_level", type=int, default=0)
    p.add_argument("--level_mode", type=str, default="k_norm", choices=["k_norm", "s_norm"])
    p.add_argument("--levels", type=int, default=8)
    p.add_argument("--k_schedule", type=str, default="geom",
                   choices=["doubling", "linear", "geom"])
    p.add_argument("--k_geom_gamma", type=float, default=None)
    p.add_argument("--sg_map_sigma", type=float, default=1.5)
    p.add_argument("--sel_kl_weight", type=float, default=0.02)
    p.add_argument("--sel_tau_start", type=float, default=1.0)
    p.add_argument("--sel_tau_end", type=float, default=0.3)
    p.add_argument("--sel_tau_anneal", type=str, default="cosine",
                   choices=["none", "linear", "cosine"])
    p.add_argument("--sel_tau_frac", type=float, default=0.8)
    add_data_args(p)
    add_train_args(p)
    return p


def anneal_tau(step: int, total: int, start: float, end: float, frac: float, mode: str) -> float:
    if mode == "none":
        return start
    horizon = max(1, int(total * max(0.0, min(1.0, frac))))
    t = min(step / horizon, 1.0)
    if mode == "linear":
        return start + (end - start) * t
    if mode == "cosine":
        return end + (start - end) * 0.5 * (1.0 + math.cos(math.pi * t))
    return start


def make_meta(args) -> Dict:
    return {
        "stage": "selector", "T": args.T, "K": args.K,
        "d_model": args.d_model, "n_heads": args.n_heads, "d_ff": args.d_ff,
        "pos_dim": args.pos_dim, "n_layers": args.n_layers_sel,
        "use_sdf": args.use_sdf, "cond_start_goal": args.cond_start_goal,
        "use_sg_map": args.use_sg_map, "use_sg_token": args.use_sg_token,
        "use_goal_dist_token": args.use_goal_dist_token,
        "use_cond_bias": args.use_cond_bias, "cond_bias_mode": args.cond_bias_mode,
        "use_level": args.use_level, "level_mode": args.level_mode,
        "levels": args.levels, "k_schedule": args.k_schedule,
        "k_geom_gamma": args.k_geom_gamma, "sg_map_sigma": args.sg_map_sigma,
        "maze_channels": args.maze_channels,
        "maze_h": args.maze_h, "maze_w": args.maze_w,
    }


def build_model(args, device: torch.device) -> KeypointSelector:
    """The selector with f32 masters from --seed, bf16 compute under --bf16."""
    return build_seeded(
        KeypointSelector, args, device, T=args.T, d_model=args.d_model, n_heads=args.n_heads,
        d_ff=args.d_ff, n_layers=args.n_layers_sel, pos_dim=args.pos_dim,
        use_sdf=bool(args.use_sdf), use_start_goal=bool(args.cond_start_goal),
        use_sg_map=bool(args.use_sg_map), use_sg_token=bool(args.use_sg_token),
        use_goal_dist_token=bool(args.use_goal_dist_token),
        use_cond_bias=bool(args.use_cond_bias), cond_bias_mode=args.cond_bias_mode,
        use_level=bool(args.use_level), sg_map_sigma=args.sg_map_sigma,
        maze_channels=tuple(int(c) for c in args.maze_channels.split(",")))


def make_loss_fn(model: KeypointSelector, args, has_levels: bool):
    """loss_fn(params, batch, rng) -> (loss, {"kl"?}); batch: occ, start_goal,
    [sdf], kp_mask_levels or kp_idx, and the scalar temperature `tau`.
    Draw (per-level labels only): "s_idx" randint [B] in [1, levels]."""
    k_list = compute_k_schedule(args.T, args.K, args.levels, args.k_schedule, args.k_geom_gamma)

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng: Rng):
        cond = {"occ": batch["occ"], "start_goal": batch["start_goal"]}
        if "sdf" in batch:
            cond["sdf"] = batch["sdf"]
        B, dev = batch["occ"].shape[0], batch["occ"].device
        if has_levels:
            s_idx = draw(rng, "s_idx", "randint", (B,), 1, args.levels + 1).to(dev).long()
            masks = batch["kp_mask_levels"].float()
            target = torch.gather(masks, 1, s_idx[:, None, None].expand(B, 1, masks.shape[2]))[:, 0]
            K_s = torch.as_tensor(k_list, dtype=torch.float32, device=dev)[s_idx]
            if args.use_level:
                lv = (s_idx.float() / max(1, args.levels) if args.level_mode == "s_norm"
                      else K_s / max(1, args.T - 1))
                cond["level"] = lv[:, None]
        else:
            kp_idx = batch["kp_idx"].long()
            target = torch.zeros((B, args.T), device=dev).scatter(1, kp_idx, 1.0)
            K_s = torch.full((B,), float(args.K), device=dev)
            if args.use_level:
                lv = (torch.ones((B,), device=dev) if args.level_mode == "s_norm"
                      else torch.full((B,), args.K / max(1, args.T - 1), device=dev))
                cond["level"] = lv[:, None]

        logits = model(cond)
        # BCE with logits, positives weighted (T - K_s) / K_s per sample
        bce = (torch.clamp(logits, min=0) - logits * target
               + torch.log1p(torch.exp(-torch.abs(logits))))
        pos_w = (args.T - K_s) / torch.clamp(K_s, min=1.0)
        w = 1.0 + (pos_w[:, None] - 1.0) * target
        loss = (bce * w).mean()
        aux = {}
        if args.sel_kl_weight > 0.0:
            li = logits[:, 1:-1] / torch.clamp(batch["tau"].float(), min=1e-6)
            logp = torch.log_softmax(li, dim=-1)
            kl = (torch.exp(logp) * (logp + math.log(max(1, args.T - 2)))).sum(-1).mean()
            loss = loss + args.sel_kl_weight * kl
            aux["kl"] = kl.detach()
        return loss, aux

    return loss_fn


def make_trainer(args, device: torch.device, has_levels: bool, model=None):
    """(state, train_step, model)."""
    if model is None:
        model = build_model(args, device)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(model_params(model), tx, use_ema=False)
    train_step = make_train_multi_step(make_loss_fn(model, args, has_levels), args.ema_decay,
                                       args.grad_accum, max(1, args.steps_per_call))
    return state, train_step, model


def host_batch(args, batch: Dict[str, np.ndarray], step: int,
               has_levels: bool) -> Dict[str, np.ndarray]:
    """What one step takes from a loader batch, with this step's temperature."""
    out = {"occ": batch["occ"], "start_goal": batch["start_goal"]}
    if "sdf" in batch and args.use_sdf:
        out["sdf"] = batch["sdf"]
    if has_levels:
        out["kp_mask_levels"] = batch["kp_mask_levels"]
    else:
        out["kp_idx"] = batch["kp_idx"]
    out["tau"] = np.float32(anneal_tau(step, args.steps, args.sel_tau_start, args.sel_tau_end,
                                       args.sel_tau_frac, args.sel_tau_anneal))
    return out


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    check_train_args_ported(args)
    device = resolve_device(args.device)
    ds, _ = make_dataset(args)
    loader = iter(make_loader(ds, args))
    first = next(loader)
    if "kp_idx" not in first and "kp_mask_levels" not in first:
        raise ValueError("selector training needs kp_idx or kp_mask_levels in the dataset "
                         "(run data/prepare_dp_keypoints.py)")
    has_levels = "kp_mask_levels" in first
    state, train_step, model = make_trainer(args, device, has_levels)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.3f}M | device: {device}", flush=True)
    start_step = 0
    if args.resume:
        state, start_step = resume_state(state, args.resume, device)
    meta = make_meta(args)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "run_config.json"), "w") as f:
        json.dump({"args": vars(args), "meta": meta}, f, indent=2)
    return run_training(args, device, loader, first, state, train_step,
                        lambda b, step: host_batch(args, b, step, has_levels), meta, start_step)


if __name__ == "__main__":
    main()
