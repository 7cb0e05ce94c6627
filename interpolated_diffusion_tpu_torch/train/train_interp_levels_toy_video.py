"""Stage-2 interp-level denoiser on toy video latents (port of
train/train_interp_levels_toy_video.py).

    python -m interpolated_diffusion_tpu_torch.train.train_interp_levels_toy_video [flags]

adj (target z_prev - z_s) or x0 (target z0 - z_s) refinement over flat
frame latents, corrupted by the video batch builders
(ops/video_keyframes.build_video_interp_{adjacent,level}_batch: student
anchor replacement, Gaussian or distance-scaled noise, per-frame
confidence), with the confidence as an input channel (`--anchor_conf 1`)
and the loss weight w_missing + (w_anchor - w_missing) * confidence (or the
mask's 0/1 weight without it). The denoiser is the maze InterpLevelDenoiser
without the maze encoder; under `--attn_policy block` its blocks take the
fused block kernel at [B, T, d_model]. Runs on the GPU unless `--device cpu`.

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
"""
from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from ..models.denoisers import InterpLevelDenoiser
from ..ops.video_keyframes import (Draws, build_video_interp_adjacent_batch,
                                   build_video_interp_level_batch, make_video_interp_draws)
from ..parallel.mesh import dp_sum
from .common import build_seeded, data_mesh, model_params
from .state import TrainState, init_train_state, make_optimizer, make_train_step
from .train_keypoints_toy_video import add_toy_train_args, run


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_interp_levels_toy_video (Stage-2)")
    p.add_argument("--T", type=int, default=16)
    p.add_argument("--K_min", type=int, default=4)
    p.add_argument("--levels", type=int, default=2)
    p.add_argument("--mode", type=str, default="adj", choices=["adj", "x0"])
    p.add_argument("--latent_size", type=int, default=16)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--anchor_conf", type=int, default=1)
    p.add_argument("--interp_mode", type=str, default="linear", choices=["linear", "smooth"])
    p.add_argument("--corrupt_mode", type=str, default="gauss", choices=["none", "gauss", "dist"])
    p.add_argument("--corrupt_sigma", type=float, default=0.02)
    p.add_argument("--anchor_noise_frac", type=float, default=0.25)
    p.add_argument("--student_replace_prob", type=float, default=0.5)
    p.add_argument("--student_noise_std", type=float, default=0.02)
    p.add_argument("--w_anchor", type=float, default=1.0)
    p.add_argument("--w_missing", type=float, default=1.0)
    add_toy_train_args(p, "runs/il_toy_video")
    return p


def mask_channels_for(args) -> int:
    return (2 if args.mode == "adj" else 1) + (1 if args.anchor_conf else 0)


def make_meta(args, data_dim: int) -> Dict:
    return {"stage": "interp_levels_toy_video", "T": args.T, "K_min": args.K_min,
            "levels": args.levels, "mode": args.mode, "latent_size": args.latent_size,
            "d_model": args.d_model, "n_layers": args.n_layers, "n_heads": args.n_heads,
            "d_ff": args.d_ff, "mask_channels": mask_channels_for(args),
            "anchor_conf": args.anchor_conf, "interp_mode": args.interp_mode,
            "data_dim": data_dim}


def build_model(args, data_dim: int, device: torch.device) -> InterpLevelDenoiser:
    return build_seeded(InterpLevelDenoiser, args, device, d_model=args.d_model,
                        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
                        data_dim=data_dim, use_start_goal=False, maze_cond=False,
                        max_levels=max(8, args.levels), mask_channels=mask_channels_for(args),
                        attn_policy=args.attn_policy)


def corruption_kwargs(args) -> Dict:
    return dict(corrupt_mode=args.corrupt_mode, corrupt_sigma=args.corrupt_sigma,
                anchor_noise_frac=args.anchor_noise_frac,
                student_replace_prob=args.student_replace_prob,
                student_noise_std=args.student_noise_std, interp_mode=args.interp_mode)


def interp_loss(model: InterpLevelDenoiser, args, batch: Dict[str, torch.Tensor],
                rng: Union[torch.Generator, Draws]):
    """Weighted refinement MSE of one batch (x [B, T, D]); `rng` is a
    generator or the dict of ops/video_keyframes.make_video_interp_draws, so
    that a test can hand in JAX's draws."""
    z0 = batch["x"].float()
    B, T, D = z0.shape
    draws = rng if isinstance(rng, dict) else make_video_interp_draws(
        rng, B, T, D, args.K_min, args.levels, adjacent=args.mode == "adj")
    corr = corruption_kwargs(args)
    if args.mode == "adj":
        (z_s, z_prev, mask_s, mask_prev, s_idx, _, _, conf_s,
         conf_prev) = build_video_interp_adjacent_batch(draws, z0, args.K_min, args.levels,
                                                        **corr)
        target = z_prev - z_s
        chans = [mask_s.float(), mask_prev.float()]
        weight = conf_prev if args.anchor_conf else mask_prev.float()
    else:
        z_s, mask_s, s_idx, _, _, conf_s = build_video_interp_level_batch(
            draws, z0, args.K_min, args.levels, **corr)
        target = z0 - z_s
        chans = [mask_s.float()]
        weight = conf_s if args.anchor_conf else mask_s.float()
    if args.anchor_conf:
        chans.append(conf_s)
    mask_in = torch.stack(chans, dim=-1) if len(chans) > 1 else mask_s
    delta_hat = model(z_s, s_idx, mask_in, {})
    diff = ((delta_hat - target) ** 2).sum(dim=-1)
    if args.anchor_conf:
        w = args.w_missing + (args.w_anchor - args.w_missing) * weight
    else:
        w = torch.where(weight > 0.5, args.w_anchor, args.w_missing)
    return dp_sum((diff * w).sum()) / (dp_sum(w.sum()) * D + 1e-8), {}


def make_trainer(args, device: torch.device, data_dim: int, model=None):
    """(state, train_step, model), as train_keypoints_toy_video.make_trainer."""
    if model is None:
        model = build_model(args, data_dim, device)
    loss_fn = lambda params, batch, rng: interp_loss(model, args, batch, rng)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(model_params(model), tx, use_ema=bool(args.use_ema))
    return state, make_train_step(loss_fn, args.ema_decay, args.grad_accum,
                                  mesh=data_mesh(args)), model


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    return run(args, make_meta(args, 3 * args.latent_size ** 2), make_trainer)


if __name__ == "__main__":
    main()
