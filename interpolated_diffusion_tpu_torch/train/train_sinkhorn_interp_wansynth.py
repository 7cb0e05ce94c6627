"""Sinkhorn warp interpolator trainer on wansynth latents (port of
train/train_sinkhorn_interp_wansynth.py).

    python -m interpolated_diffusion_tpu_torch.train.train_sinkhorn_interp_wansynth [flags]

Trains the matcher's learnable temperature and dustbin end to end through
the warp: K fixed anchors per clip (endpoints forced, the interior drawn),
the MSE over the hidden frames. Every --val_every steps the interpolator
and plain lerp are scored on --val_batches fresh batches
(`[val] sinkhorn X vs lerp Y`). AdamW behind a global-norm clip, no EMA.
Runs on the GPU unless `--device cpu`; `--n_data_shards` is not ported and
raises.
"""
from __future__ import annotations

import argparse
from typing import Dict, Union

import numpy as np
import torch

from ..models.sinkhorn_warp import SinkhornWarpInterpolator
from ..ops.keyframes import interpolate_from_indices, sample_fixed_k_indices_batch
from .common import build_seeded
from .interp_common import Draws, add_interp_train_args, draws_or, make_state, setup, \
    train_loop
from .state import TrainState


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_sinkhorn_interp_wansynth")
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--sinkhorn_patch", type=int, default=4)
    p.add_argument("--win_size", type=int, default=5)
    p.add_argument("--sinkhorn_iters", type=int, default=20)
    p.add_argument("--sinkhorn_tau", type=float, default=0.05)
    p.add_argument("--dustbin_logit", type=float, default=-2.0)
    p.add_argument("--learn_tau", type=int, default=1)
    p.add_argument("--learn_dustbin", type=int, default=1)
    p.add_argument("--fb_sigma", type=float, default=2.0)
    p.add_argument("--d_match", type=int, default=0)
    p.add_argument("--global_mode", type=str, default="phasecorr",
                   choices=["phasecorr", "none"])
    p.add_argument("--val_every", type=int, default=500)
    p.add_argument("--val_batches", type=int, default=4)
    add_interp_train_args(p, batch=4, steps=2000, lr=1e-3, weight_decay=0.0, bf16=0,
                          out_dir="runs/sinkhorn_interp", save_every=1000)
    return p


def make_index_draws(generator: torch.Generator, B: int, T: int) -> Draws:
    """The uniforms whose K - 2 lowest pick the interior anchors."""
    return {"idx_rand": torch.rand((B, T - 2), generator=generator, device=generator.device)}


def build_model(args, device: torch.device) -> SinkhornWarpInterpolator:
    return build_seeded(SinkhornWarpInterpolator, args, device, in_channels=args.latent_c,
                        patch_size=args.sinkhorn_patch, win_size=args.win_size,
                        global_mode=args.global_mode, sinkhorn_iters=args.sinkhorn_iters,
                        sinkhorn_tau=args.sinkhorn_tau, dustbin_logit=args.dustbin_logit,
                        learn_tau=bool(args.learn_tau), learn_dustbin=bool(args.learn_dustbin),
                        fb_sigma=args.fb_sigma, d_match=args.d_match)


def lerp_baseline(latents: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Segment lerp of latents [B, T, ...] between the anchors idx [B, K]."""
    B, T = latents.shape[:2]
    flat = latents.reshape(B, T, -1)
    vals = torch.gather(flat, 1, idx.long()[..., None].expand(-1, -1, flat.shape[-1]))
    return interpolate_from_indices(idx, vals, T).reshape(latents.shape)


def make_loss_fn(model: SinkhornWarpInterpolator, args):
    """loss_fn(params, batch, rng) -> (loss, {}): the MSE of the hidden
    frames; rng is a torch.Generator or the draws of `make_index_draws`."""

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng: Union[torch.Generator, Draws]):
        latents = batch["latents"].float()
        B, T, C, H, W = latents.shape
        draws = draws_or(rng, lambda g: make_index_draws(g, B, T))
        idx, mask = sample_fixed_k_indices_batch(B, T, args.K, rand=draws["idx_rand"])
        out, _ = model(latents, idx)
        hidden = (~mask)[..., None, None, None].float()
        loss = (((out - latents) ** 2) * hidden).sum() / (hidden.sum() * C * H * W + 1e-8)
        return loss, {}

    return loss_fn


def run_meta(args) -> Dict:
    return {"stage": "sinkhorn_interp", "in_channels": args.latent_c,
            "patch_size": args.sinkhorn_patch, "win_size": args.win_size,
            "sinkhorn_iters": args.sinkhorn_iters, "global_mode": args.global_mode,
            "sinkhorn_tau": args.sinkhorn_tau, "dustbin_logit": args.dustbin_logit,
            "learn_tau": args.learn_tau, "learn_dustbin": args.learn_dustbin,
            "fb_sigma": args.fb_sigma, "d_match": args.d_match}


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device, loader, batch0 = setup(args)
    model = build_model(args, device)
    state, train_step = make_state(model, args, make_loss_fn(model, args))
    val_gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    @torch.no_grad()
    def validate(step, state, batch):
        if not args.val_every or (step + 1) % args.val_every:
            return
        mses, lerps = [], []
        for _ in range(args.val_batches):
            lat = torch.as_tensor(next(loader)["latents"]).to(device).float()
            idx, _ = sample_fixed_k_indices_batch(lat.shape[0], args.T, args.K,
                                                  generator=val_gen)
            out, _ = model(lat, idx)
            mses.append(float(((out - lat) ** 2).mean()))
            lerps.append(float(((lerp_baseline(lat, idx) - lat) ** 2).mean()))
        print(f"[val] sinkhorn {np.mean(mses):.5f} vs lerp {np.mean(lerps):.5f}", flush=True)

    return train_loop(args, device, loader, batch0, state, train_step, ("latents",),
                      run_meta(args), prefetch=False, after_step=validate)


if __name__ == "__main__":
    main()
