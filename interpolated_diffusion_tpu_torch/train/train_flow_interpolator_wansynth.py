"""Latent flow interpolator trainer on wansynth latents (port of
train/train_flow_interpolator_wansynth.py).

    python -m interpolated_diffusion_tpu_torch.train.train_flow_interpolator_wansynth [flags]

Triplets (an anchor pair t0 < t1 = t0 + gap and its midpoint frame) are
drawn per sample; the interpolator is trained end to end through the warp
on the L1 reconstruction of the midpoint (optionally weighted by the gap),
an uncertainty head regressed onto the clipped per-pixel error, and the
optional edge-gradient, multi-scale L1 and flow-smoothness terms. AdamW
behind a global-norm clip, no EMA. Runs on the GPU unless `--device cpu`;
`--n_data_shards` is not ported and raises.
"""
from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from ..models.flow_interpolator import LatentFlowInterpolator
from ..ops.image import avg_pool2d
from .common import build_seeded
from .interp_common import (Draws, add_interp_train_args, draws_or, make_state,
                            make_triplet_draws, setup, take_triplets, train_loop)
from .state import TrainState


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_flow_interpolator_wansynth")
    p.add_argument("--base_channels", type=int, default=32)
    p.add_argument("--max_flow", type=float, default=20.0)
    p.add_argument("--residual_blocks", type=int, default=2)
    p.add_argument("--time_mask", type=int, default=1)
    p.add_argument("--gap_cond", type=int, default=1)
    p.add_argument("--cost_volume", type=int, default=1)
    p.add_argument("--cv_radius", type=int, default=2)
    p.add_argument("--min_gap", type=int, default=2)
    p.add_argument("--uncertainty_loss_weight", type=float, default=0.1)
    p.add_argument("--edge_weight", type=float, default=0.0)
    p.add_argument("--ms_weight", type=float, default=0.0)
    p.add_argument("--flow_smooth_weight", type=float, default=0.0)
    p.add_argument("--gap_weighting", type=int, default=0)
    add_interp_train_args(p, batch=8, steps=10000, lr=2e-4, weight_decay=1e-2, bf16=1,
                          out_dir="runs/flow_interp", save_every=2000)
    return p


def _gradient_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between the spatial gradients' magnitudes (edge preservation)."""
    dpx = torch.abs(torch.diff(pred, dim=-1)) - torch.abs(torch.diff(target, dim=-1))
    dpy = torch.abs(torch.diff(pred, dim=-2)) - torch.abs(torch.diff(target, dim=-2))
    return torch.abs(dpx).mean() + torch.abs(dpy).mean()


def _flow_smoothness(flow: torch.Tensor) -> torch.Tensor:
    return torch.abs(torch.diff(flow, dim=-1)).mean() + torch.abs(torch.diff(flow, dim=-2)).mean()


def build_model(args, device: torch.device) -> LatentFlowInterpolator:
    return build_seeded(LatentFlowInterpolator, args, device, in_channels=args.latent_c,
                        base_channels=args.base_channels, max_flow=args.max_flow,
                        residual_blocks=args.residual_blocks, time_mask=bool(args.time_mask),
                        gap_cond=bool(args.gap_cond), use_cost_volume=bool(args.cost_volume),
                        cv_radius=args.cv_radius)


def make_loss_fn(model: LatentFlowInterpolator, args):
    """loss_fn(params, batch, rng) -> (loss, {"recon"}); rng is a
    torch.Generator or the draws of `make_triplet_draws`."""

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng: Union[torch.Generator, Draws]):
        latents = batch["latents"].float()                       # [B, T, C, H, W]
        B, T = latents.shape[:2]
        draws = draws_or(rng, lambda g: make_triplet_draws(g, B, T, args.min_gap))
        z0, z1, zt, alpha, gap = take_triplets(latents, draws)
        gap_in = gap if args.gap_cond else None
        z_hat, unc = model.interpolate_pair(z0, z1, alpha, gap=gap_in)
        err = torch.abs(z_hat - zt)
        err_per = err.mean(dim=(1, 2, 3))
        recon = (err_per * (gap / gap.mean())).mean() if args.gap_weighting else err_per.mean()
        # uncertainty regressed onto the clipped per-pixel error
        u_target = torch.clamp(err.mean(dim=1, keepdim=True), 0.0, 1.0).detach()
        loss = recon + args.uncertainty_loss_weight * torch.abs(unc - u_target).mean()
        if args.edge_weight > 0:
            loss = loss + args.edge_weight * _gradient_loss(z_hat, zt)
        if args.ms_weight > 0:
            loss = loss + args.ms_weight * torch.abs(avg_pool2d(z_hat, 2)
                                                     - avg_pool2d(zt, 2)).mean()
        if args.flow_smooth_weight > 0:
            flow01, flow10, *_ = model.predict_flow(z0, z1, gap=gap_in)
            loss = loss + args.flow_smooth_weight * (_flow_smoothness(flow01)
                                                     + _flow_smoothness(flow10))
        return loss, {"recon": recon.detach()}

    return loss_fn


def run_meta(args) -> Dict:
    return {"stage": "flow_interpolator", "in_channels": args.latent_c,
            "base_channels": args.base_channels, "max_flow": args.max_flow,
            "residual_blocks": args.residual_blocks, "time_mask": args.time_mask,
            "gap_cond": args.gap_cond, "cost_volume": args.cost_volume,
            "cv_radius": args.cv_radius}


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device, loader, batch0 = setup(args)
    model = build_model(args, device)
    print(f"flow interp params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
          f"| device: {device}", flush=True)
    state, train_step = make_state(model, args, make_loss_fn(model, args))
    return train_loop(args, device, loader, batch0, state, train_step, ("latents",),
                      run_meta(args), log_keys=("recon",))


if __name__ == "__main__":
    main()
