"""Latent straightener trainer on wansynth latents (port of
train/train_latent_straightener_wansynth.py).

    python -m interpolated_diffusion_tpu_torch.train.train_latent_straightener_wansynth [flags]

A linearity loss (the decoded lerp of two encoded anchors must reconstruct
their midpoint frame), a reconstruction (autoencoding) loss and an isotropy
regulariser on the straightened channel covariance; `--arch conv` or
`token`, `--loss_type l2` or `l1`. Triplet draws as the flow trainer's.
AdamW behind a global-norm clip, no EMA. Runs on the GPU unless `--device
cpu`; `--n_data_shards` is not ported and raises.
"""
from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from ..models.straightener import LatentStraightener, LatentStraightenerTokenTransformer
from .common import build_seeded
from .interp_common import (Draws, add_interp_train_args, draws_or, make_state,
                            make_triplet_draws, setup, take_triplets, train_loop)
from .state import TrainState


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_latent_straightener_wansynth")
    p.add_argument("--arch", type=str, default="conv", choices=["conv", "token"])
    p.add_argument("--hidden_channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--token_patch", type=int, default=4)
    p.add_argument("--token_d_model", type=int, default=256)
    p.add_argument("--token_layers", type=int, default=4)
    p.add_argument("--min_gap", type=int, default=2)
    p.add_argument("--w_linear", type=float, default=1.0)
    p.add_argument("--w_recon", type=float, default=1.0)
    p.add_argument("--w_iso", type=float, default=0.01)
    p.add_argument("--loss_type", type=str, default="l2", choices=["l1", "l2"])
    add_interp_train_args(p, batch=8, steps=10000, lr=2e-4, weight_decay=1e-2, bf16=1,
                          out_dir="runs/straightener", save_every=2000)
    return p


def _err(pred: torch.Tensor, target: torch.Tensor, loss_type: str) -> torch.Tensor:
    d = pred - target
    return (d * d).mean() if loss_type == "l2" else torch.abs(d).mean()


def iso_loss(s: torch.Tensor) -> torch.Tensor:
    """Squared distance of the channel covariance from (its mean variance) * I."""
    C = s.shape[1]
    flat = s.transpose(0, 1).reshape(C, -1).float()
    flat = flat - flat.mean(dim=1, keepdim=True)
    cov = (flat @ flat.t()) / max(flat.shape[1] - 1, 1)
    target = torch.eye(C, device=s.device) * torch.diagonal(cov).mean()
    return ((cov - target) ** 2).mean()


def build_model(args, device: torch.device):
    if args.arch == "conv":
        return build_seeded(LatentStraightener, args, device, in_channels=args.latent_c,
                            hidden_channels=args.hidden_channels, blocks=args.blocks)
    return build_seeded(LatentStraightenerTokenTransformer, args, device,
                        in_channels=args.latent_c, patch_size=args.token_patch,
                        d_model=args.token_d_model, n_layers=args.token_layers)


def make_loss_fn(model, args):
    """loss_fn(params, batch, rng) -> (loss, {"lin", "recon", "iso"}); rng is
    a torch.Generator or the draws of `make_triplet_draws`."""

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng: Union[torch.Generator, Draws]):
        latents = batch["latents"].float()
        B, T = latents.shape[:2]
        draws = draws_or(rng, lambda g: make_triplet_draws(g, B, T, args.min_gap))
        z0, z1, zt, alpha, _ = take_triplets(latents, draws)
        z_hat, s_mid = model.interpolate_pair(z0, z1, alpha)
        lin = _err(z_hat, zt, args.loss_type)
        recon = _err(model(zt), zt, args.loss_type)
        iso = iso_loss(s_mid)
        loss = args.w_linear * lin + args.w_recon * recon + args.w_iso * iso
        return loss, {"lin": lin.detach(), "recon": recon.detach(), "iso": iso.detach()}

    return loss_fn


def run_meta(args) -> Dict:
    return {"stage": "straightener", "arch": args.arch, "in_channels": args.latent_c,
            "hidden_channels": args.hidden_channels, "blocks": args.blocks,
            "token_patch": args.token_patch, "token_d_model": args.token_d_model,
            "token_layers": args.token_layers}


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device, loader, batch0 = setup(args)
    model = build_model(args, device)
    state, train_step = make_state(model, args, make_loss_fn(model, args))
    return train_loop(args, device, loader, batch0, state, train_step, ("latents",),
                      run_meta(args), log_keys=("lin", "recon"))


if __name__ == "__main__":
    main()
