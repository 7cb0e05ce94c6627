"""Video D_phi trainer on wansynth latents: text-conditioned segment-cost
regression (port of train/train_segment_cost_wansynth.py).

    python -m interpolated_diffusion_tpu_torch.train.train_segment_cost_wansynth [flags]

The targets are the exact latent-MSE oracle costs of every segment (i, j)
of the clip, computed on the fly (ops/oracle_segment_cost.py), normalised
by the first batch's mean and std (`--normalize_targets`); the predictor
maps the pooled text embedding and the segment's [i, j, gap] / (T - 1) to
a cost. As in the JAX trainer the model computes in f32 whatever `--bf16`
says (its class fixes the dtype). AdamW behind a global-norm clip, no EMA.
Runs on the GPU unless `--device cpu`; `--n_data_shards` is not ported and
raises.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..models.encoders import TextConditionEncoder
from ..models.init import build_model as build_seeded_model
from ..models.transformer import Linear
from ..ops.oracle_segment_cost import (OracleSegPrecompute, build_oracle_seg_precompute,
                                       compute_oracle_cost_seg_mse)
from ..ops.selection import build_segment_features
from .interp_common import add_interp_train_args, make_state, setup, train_loop
from .state import TrainState


class VideoSegmentCostPredictor(nn.Module):
    """Text condition vector + [i/(T-1), j/(T-1), gap/(T-1)] -> a scalar
    cost per segment ([B, S], f32). Module names are the flax names."""

    def __init__(self, text_dim: int, d_cond: int = 256, hidden_dim: int = 256,
                 n_layers: int = 3, seg_feat_dim: int = 3):
        super().__init__()
        self.d_cond, self.n_hidden = d_cond, max(1, n_layers - 1)
        self.text_enc = TextConditionEncoder(text_dim, d_cond)
        for i in range(self.n_hidden):
            setattr(self, f"fc_{i}", Linear(d_cond + seg_feat_dim if i == 0 else hidden_dim,
                                            hidden_dim))
        self.out = Linear(hidden_dim, 1)

    def forward(self, cond: Dict[str, torch.Tensor], seg_feat: torch.Tensor) -> torch.Tensor:
        cond_vec = self.text_enc(cond)
        B = cond_vec.shape[0]
        if seg_feat.ndim == 2:
            seg_feat = seg_feat[None].expand(B, *seg_feat.shape)
        x = torch.cat([cond_vec[:, None].expand(B, seg_feat.shape[1], self.d_cond),
                       seg_feat.to(cond_vec.dtype)], dim=-1)
        for i in range(self.n_hidden):
            x = F.silu(getattr(self, f"fc_{i}")(x))
        return self.out(x)[..., 0].float()


def segment_cost_from_meta(meta) -> VideoSegmentCostPredictor:
    """The predictor a segment_cost_wansynth checkpoint's meta describes."""
    return VideoSegmentCostPredictor(text_dim=int(meta["text_dim"]), d_cond=int(meta["d_cond"]),
                                     hidden_dim=int(meta["hidden_dim"]),
                                     n_layers=int(meta["n_layers"]))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_segment_cost_wansynth")
    p.add_argument("--d_cond", type=int, default=256)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--n_mlp_layers", type=int, default=3)
    p.add_argument("--normalize_targets", type=int, default=1)
    add_interp_train_args(p, batch=8, steps=5000, lr=2e-4, weight_decay=1e-2, bf16=0,
                          out_dir="runs/segcost_wansynth", save_every=2000)
    return p


class Targets:
    """The oracle segment costs of a batch of clips, normalised by the
    statistics of the first batch (population std, floored at 1e-6)."""

    def __init__(self, args, batch0: Dict, device: torch.device):
        self.T = args.T
        self.pre = OracleSegPrecompute(*(t.to(device)
                                         for t in build_oracle_seg_precompute(args.T)))
        self.seg_feat = build_segment_features(args.T, self.pre.seg_i, self.pre.seg_j)
        self.mean, self.std = 0.0, 1.0
        if args.normalize_targets:
            lat = torch.tensor(batch0["latents"]).to(device)
            stats = compute_oracle_cost_seg_mse(lat.reshape(lat.shape[0], args.T, -1), self.pre)
            self.mean = float(stats.mean())
            self.std = max(1e-6, float(stats.std(correction=0)))

    def __call__(self, latents: torch.Tensor) -> torch.Tensor:
        cost = compute_oracle_cost_seg_mse(latents.reshape(latents.shape[0], self.T, -1),
                                           self.pre)
        return (cost - self.mean) / self.std


def build_model(args, device: torch.device) -> VideoSegmentCostPredictor:
    """f32 parameters from --seed, f32 compute whatever --bf16 says (the JAX class's)."""
    return build_seeded_model(
        VideoSegmentCostPredictor, generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device, text_dim=args.text_dim, d_cond=args.d_cond, hidden_dim=args.hidden_dim,
        n_layers=args.n_mlp_layers)


def make_loss_fn(model: VideoSegmentCostPredictor, targets: Targets):
    """loss_fn(params, batch, rng) -> (loss, {}): the MSE of the predicted
    against the normalised oracle costs. No draws."""

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng):
        with torch.no_grad():
            target = targets(batch["latents"])
        pred = model({"text_embed": batch["text_embed"]}, targets.seg_feat)
        return torch.mean((pred - target) ** 2), {}

    return loss_fn


def run_meta(args, targets: Targets) -> Dict:
    return {"stage": "segment_cost_wansynth", "T": args.T, "d_cond": args.d_cond,
            "hidden_dim": args.hidden_dim, "n_layers": args.n_mlp_layers,
            "normalize_targets": args.normalize_targets, "target_mean": targets.mean,
            "target_std": targets.std, "text_dim": args.text_dim}


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device, loader, batch0 = setup(args)
    targets = Targets(args, batch0, device)
    model = build_model(args, device)
    state, train_step = make_state(model, args, make_loss_fn(model, targets))
    return train_loop(args, device, loader, batch0, state, train_step,
                      ("latents", "text_embed"), run_meta(args, targets))


if __name__ == "__main__":
    main()
