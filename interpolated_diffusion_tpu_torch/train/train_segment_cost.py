"""D_phi segment-cost predictor trainer (port of train/train_segment_cost.py).

    python -m interpolated_diffusion_tpu_torch.train.train_segment_cost [flags]

Regression of SegmentCostPredictor onto SNR-weighted ground-truth segment
costs (log-SNR-subsampled timesteps, a clipped-SNR^gamma weight scale),
optionally normalised by the mean and std of a dataset subset. AdamW behind
a global-norm clip, no EMA (train/state.py); meta-rich checkpoints. The
model holds f32 master parameters and computes in bf16 (`--bf16 1`). Runs on
the GPU unless `--device cpu`.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from ..models.selector import SegmentCostPredictor
from ..ops.selection import (build_segment_features, build_segment_precompute,
                             build_snr_weights, compute_segment_costs_batch,
                             sample_timesteps_log_snr, snr_weight_scale)
from .common import (add_data_args, add_train_args, build_seeded, data_mesh, make_dataset,
                     make_loader, model_params, resolve_device, resume_state, run_training,
                     write_run_config)
from .state import TrainState, init_train_state, make_optimizer, make_train_multi_step


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_segment_cost (D_phi)")
    p.add_argument("--T", type=int, default=64)
    p.add_argument("--d_cond", type=int, default=128)
    p.add_argument("--seg_feat_dim", type=int, default=3)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--n_layers_mlp", type=int, default=3)
    p.add_argument("--maze_channels", type=str, default="32,64,128,128")
    p.add_argument("--cond_start_goal", type=int, default=1)
    p.add_argument("--segment_cost_samples", type=int, default=16)
    p.add_argument("--snr_schedule", type=str, default="cosine", choices=["cosine", "linear"])
    p.add_argument("--snr_N_train", type=int, default=1000)
    p.add_argument("--snr_min", type=float, default=0.1)
    p.add_argument("--snr_max", type=float, default=10.0)
    p.add_argument("--snr_gamma", type=float, default=1.0)
    p.add_argument("--t_steps", type=int, default=16)
    p.add_argument("--normalize_targets", type=int, default=1)
    p.add_argument("--stats_subset", type=int, default=512)
    add_data_args(p)
    add_train_args(p)
    return p


class Targets:
    """The regression targets' tables: segment precompute and features (on
    `device`), the SNR weight scale, and the normalisation statistics."""

    def __init__(self, args, ds, device: torch.device):
        snr, weights = build_snr_weights(args.snr_schedule, args.snr_N_train, args.snr_min,
                                         args.snr_max, args.snr_gamma)
        self.t_idx = sample_timesteps_log_snr(snr, args.t_steps)
        self.weight_scale = snr_weight_scale(weights, self.t_idx)
        self.precomp = build_segment_precompute(args.T, args.segment_cost_samples).to(device)
        self.seg_feat = build_segment_features(args.T, self.precomp.seg_i, self.precomp.seg_j)
        self.normalize = bool(args.normalize_targets)
        self.mean, self.std = 0.0, 1.0
        if self.normalize:
            rng = np.random.RandomState(123)
            sub = rng.randint(0, len(ds), size=min(len(ds), args.stats_subset))
            xb = torch.as_tensor(ds.get_batch(sub)["x"]).to(device)
            costs = compute_segment_costs_batch(xb, self.precomp, self.weight_scale)
            self.mean = float(costs.mean())
            self.std = max(1e-6, float(costs.std(correction=0)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        target = compute_segment_costs_batch(x, self.precomp, self.weight_scale)
        return (target - self.mean) / self.std if self.normalize else target


def make_meta(args, targets: Targets) -> Dict:
    return {
        "stage": "segment_cost", "T": args.T, "d_cond": args.d_cond,
        "seg_feat_dim": args.seg_feat_dim, "hidden_dim": args.hidden_dim,
        "n_layers": args.n_layers_mlp, "use_sdf": args.use_sdf,
        "cond_start_goal": args.cond_start_goal,
        "snr_schedule": args.snr_schedule, "snr_N_train": args.snr_N_train,
        "snr_min": args.snr_min, "snr_max": args.snr_max, "snr_gamma": args.snr_gamma,
        "t_steps": args.t_steps, "t_idx": np.asarray(targets.t_idx).tolist(),
        "weight_scale": targets.weight_scale,
        "segment_cost_samples": args.segment_cost_samples,
        "maze_channels": args.maze_channels,
        "normalize_targets": args.normalize_targets,
        "target_mean": targets.mean, "target_std": targets.std,
        "maze_h": args.maze_h, "maze_w": args.maze_w,
    }


def build_model(args, device: torch.device) -> SegmentCostPredictor:
    """D_phi with f32 masters from --seed, bf16 compute under --bf16."""
    return build_seeded(
        SegmentCostPredictor, args, device, d_cond=args.d_cond, seg_feat_dim=args.seg_feat_dim,
        hidden_dim=args.hidden_dim, n_layers=args.n_layers_mlp, use_sdf=bool(args.use_sdf),
        use_start_goal=bool(args.cond_start_goal),
        maze_channels=tuple(int(c) for c in args.maze_channels.split(",")))


def make_loss_fn(model: SegmentCostPredictor, targets: Targets):
    """loss_fn(params, batch, rng) -> (loss, {}): the MSE of D_phi's costs
    of every segment against the (normalised) targets. No draws."""

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng):
        cond = {"occ": batch["occ"], "start_goal": batch["start_goal"]}
        if "sdf" in batch:
            cond["sdf"] = batch["sdf"]
        with torch.no_grad():
            target = targets(batch["x"].float())
        pred = model(cond, targets.seg_feat)
        return torch.mean((pred - target) ** 2), {}

    return loss_fn


def make_trainer(args, device: torch.device, ds, model=None):
    """(state, train_step, model, targets)."""
    targets = Targets(args, ds, device)
    if model is None:
        model = build_model(args, device)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(model_params(model), tx, use_ema=False)
    train_step = make_train_multi_step(make_loss_fn(model, targets), args.ema_decay,
                                       args.grad_accum, max(1, args.steps_per_call),
                                       mesh=data_mesh(args))
    return state, train_step, model, targets


def host_batch(args, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {"x": batch["x"], "occ": batch["occ"], "start_goal": batch["start_goal"]}
    if "sdf" in batch and args.use_sdf:
        out["sdf"] = batch["sdf"]
    return out


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    data_mesh(args)
    ds, _ = make_dataset(args)
    loader = iter(make_loader(ds, args))
    first = next(loader)
    state, train_step, model, targets = make_trainer(args, device, ds)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.3f}M | device: {device}", flush=True)
    start_step = 0
    if args.resume:
        state, start_step = resume_state(state, args.resume, device)
    meta = make_meta(args, targets)
    write_run_config(args, {"args": vars(args), "meta": meta})
    return run_training(args, device, loader, first, state, train_step,
                        lambda b, _step: host_batch(args, b), meta, start_step)


if __name__ == "__main__":
    main()
