"""Stage-1 keypoint DDPM on toy video latents (port of
train/train_keypoints_toy_video.py).

    python -m interpolated_diffusion_tpu_torch.train.train_keypoints_toy_video [flags]

Flat frame latents [B, T, 3 * latent_size^2] of the moving-shapes dataset
(data/toy_video.py); K uniformly spaced anchor frames with jitter
(`--uniform_jitter`, endpoints kept), the first and last frame known over
all their dims and clamped into z_t (eps zeroed there), eps-MSE over the
unknown dims. The denoiser is the maze KeypointDenoiser without the maze
encoder (a zero condition vector), whose blocks take the fused block kernel
under `--attn_policy block` ([B, K, d_model]); at H * K <= 256 the default
`fused` runs plain attention, as the JAX model does. f32 master parameters,
bf16 compute under `--bf16 1`, AdamW behind a global-norm clip and EMA
(train/state.py). Runs on the GPU unless `--device cpu`.

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
"""
from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from ..kernels.tuning import add_attn_policy_arg
from ..data.dataset import BatchLoader
from ..data.toy_video import MovingShapesVideoDataset
from ..models.denoisers import KeypointDenoiser
from ..ops.ddpm import q_sample
from ..ops.keyframes import sample_fixed_k_indices_uniform_batch
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..parallel.mesh import dp_sum
from .batches import gather_keypoints
from .common import (build_seeded, data_mesh, model_params, resolve_device, resume_state,
                     run_training, write_run_config)
from .state import TrainState, init_train_state, make_optimizer, make_train_step

Draws = Dict[str, torch.Tensor]


def add_toy_train_args(p: argparse.ArgumentParser, out_dir: str) -> None:
    """The optimisation, logging and device flags both toy trainers share
    (the JAX flags with their defaults, then --attn_policy and --device)."""
    p.add_argument("--num_samples", type=int, default=100000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--use_ema", type=int, default=1)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default=out_dir)
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--n_data_shards", type=int, default=None,
                   help="DP width; defaults to all local devices (the processes of a "
                        "torchrun launch, one per GPU)")
    add_attn_policy_arg(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_keypoints_toy_video (Stage-1)")
    p.add_argument("--T", type=int, default=16)
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--latent_size", type=int, default=16)
    p.add_argument("--N_train", type=int, default=100)
    p.add_argument("--schedule", type=str, default="linear")
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--clamp_endpoints", type=int, default=1)
    p.add_argument("--uniform_jitter", type=float, default=0.5)
    add_toy_train_args(p, "runs/kp_toy_video")
    return p


def make_meta(args, data_dim: int) -> Dict:
    return {"stage": "keypoints_toy_video", "T": args.T, "K": args.K,
            "latent_size": args.latent_size, "N_train": args.N_train,
            "schedule": args.schedule, "d_model": args.d_model, "n_layers": args.n_layers,
            "n_heads": args.n_heads, "d_ff": args.d_ff,
            "clamp_endpoints": args.clamp_endpoints, "data_dim": data_dim,
            "uniform_jitter": args.uniform_jitter}


def toy_dataset(args, T: int) -> MovingShapesVideoDataset:
    return MovingShapesVideoDataset(T=T, n_samples=args.num_samples, seed=args.seed,
                                    latent_size=args.latent_size)


def build_model(args, data_dim: int, device: torch.device) -> KeypointDenoiser:
    """The denoiser with f32 masters from --seed, bf16 compute under --bf16."""
    return build_seeded(KeypointDenoiser, args, device, d_model=args.d_model,
                        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
                        data_dim=data_dim, use_start_goal=False, maze_cond=False,
                        attn_policy=args.attn_policy)


def make_draws(generator: torch.Generator, args, B: int, D: int) -> Draws:
    """One step's draws from `generator`: "idx_rand" [B, K] uniforms (the
    anchors' jitter), "t" [B] timesteps in [0, N_train), "eps" [B, K, D]."""
    dev = generator.device
    return {"idx_rand": torch.rand((B, args.K), generator=generator, device=dev),
            "t": torch.randint(0, args.N_train, (B,), generator=generator, device=dev),
            "eps": torch.randn((B, args.K, D), generator=generator, device=dev)}


def keypoint_loss(model: KeypointDenoiser, args, schedule: DiffusionSchedule,
                  batch: Dict[str, torch.Tensor], rng: Union[torch.Generator, Draws]):
    """Masked eps-MSE of one batch (x [B, T, D]); `rng` is a generator or the
    dict of `make_draws`, so that a test can hand in JAX's draws."""
    x0 = batch["x"].float()
    B, T, D = x0.shape
    dev = x0.device
    draws = rng if isinstance(rng, dict) else make_draws(rng, args, B, D)
    idx, _ = sample_fixed_k_indices_uniform_batch(
        B, T, args.K, ensure_endpoints=True, jitter=args.uniform_jitter,
        rand=draws["idx_rand"].to(dev))
    z0 = gather_keypoints(x0, idx)
    # the first / last frame known over all dims (latents, not positions)
    ends = ((idx == 0) | (idx == T - 1))[..., None]
    known_mask = ends.expand(z0.shape) & bool(args.clamp_endpoints)
    known_values = torch.where(known_mask, z0, torch.zeros_like(z0))
    t = draws["t"].to(dev).long()
    z_t, eps = q_sample(z0, t, schedule, noise=draws["eps"].to(z0))
    z_t = torch.where(known_mask, known_values, z_t)
    valid = (~known_mask).float()
    eps = eps * valid
    eps_hat = model(z_t, t, idx, known_mask, {}, T)
    return dp_sum(((eps_hat - eps) ** 2 * valid).sum()) / (dp_sum(valid.sum()) + 1e-8), {}


def make_trainer(args, device: torch.device, data_dim: int, model=None):
    """(state, train_step, model): the model (built from --seed unless
    given), the optimizer state over its own parameters, and
    train_step(state, batch, rng) -> (state, metrics)."""
    if model is None:
        model = build_model(args, data_dim, device)
    schedule = make_schedule(args.schedule, args.N_train, device=device)
    loss_fn = lambda params, batch, rng: keypoint_loss(model, args, schedule, batch, rng)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(model_params(model), tx, use_ema=bool(args.use_ema))
    return state, make_train_step(loss_fn, args.ema_decay, args.grad_accum,
                                  mesh=data_mesh(args)), model


def run(args, meta: Dict, make) -> TrainState:
    """The toy trainers' main: dataset, model (`make(args, device, data_dim)`
    -> (state, train_step, model)), resume, run_config.json, the loop."""
    device = resolve_device(args.device)
    data_mesh(args)
    ds = toy_dataset(args, args.T)
    loader = iter(BatchLoader(ds, batch_size=args.batch, seed=args.seed))
    first = next(loader)
    state, train_step, model = make(args, device, ds.data_dim)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M | device: {device} | "
          f"attn_policy: {args.attn_policy}", flush=True)
    start_step = 0
    if args.resume:
        state, start_step = resume_state(state, args.resume, device)
    write_run_config(args, {"args": vars(args), "meta": meta, "n_params": n_params})
    return run_training(args, device, loader, first, state, train_step,
                        lambda b, _step: {"x": b["x"]}, meta, start_step)


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    return run(args, make_meta(args, 3 * args.latent_size ** 2), make_trainer)


if __name__ == "__main__":
    main()
