"""DiDeMo / LSMDC Stage-1 trainer: keypoint DDPM over VAE-latent tokens with
CLIP text conditioning (port of train/train_keypoints_didemo.py).

    python -m interpolated_diffusion_tpu_torch.train.train_keypoints_didemo --cache_dir DIR [flags]

Reads a precomputed latent + text cache (data/didemo.CachedClipDataset;
data/precompute_clip_cache.py writes one), patchifies each frame's latents
into N tokens, draws K uniformly spaced anchor frames with jitter (no
forced endpoints), eps-MSE of VideoTokenKeypointDenoiser over the K * N
tokens, with the text embedding dropped (zeroed) per sample at
`--cond_drop_prob`. LSMDC caches have the same contract. Under the default
`--attn_policy fused` the attention takes small_mha_packed where 256 < H * K
* N and K * N <= 256, under `block` every block the fused block kernel where
K * N <= 256. f32 master parameters, bf16 compute under `--bf16 1`, AdamW
behind a global-norm clip, EMA. Runs on the GPU unless `--device cpu`.

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple, Union

import torch

from ..kernels.tuning import add_attn_policy_arg
from ..data.dataset import BatchLoader
from ..data.didemo import CachedClipDataset
from ..models.video_denoisers import VideoTokenKeypointDenoiser
from ..ops.keyframes import sample_fixed_k_indices_uniform_batch
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..utils.video_tokens import patchify_latents
from .common import (build_seeded, data_mesh, model_params, resolve_device, resume_state,
                     run_training, write_run_config)
from .state import TrainState, init_train_state, make_optimizer, make_train_step

Draws = Dict[str, torch.Tensor]


def add_didemo_train_args(p: argparse.ArgumentParser, out_dir: str) -> None:
    """The optimisation, logging and device flags both DiDeMo trainers share
    (the JAX flags with their defaults, then --attn_policy and --device)."""
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--batch", type=int, default=16)
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
    p = argparse.ArgumentParser("train_keypoints_didemo (Stage-1)")
    p.add_argument("--cache_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--N_train", type=int, default=100)
    p.add_argument("--schedule", type=str, default="linear")
    p.add_argument("--patch_size", type=int, default=2)
    p.add_argument("--uniform_jitter", type=float, default=0.5)
    p.add_argument("--cond_drop_prob", type=float, default=0.1)
    add_didemo_train_args(p, "runs/kp_didemo")
    return p


def cache_shapes(batch: Dict, patch_size: int) -> Tuple[int, int, int, int, int, int]:
    """(T, C, H, W, D_tok, text_dim) of a cache batch (latents [B, T, C, H, W])."""
    _, T, C, H, W = batch["latents"].shape
    return T, C, H, W, C * patch_size * patch_size, int(batch["text_embed"].shape[-1])


def _text(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    text = batch["text_embed"].float()
    return text[:, None, :] if text.ndim == 2 else text


def make_draws(generator: torch.Generator, args, B: int, N: int, D_tok: int) -> Draws:
    """One step's draws: "idx_rand" [B, K] (the anchors' jitter), "t" [B],
    "eps" [B, K, N, D_tok], "drop_rand" [B] (text dropout)."""
    dev = generator.device
    return {"idx_rand": torch.rand((B, args.K), generator=generator, device=dev),
            "t": torch.randint(0, args.N_train, (B,), generator=generator, device=dev),
            "eps": torch.randn((B, args.K, N, D_tok), generator=generator, device=dev),
            "drop_rand": torch.rand((B,), generator=generator, device=dev)}


def keypoint_loss(model: VideoTokenKeypointDenoiser, args, schedule: DiffusionSchedule,
                  batch: Dict[str, torch.Tensor], rng: Union[torch.Generator, Draws]):
    """eps-MSE over the K anchor frames' tokens; `rng` is a generator or the
    dict of `make_draws`, so that a test can hand in JAX's draws."""
    tokens, spatial = patchify_latents(batch["latents"].float(), args.patch_size)
    text = _text(batch)
    B, T, N, D_tok = tokens.shape
    dev = tokens.device
    draws = rng if isinstance(rng, dict) else make_draws(rng, args, B, N, D_tok)
    idx, _ = sample_fixed_k_indices_uniform_batch(
        B, T, args.K, ensure_endpoints=False, jitter=args.uniform_jitter,
        rand=draws["idx_rand"].to(dev))
    z0 = torch.gather(tokens, 1, idx[:, :, None, None].expand(-1, -1, N, D_tok))
    t = draws["t"].to(dev).long()
    eps = draws["eps"].to(z0)
    z_t = (schedule.sqrt_alpha_bar[t][:, None, None, None] * z0
           + schedule.sqrt_one_minus_alpha_bar[t][:, None, None, None] * eps)
    if args.cond_drop_prob > 0:
        drop = draws["drop_rand"].to(dev) < args.cond_drop_prob
        text = torch.where(drop[:, None, None], torch.zeros_like(text), text)
    eps_hat = model(z_t, t, idx, {"text_embed": text}, T, spatial)
    return torch.mean((eps_hat - eps) ** 2), {}


def make_meta(args, batch0: Dict) -> Dict:
    T, C, H, W, _, text_dim = cache_shapes(batch0, args.patch_size)
    return {"stage": "keypoints_didemo", "T": T, "K": args.K, "N_train": args.N_train,
            "schedule": args.schedule, "patch_size": args.patch_size, "latent_c": C,
            "latent_h": H, "latent_w": W, "text_dim": text_dim, "d_model": args.d_model,
            "n_layers": args.n_layers, "n_heads": args.n_heads, "d_ff": args.d_ff}


def make_trainer(args, device: torch.device, batch0: Dict, model=None):
    """(state, train_step, model) for the cache whose first batch is batch0."""
    _, _, _, _, D_tok, text_dim = cache_shapes(batch0, args.patch_size)
    if model is None:
        model = build_seeded(VideoTokenKeypointDenoiser, args, device, d_model=args.d_model,
                             n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
                             data_dim=D_tok, text_dim=text_dim, attn_policy=args.attn_policy)
    schedule = make_schedule(args.schedule, args.N_train, device=device)
    loss_fn = lambda params, batch, rng: keypoint_loss(model, args, schedule, batch, rng)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(model_params(model), tx, use_ema=bool(args.use_ema))
    return state, make_train_step(loss_fn, args.ema_decay, args.grad_accum,
                                  mesh=data_mesh(args)), model


def run(args, make_meta_fn, make) -> TrainState:
    """The DiDeMo trainers' main: the cache and its loader, the model
    (`make(args, device, batch0)`), resume, run_config.json, the loop."""
    device = resolve_device(args.device)
    data_mesh(args)
    ds = CachedClipDataset(args.cache_dir, args.split)
    loader = iter(BatchLoader(ds, batch_size=args.batch, seed=args.seed))
    first = next(loader)
    state, train_step, model = make(args, device, first)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M | device: {device} | "
          f"attn_policy: {args.attn_policy}", flush=True)
    start_step = 0
    if args.resume:
        state, start_step = resume_state(state, args.resume, device)
    meta = make_meta_fn(args, first)
    write_run_config(args, {"args": vars(args), "meta": meta, "n_params": n_params})
    host = lambda b, _step: {"latents": b["latents"], "text_embed": b["text_embed"]}
    return run_training(args, device, loader, first, state, train_step, host, meta, start_step)


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    return run(args, make_meta, make_trainer)


if __name__ == "__main__":
    main()
