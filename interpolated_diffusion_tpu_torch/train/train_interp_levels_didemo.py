"""DiDeMo / LSMDC Stage-2 trainer: token interp-level refinement with CLIP
text conditioning (port of train/train_interp_levels_didemo.py).

    python -m interpolated_diffusion_tpu_torch.train.train_interp_levels_didemo --cache_dir DIR [flags]

Token corruption over the cached VAE latents (ops/video_keyframes.
build_video_token_interp_{adjacent,level}_batch, endpoints not clamped),
adj (target z_prev - z_s) or x0 (target tokens - z_s) mode with the
confidence as an input channel, the confidence-weighted MSE, text
conditioning, on VideoTokenInterpLevelDenoiser over the T * N tokens: its
attention takes small_mha_packed under the default `fused` where 256 < H *
T * N and T * N <= 256, every block the fused block kernel under `block`
where T * N <= 256. Runs on the GPU unless `--device cpu`.

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
"""
from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from ..models.video_denoisers import VideoTokenInterpLevelDenoiser
from ..ops.video_keyframes import (Draws, build_video_token_interp_adjacent_batch,
                                   build_video_token_interp_level_batch, make_video_interp_draws)
from ..utils.video_tokens import patchify_latents
from ..parallel.mesh import dp_sum
from .common import build_seeded, data_mesh, model_params
from .state import TrainState, init_train_state, make_optimizer, make_train_step
from .train_keypoints_didemo import _text, add_didemo_train_args, cache_shapes, run


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_interp_levels_didemo (Stage-2)")
    p.add_argument("--cache_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--K_min", type=int, default=4)
    p.add_argument("--levels", type=int, default=2)
    p.add_argument("--mode", type=str, default="adj", choices=["adj", "x0"])
    p.add_argument("--patch_size", type=int, default=2)
    p.add_argument("--interp_mode", type=str, default="linear", choices=["linear", "smooth"])
    p.add_argument("--corrupt_mode", type=str, default="gauss", choices=["none", "gauss", "dist"])
    p.add_argument("--corrupt_sigma", type=float, default=0.02)
    p.add_argument("--student_replace_prob", type=float, default=0.5)
    p.add_argument("--student_noise_std", type=float, default=0.02)
    p.add_argument("--w_anchor", type=float, default=1.0)
    p.add_argument("--w_missing", type=float, default=1.0)
    add_didemo_train_args(p, "runs/il_didemo")
    return p


def mask_channels(args) -> int:
    return (2 if args.mode == "adj" else 1) + 1


def make_meta(args, batch0: Dict) -> Dict:
    T, C, H, W, _, text_dim = cache_shapes(batch0, args.patch_size)
    return {"stage": "interp_levels_didemo", "T": T, "K_min": args.K_min,
            "levels": args.levels, "mode": args.mode, "patch_size": args.patch_size,
            "latent_c": C, "latent_h": H, "latent_w": W, "text_dim": text_dim,
            "mask_channels": mask_channels(args), "d_model": args.d_model,
            "n_layers": args.n_layers, "n_heads": args.n_heads, "d_ff": args.d_ff}


def interp_loss(model: VideoTokenInterpLevelDenoiser, args, batch: Dict[str, torch.Tensor],
                rng: Union[torch.Generator, Draws]):
    """Confidence-weighted refinement MSE over the tokens; `rng` is a
    generator or the dict of make_video_interp_draws over N * D_tok
    features, so that a test can hand in JAX's draws."""
    tokens, spatial = patchify_latents(batch["latents"].float(), args.patch_size)
    text = _text(batch)
    B, T, N, D_tok = tokens.shape
    draws = rng if isinstance(rng, dict) else make_video_interp_draws(
        rng, B, T, N * D_tok, args.K_min, args.levels, adjacent=args.mode == "adj")
    corr = dict(corrupt_mode=args.corrupt_mode, corrupt_sigma=args.corrupt_sigma,
                student_replace_prob=args.student_replace_prob,
                student_noise_std=args.student_noise_std, interp_mode=args.interp_mode,
                clamp_endpoints=False)
    if args.mode == "adj":
        (z_s, z_prev, mask_s, mask_prev, s_idx, _, _, conf_s,
         conf_prev) = build_video_token_interp_adjacent_batch(draws, tokens, args.K_min,
                                                              args.levels, **corr)
        target, weight = z_prev - z_s, conf_prev
        mask_in = torch.stack([mask_s.float(), mask_prev.float(), conf_s], dim=-1)
    else:
        z_s, mask_s, s_idx, _, _, conf_s = build_video_token_interp_level_batch(
            draws, tokens, args.K_min, args.levels, **corr)
        target, weight = tokens - z_s, conf_s
        mask_in = torch.stack([mask_s.float(), conf_s], dim=-1)
    delta = model(z_s, s_idx, mask_in, {"text_embed": text}, spatial)
    diff = ((delta - target) ** 2).sum(dim=-1)
    w = args.w_missing + (args.w_anchor - args.w_missing) * weight
    return dp_sum((diff * w).sum()) / (dp_sum(w.sum()) * D_tok + 1e-8), {}


def make_trainer(args, device: torch.device, batch0: Dict, model=None):
    """(state, train_step, model) for the cache whose first batch is batch0."""
    _, _, _, _, D_tok, text_dim = cache_shapes(batch0, args.patch_size)
    if model is None:
        model = build_seeded(VideoTokenInterpLevelDenoiser, args, device,
                             d_model=args.d_model, n_layers=args.n_layers,
                             n_heads=args.n_heads, d_ff=args.d_ff, data_dim=D_tok,
                             max_levels=max(8, args.levels), mask_channels=mask_channels(args),
                             text_dim=text_dim, attn_policy=args.attn_policy)
    loss_fn = lambda params, batch, rng: interp_loss(model, args, batch, rng)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(model_params(model), tx, use_ema=bool(args.use_ema))
    return state, make_train_step(loss_fn, args.ema_decay, args.grad_accum,
                                  mesh=data_mesh(args)), model


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    return run(args, make_meta, make_trainer)


if __name__ == "__main__":
    main()
