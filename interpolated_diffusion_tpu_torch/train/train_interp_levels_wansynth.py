"""Wan Phase-2 trainer: level-by-level refinement on video token grids
(port of train/train_interp_levels_wansynth.py).

    python -m interpolated_diffusion_tpu_torch.train.train_interp_levels_wansynth [flags]

Token interpolation corruption (ops/video_keyframes.build_video_token_interp_
{level,adjacent}_batch) with precomputed Phase-1 anchors joined by index
(--data tar --anchors_root: anchor_values / anchor_idx), adj (target = z_prev
- z_s) or x0 (target = tokens - z_s) mode, a confidence-weighted MSE, CFG
text dropout, and a WanDiT whose timestep input is the level s times
--level_t_scale and whose extra cross-attention tokens carry each frame's
features of the level's anchor mask plus its confidence (and the next level's
mask in adj mode: frame_cond_dim 7). Self-attention through SLA (`sla`,
`sage_sla`) or the flash kernels (`dense`), LoRA in either form on a frozen
base, --wan_pretrained. `--use_wan 0` trains the token transformer
(models/video_denoisers.VideoTokenInterpLevelDenoiser) instead. Checkpoints
hold the frozen base (`wan_base`) beside the LoRA and projector leaves, and
the data-stream position in the meta, so that `--resume` continues mid-epoch.
Runs on the GPU unless `--device cpu`.

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
`--grad_accum` is parsed and not applied, as in the JAX trainer.
"""
from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Dict, Optional, Tuple, Union

import torch

from ..models.init import build_model
from ..models.transformer import set_compute_dtype
from ..models.video_denoisers import VideoTokenInterpLevelDenoiser
from ..ops.video_keyframes import (build_video_token_interp_adjacent_batch,
                                   build_video_token_interp_level_batch,
                                   make_video_interp_draws)
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, read_meta, save_checkpoint
from ..utils.frame_features import frame_features_from_mask
from ..utils.memguard import check_cpu_mem
from ..utils.prefetch import DevicePrefetcher, pinned_put
from ..utils.video_tokens import patchify_latents, unpatchify_tokens
from ..parallel.mesh import dp_sum
from ..parallel.multihost import is_main_process
from .common import data_mesh, resolve_device, write_run_config
from .state import TrainState, flatten_dict, init_train_state, make_optimizer, make_train_step_frozen
from .wansynth_common import (WAN_HEAD_MOD_VERSION, add_wan_model_args, add_wansynth_data_args,
                              build_wan, check_wan_meta, init_wan_trainables,
                              make_wansynth_loader)

Draws = Dict[str, object]
FRAME_FEATURES = 6   # [t, is_anchor, alpha, gap, dist_mid] + the confidence channel


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_interp_levels_wansynth (Phase-2)")
    p.add_argument("--K_min", type=int, default=5)
    p.add_argument("--levels", type=int, default=2)
    p.add_argument("--mode", type=str, default="adj", choices=["adj", "x0"])
    p.add_argument("--interp_mode", type=str, default="linear", choices=["linear", "smooth"])
    p.add_argument("--corrupt_mode", type=str, default="gauss", choices=["none", "gauss", "dist"])
    p.add_argument("--corrupt_sigma", type=float, default=0.02)
    p.add_argument("--anchor_noise_frac", type=float, default=0.25)
    p.add_argument("--student_replace_prob", type=float, default=0.5)
    p.add_argument("--student_noise_std", type=float, default=0.02)
    p.add_argument("--w_anchor", type=float, default=1.0)
    p.add_argument("--w_missing", type=float, default=1.0)
    p.add_argument("--cond_drop_prob", type=float, default=0.0)
    p.add_argument("--level_t_scale", type=int, default=100,
                   help="DiT timestep = s * level_t_scale")
    add_wansynth_data_args(p)
    add_wan_model_args(p)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--use_ema", type=int, default=0)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/il_wansynth")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--n_data_shards", type=int, default=None,
                   help="DP width; defaults to all local devices (the processes of a "
                        "torchrun launch, one per GPU)")
    # token-transformer fallback (use_wan=0)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def mask_channels(args) -> int:
    """The token model's mask channels: the level's mask (and the next
    level's in adj mode) plus the confidence."""
    return (2 if args.mode == "adj" else 1) + 1


def make_phase2_draws(generator: torch.Generator, args, B: int, T: int, D: int) -> Draws:
    """The step's random draws from `generator`: the corruption batch's
    ("corr", ops/video_keyframes.make_video_interp_draws over D = N * D_tok
    features) and the text-dropout uniforms ("drop_rand" [B])."""
    return {"corr": make_video_interp_draws(generator, B, T, D, args.K_min, args.levels,
                                            adjacent=args.mode == "adj"),
            "drop_rand": torch.rand((B,), generator=generator, device=generator.device)}


def corruption_kwargs(args) -> Dict:
    return dict(corrupt_mode=args.corrupt_mode, corrupt_sigma=args.corrupt_sigma,
                anchor_noise_frac=args.anchor_noise_frac,
                student_replace_prob=args.student_replace_prob,
                student_noise_std=args.student_noise_std, interp_mode=args.interp_mode,
                clamp_endpoints=False)


def level_features(mask_s: torch.Tensor, conf: torch.Tensor,
                   mask_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-frame features of the level's anchor mask [B, T] (frame_features
    _from_mask), its confidence [B, T] and, in adj mode, the next level's
    mask: [B, T, 6 or 7], the frame projector's input."""
    feats = [frame_features_from_mask(mask_s), conf[..., None].float()]
    if mask_prev is not None:
        feats.append(mask_prev[..., None].float())
    return torch.cat(feats, dim=-1)


def phase2_loss(model, fc, args, batch: Dict[str, torch.Tensor],
                rng: Union[torch.Generator, Draws]) -> Tuple[torch.Tensor, Dict]:
    """Confidence-weighted refinement MSE of one batch (latents [B, T, C, H,
    W], text_embed [B, L, text_dim], and with an anchor join anchors [B, K,
    C, H, W] / anchor_idx [B, K]). `model` is the WanDiT (`fc` its projector)
    or the VideoTokenInterpLevelDenoiser under --use_wan 0. `rng` is a
    torch.Generator or the dict of `make_phase2_draws`, so that a test can
    hand in another framework's draws."""
    latents, text = batch["latents"].float(), batch["text_embed"]
    B = latents.shape[0]
    p_sz = args.patch_size
    tokens, spatial = patchify_latents(latents, p_sz)            # [B, T, N, D_tok]
    T, N, D_tok = tokens.shape[1:]
    draws = rng if isinstance(rng, dict) else make_phase2_draws(rng, args, B, T, N * D_tok)
    kw = corruption_kwargs(args)
    if "anchors" in batch:
        kw["anchor_values"] = patchify_latents(batch["anchors"].float(), p_sz)[0]
        kw["anchor_idx"] = batch["anchor_idx"].long()
    if args.mode == "adj":
        (z_s, z_prev, mask_s, mask_prev, s_idx, _, _, conf_s,
         conf_prev) = build_video_token_interp_adjacent_batch(draws["corr"], tokens, args.K_min,
                                                              args.levels, **kw)
        target, weight = z_prev - z_s, conf_prev[..., 0]
    else:
        z_s, mask_s, s_idx, _, _, conf_s = build_video_token_interp_level_batch(
            draws["corr"], tokens, args.K_min, args.levels, **kw)
        mask_prev, target, weight = None, tokens - z_s, conf_s[..., 0]

    if args.cond_drop_prob > 0.0:
        drop = draws["drop_rand"].to(text.device) < args.cond_drop_prob
        text = torch.where(drop[:, None, None], torch.zeros_like(text), text)

    if args.use_wan:
        feat = level_features(mask_s[:, :, 0], conf_s[:, :, 0],
                              mask_prev[:, :, 0] if mask_prev is not None else None)
        lat_in = unpatchify_tokens(z_s, p_sz, spatial).transpose(1, 2)
        pred = model(lat_in, s_idx * args.level_t_scale, text, None, fc(feat))
        delta_hat = patchify_latents(pred.transpose(1, 2), p_sz)[0]
    else:
        mask_in = [mask_s.float()] + ([mask_prev.float()] if mask_prev is not None else [])
        mask_in = torch.stack(mask_in + [conf_s], dim=-1)
        delta_hat = model(z_s, s_idx, mask_in, {"text_embed": text}, spatial)

    diff = ((delta_hat - target) ** 2).sum(dim=-1)                       # [B, T, N]
    w = (args.w_missing + (args.w_anchor - args.w_missing) * weight[..., None]).expand_as(diff)
    loss = dp_sum((diff * w).sum()) / (dp_sum(w.sum()) * D_tok + 1e-8)
    return loss, {}


def build_token_model(args, device: torch.device, generator: torch.Generator):
    """The --use_wan 0 Stage-2 model: VideoTokenInterpLevelDenoiser with text
    conditioning, f32 parameters computing in bf16 under --bf16."""
    model = build_model(VideoTokenInterpLevelDenoiser, generator=generator, device=device,
                        d_model=args.d_model, n_layers=args.n_layers, n_heads=args.n_heads,
                        d_ff=args.d_ff, data_dim=args.latent_c * args.patch_size ** 2,
                        max_levels=max(8, args.levels), mask_channels=mask_channels(args),
                        text_dim=args.text_dim)
    set_compute_dtype(model, torch.bfloat16 if args.bf16 else None)
    return model


def make_trainer(args, device: torch.device, model=None, fc=None):
    """(state, base, train_step, model, fc): the WanDiT and its projector
    (frame_cond on, frame_cond_dim 6 + 1 in adj mode) or the token model,
    built from --seed unless given; the trainable / frozen partition, the
    optimizer state and step(state, base, batch, rng) -> (state, metrics)."""
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.use_wan:
        args.frame_cond = 1
        args.frame_cond_dim = FRAME_FEATURES + (1 if args.mode == "adj" else 0)
        if model is None:
            model, fc = build_wan(args, bool(args.bf16), device=device, generator=generator)
        trainable, base = init_wan_trainables(args, model, fc, bool(args.bf16))
    else:
        model = model if model is not None else build_token_model(args, device, generator)
        trainable, base = dict(model.named_parameters()), None

    def loss_fn(params, frozen, batch, rng):
        # params and frozen are the modules' own tensors
        return phase2_loss(model, fc, args, batch, rng)

    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(trainable, tx, use_ema=bool(args.use_ema))
    return (state, base, make_train_step_frozen(loss_fn, args.ema_decay, data_mesh(args)),
            model, fc)


def run_meta(args, C: int, H: int, W: int) -> Dict:
    """The checkpoint meta: what the evaluation rebuilds the model from."""
    return {
        "stage": "interp_levels_wansynth", "T": args.T, "K_min": args.K_min,
        "levels": args.levels, "mode": args.mode, "use_wan": args.use_wan,
        "wan_dim": args.wan_dim, "wan_layers": args.wan_layers,
        "wan_heads": args.wan_heads, "wan_ffn": args.wan_ffn,
        "attn_mode": args.attn_mode, "lora_rank": args.lora_rank,
        "lora_alpha": args.lora_alpha, "lora_form": args.lora_form,
        "lora_targets": args.lora_targets, "layer_mode": args.layer_mode,
        "ffn_mode": args.ffn_mode, "n_experts": args.n_experts,
        "capacity_factor": args.capacity_factor,
        "patch_size": args.patch_size, "latent_c": C, "latent_h": H, "latent_w": W,
        "text_dim": args.text_dim, "mask_channels": mask_channels(args),
        "level_t_scale": args.level_t_scale,
        "d_model": args.d_model, "n_layers": args.n_layers,
        "n_heads": args.n_heads, "d_ff": args.d_ff,
        "wan_head_mod": WAN_HEAD_MOD_VERSION,
    }


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = data_mesh(args)
    main_rank = is_main_process()
    resume_path: Optional[str] = None
    data_state = None
    if args.resume:
        resume_path = (args.resume if os.path.exists(os.path.join(args.resume, "meta.json"))
                       else latest_checkpoint(args.resume))
        if resume_path:
            data_state = (read_meta(resume_path)[1] or {}).get("data_state")
    loader = make_wansynth_loader(args, args.seed, state=data_state, mesh=mesh)
    batch0 = next(loader)
    _, _, C, H, W = batch0["latents"].shape

    state, base, train_step, model, fc = make_trainer(args, device)
    n_train = sum(p.numel() for p in flatten_dict(state.params).values())
    print(f"model params: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M | trainable: "
          f"{n_train / 1e6:.3f}M (use_wan={args.use_wan}, lora_rank={args.lora_rank}, "
          f"attn={args.attn_mode})")
    rng = torch.Generator(device=device).manual_seed(args.seed + 1)

    start_step = 0
    if resume_path:
        check_wan_meta(read_meta(resume_path)[1] or {})
        start_step, payload = load_checkpoint(resume_path, map_location=device)
        with torch.no_grad():
            saved = flatten_dict({k: v for k, v in payload["params"].items() if k != "wan_base"})
            for name, p in flatten_dict(state.params).items():
                p.copy_(saved[name])
        if "opt_state" in payload:
            state.opt_state.load_state_dict(payload["opt_state"])
        state = state._replace(step=start_step)

    meta = run_meta(args, C, H, W)
    write_run_config(args, {"args": vars(args), "meta": meta})

    put = pinned_put(device, keys=("latents", "text_embed", "anchors", "anchor_idx"))
    host_iter = itertools.chain([batch0], loader)
    dev_iter = (DevicePrefetcher(host_iter, put, depth=args.prefetch_depth)
                if args.prefetch_depth > 0 else map(put, host_iter))
    t_prev = time.time()
    for step in range(start_step, args.steps):
        check_cpu_mem(args.max_cpu_mem_percent)
        state, metrics = train_step(state, base, next(dev_iter), rng)
        if main_rank and step % args.log_every == 0:
            loss = float(metrics["loss"])  # device sync = true step timing
            now = time.time()
            dt = now - t_prev
            t_prev = now
            n = max(1, args.log_every if step > start_step else 1)
            print(f"step {step} loss {loss:.4f} | {dt / n:.3f}s/step "
                  f"| {args.batch * n / dt:.2f} samples/s")
        if main_rank and ((step + 1) % args.save_every == 0 or step + 1 == args.steps):
            to_save = dict(state.params)
            if base is not None:
                to_save["wan_base"] = base
            save_meta = dict(meta)
            if getattr(loader, "state", None) is not None:
                save_meta["data_state"] = loader.state
            save_checkpoint(os.path.join(args.out_dir, f"ckpt_{step + 1}"), to_save, None,
                            step + 1, state.ema_params, save_meta)
    if hasattr(dev_iter, "close"):
        dev_iter.close()   # stop the prefetch thread, free queued batches
    return state


if __name__ == "__main__":
    main()
