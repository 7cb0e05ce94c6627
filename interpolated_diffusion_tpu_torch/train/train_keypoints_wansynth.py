"""Wan Phase-1 trainer: fine-tune a Wan-style DiT as the keypoint denoiser
(port of train/train_keypoints_wansynth.py).

    python -m interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth [flags]

Patchified latents, uniform-K anchors without forced endpoints, eps
prediction at the anchor slots. `phase1_input_mode`: `full` scatters the
noisy anchors into the T-sequence and interpolates the missing frames;
`short_anchors` runs the K anchors alone, `short_midpoints` /
`short_meanpool` 2K - 1 frames (anchors and segment midpoints, or segment
means), all three with absolute-time RoPE. Self-attention through SLA
(`--attn_mode sla`, `sage_sla`) or the flash kernels (`dense`), LoRA (runtime
or merged form) on a frozen base, optionally pretrained Wan2.1 weights
(`--wan_pretrained`), frame-conditioning cross-attention tokens, CFG text
dropout, throughput telemetry. `--dit hunyuan_video` trains HunyuanVideo
(models/hunyuan_video.py) in WanDiT's place through the same loss, step and
loader: its text mask and pooled vector come with the rows, the K
frame-condition tokens go ahead of the prompt into its token refiner, and text
dropout zeroes the prompt and the pooled vector. `--use_wan 0` trains the token transformer
(models/video_denoisers.VideoTokenKeypointDenoiser) instead. Runs on the GPU
unless `--device cpu`.

`--ffn_mode moe` swaps every block's FFN for the Switch-MoE FFN
(models/moe.py); `--n_data_shards N` under `torchrun --nproc_per_node N`
trains data parallel, one process per GPU; `--ckpt_async 1` writes sharded
checkpoints on a background thread (utils/checkpoint_sharded.py), the last
one joined before exit. `--grad_accum` is parsed and not applied, as in the
JAX trainer.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import time
from typing import Dict, Optional, Tuple, Union

import torch

from ..models.init import build_model
from ..models.transformer import set_compute_dtype
from ..models.video_denoisers import VideoTokenKeypointDenoiser
from ..ops.keyframes import sample_fixed_k_indices_uniform_batch
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..ops.video_keyframes import interpolate_video_from_indices
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, read_meta, save_checkpoint
from ..utils.checkpoint_sharded import save_checkpoint_sharded, wait_for_async_saves
from ..utils.frame_features import frame_features_from_mask
from ..utils.memguard import check_cpu_mem
from ..utils.prefetch import DevicePrefetcher, pinned_put
from ..utils.profiling import trace as profile_trace
from ..utils.video_tokens import patchify_latents, unpatchify_tokens
from ..parallel.multihost import is_main_process
from .common import data_mesh, resolve_device, write_run_config
from .state import TrainState, flatten_dict, init_train_state, make_optimizer, make_train_step_frozen
from .wansynth_common import (
    WAN_HEAD_MOD_VERSION,
    add_hunyuan_args,
    add_wan_model_args,
    add_wansynth_data_args,
    build_wan,
    check_wan_meta,
    init_wan_trainables,
    make_wansynth_loader,
    meanpool_between_anchors,
    midpoint_indices,
)

Draws = Dict[str, torch.Tensor]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_keypoints_wansynth (Phase-1)")
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--N_train", type=int, default=1000)
    p.add_argument("--schedule", type=str, default="linear")
    p.add_argument("--phase1_input_mode", type=str, default="short_anchors",
                   choices=["full", "short_anchors", "short_midpoints", "short_meanpool"])
    p.add_argument("--video_interp_mode", type=str, default="smooth",
                   choices=["linear", "smooth"])
    p.add_argument("--cond_drop_prob", type=float, default=0.1)
    p.add_argument("--uniform_jitter", type=float, default=0.5)
    add_wansynth_data_args(p)
    add_wan_model_args(p)
    add_hunyuan_args(p)
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
    p.add_argument("--out_dir", type=str, default="runs/kp_wansynth")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--ckpt_async", type=int, default=0,
                   help="1: sharded checkpoints written on a background thread "
                        "(utils/checkpoint_sharded.py)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--n_data_shards", type=int, default=None,
                   help="DP width; defaults to all local devices (the processes of a "
                        "torchrun launch, one per GPU)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace (trace.json, viewable in "
                        "chrome://tracing or Perfetto) of a window of steps into this dir; "
                        "it carries the program's idt.* spans: idt.train.step with its "
                        "forward, backward and optimizer, idt.data.wait (blocked on the "
                        "prefetch queue), idt.wan.sla with its block_map, sparse and "
                        "linear parts, and idt.wan.sla.bwd (utils/profiling.py)")
    p.add_argument("--profile_start", type=int, default=3)
    p.add_argument("--profile_steps", type=int, default=3)
    # token-transformer fallback (use_wan=0)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def noised_frames(args) -> int:
    """Frames that are noised and predicted: the K anchors (`full`, where the
    model sees T frames, and `short_anchors`) or anchors and midpoints, 2K - 1."""
    K = min(args.K, args.T)
    return 2 * K - 1 if args.phase1_input_mode in ("short_midpoints", "short_meanpool") else K


def draw_phase1(generator: torch.Generator, args, B: int, z_shape: Tuple[int, ...]) -> Draws:
    """The step's random draws from `generator` (on its device): the index
    jitter's uniforms [B, K], the timesteps [B], eps in the shape of the
    model input tokens, and the text-dropout uniforms [B]."""
    dev = generator.device
    return {"idx_rand": torch.rand((B, min(args.K, args.T)), generator=generator, device=dev),
            "t": torch.randint(0, args.N_train, (B,), generator=generator, device=dev),
            "eps": torch.randn(z_shape, generator=generator, device=dev),
            "drop_rand": torch.rand((B,), generator=generator, device=dev)}


def phase1_loss(wan, fc, args, schedule: DiffusionSchedule, batch: Dict[str, torch.Tensor],
                rng: Union[torch.Generator, Draws]) -> Tuple[torch.Tensor, Dict]:
    """Anchor-slot eps MSE of one batch (latents [B, T, C, H, W], text_embed
    [B, L, text_dim]; HunyuanVideo's rows also carry text_mask [B, L] and
    pooled [B, pooled_dim], which go to the model as they come). `wan` is the
    WanDiT or HunyuanVideo model (`fc` its projector), or the
    VideoTokenKeypointDenoiser under --use_wan 0.
    `rng` is a torch.Generator, or the draws themselves (the dict of
    `draw_phase1`), so that a test can hand in another framework's."""
    latents, text = batch["latents"].float(), batch["text_embed"]
    B, T = latents.shape[:2]
    p_sz, K, mode = args.patch_size, min(args.K, args.T), args.phase1_input_mode
    tokens, spatial = patchify_latents(latents, p_sz)            # [B, T, N, D_tok]
    N, D_tok = tokens.shape[2:]
    draws = (rng if isinstance(rng, dict)
             else draw_phase1(rng, args, B, (B, noised_frames(args), N, D_tok)))

    idx_base, mask = sample_fixed_k_indices_uniform_batch(
        B, T, K, ensure_endpoints=False, jitter=args.uniform_jitter,
        rand=draws["idx_rand"].to(latents.device))
    if mode in ("short_midpoints", "short_meanpool"):
        idx_mid = midpoint_indices(idx_base)
        idx_in = torch.sort(torch.cat([idx_base, idx_mid], dim=1), dim=1).values
    else:
        idx_in = idx_base
    take = lambda x, at: torch.gather(x, 1, at[..., None, None].expand(-1, -1, *x.shape[2:]))
    z0_in = take(tokens, idx_in)
    b_ix = torch.arange(B, device=latents.device)[:, None]
    if mode == "short_meanpool":
        pos_mid = torch.searchsorted(idx_in, midpoint_indices(idx_base))
        z0_in = z0_in.index_put((b_ix, pos_mid), meanpool_between_anchors(tokens, idx_base))

    t, eps = draws["t"].long(), draws["eps"].to(z0_in.dtype)
    sab = schedule.sqrt_alpha_bar[t][:, None, None, None]
    somab = schedule.sqrt_one_minus_alpha_bar[t][:, None, None, None]
    z_t = sab * z0_in + somab * eps

    cond = {k: batch[k] for k in ("text_mask", "pooled") if k in batch}
    if args.cond_drop_prob > 0.0:
        drop = draws["drop_rand"] < args.cond_drop_prob
        text = torch.where(drop[:, None, None], torch.zeros_like(text), text)
        if "pooled" in cond:   # the prompt and its pooled vector go; the mask stays
            cond["pooled"] = torch.where(drop[:, None], torch.zeros_like(cond["pooled"]),
                                         cond["pooled"])

    if not args.use_wan:
        eps_hat = wan(z_t, t, idx_in, {"text_embed": text}, T, spatial)
        return torch.mean((eps_hat - eps) ** 2), {}
    extra = None
    if args.frame_cond:
        feat = frame_features_from_mask(mask)
        if mode != "full":
            feat = torch.gather(feat, 1, idx_in[..., None].expand(-1, -1, feat.shape[-1]))
        extra = fc(feat)
    if mode == "full":
        # scatter the noisy anchors into the T-sequence, interpolate the rest
        z_flat = z_t.permute(0, 2, 1, 3).reshape(B * N, K, D_tok)
        z_interp = interpolate_video_from_indices(idx_base.repeat_interleave(N, dim=0), z_flat, T,
                                                  mode=args.video_interp_mode)
        z_seq = z_interp.reshape(B, N, T, D_tok).permute(0, 2, 1, 3)
        z_in, frames = z_seq.index_put((b_ix, idx_base), z_t), None
    else:
        z_in, frames = z_t, idx_in
    pred = wan(unpatchify_tokens(z_in, p_sz, spatial).transpose(1, 2), t, text, frames, extra,
               **cond)
    pred_tokens, _ = patchify_latents(pred.transpose(1, 2), p_sz)
    if mode == "full":
        pred_tokens = take(pred_tokens, idx_base)
    return torch.mean((pred_tokens - eps) ** 2), {}


def _save_meta(meta: Dict, loader) -> Dict:
    """The checkpoint meta with the data-stream position, so that --resume
    continues the stream mid-epoch (it may overshoot by the prefetch depth:
    resume skips, never repeats, those batches)."""
    save_meta = dict(meta)
    if getattr(loader, "state", None) is not None:
        save_meta["data_state"] = loader.state
    return save_meta


def run_meta(args, C: int, H: int, W: int) -> Dict:
    """The checkpoint meta: what samplers and later trainers rebuild from."""
    return {
        "stage": "keypoints_wansynth", "T": args.T, "K": args.K,
        "N_train": args.N_train, "schedule": args.schedule,
        "phase1_input_mode": args.phase1_input_mode, "use_wan": args.use_wan,
        "wan_dim": args.wan_dim, "wan_layers": args.wan_layers,
        "wan_heads": args.wan_heads, "wan_ffn": args.wan_ffn,
        "attn_mode": args.attn_mode, "sla_topk": args.sla_topk,
        "lora_rank": args.lora_rank, "lora_alpha": args.lora_alpha,
        "lora_form": args.lora_form, "lora_targets": args.lora_targets,
        "layer_mode": args.layer_mode,
        "ffn_mode": args.ffn_mode, "n_experts": args.n_experts,
        "capacity_factor": args.capacity_factor,
        "frame_cond": args.frame_cond, "patch_size": args.patch_size,
        "latent_c": C, "latent_h": H, "latent_w": W,
        "text_dim": args.text_dim,
        "d_model": args.d_model, "n_layers": args.n_layers,
        "n_heads": args.n_heads, "d_ff": args.d_ff,
        "wan_head_mod": WAN_HEAD_MOD_VERSION,
        # the backbone, and HunyuanVideo's sizes and prompt inputs (unused by WanDiT)
        "dit": args.dit, "hy_heads": args.hy_heads, "hy_double": args.hy_double,
        "hy_single": args.hy_single, "pooled_dim": args.pooled_dim,
        "text_valid_min": args.text_valid_min, "text_valid_max": args.text_valid_max,
    }


def build_token_model(args, device: torch.device, generator: torch.Generator):
    """The --use_wan 0 Stage-1 model: VideoTokenKeypointDenoiser over the
    patchified tokens (d_model, n_layers, n_heads, d_ff), text conditioning,
    f32 parameters computing in bf16 under --bf16."""
    model = build_model(VideoTokenKeypointDenoiser, generator=generator, device=device,
                        d_model=args.d_model, n_layers=args.n_layers, n_heads=args.n_heads,
                        d_ff=args.d_ff, data_dim=args.latent_c * args.patch_size ** 2,
                        text_dim=args.text_dim)
    set_compute_dtype(model, torch.bfloat16 if args.bf16 else None)
    return model


def make_trainer(args, device: torch.device, wan=None, fc=None):
    """(state, base, train_step, wan, fc): the model (built from --seed unless
    given; the token model under --use_wan 0, with fc and base None), its
    trainable / frozen partition, the optimizer state and the step function
    step(state, base, batch, rng) -> (state, metrics)."""
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if not args.use_wan:
        wan = wan if wan is not None else build_token_model(args, device, generator)
        trainable, base = dict(wan.named_parameters()), None
    else:
        if wan is None:
            wan, fc = build_wan(args, bool(args.bf16), device=device, generator=generator)
        trainable, base = init_wan_trainables(args, wan, fc, bool(args.bf16))
    schedule = make_schedule(args.schedule, args.N_train, device=device)

    def loss_fn(params, frozen, batch, rng):
        # params and frozen are the modules' own tensors (init_wan_trainables)
        return phase1_loss(wan, fc, args, schedule, batch, rng)

    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(trainable, tx, use_ema=bool(args.use_ema))
    return state, base, make_train_step_frozen(loss_fn, args.ema_decay, data_mesh(args)), wan, fc


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = data_mesh(args)
    main_rank = is_main_process()
    # the resume checkpoint first: its meta carries the data-stream position,
    # so a preempted run resumes mid-epoch instead of replaying the stream
    resume_path: Optional[str] = None
    data_state = None
    if args.resume:
        resume_path = (args.resume if os.path.exists(os.path.join(args.resume, "meta.json"))
                       else latest_checkpoint(args.resume))
        if resume_path:
            data_state = (read_meta(resume_path)[1] or {}).get("data_state")
    loader = make_wansynth_loader(args, args.seed, state=data_state, mesh=mesh)
    T = args.T
    batch0 = next(loader)
    _, _, C, H, W = batch0["latents"].shape

    state, base, train_step, wan, fc = make_trainer(args, device)
    n_base = sum(p.numel() for p in wan.parameters())
    n_train = sum(p.numel() for p in flatten_dict(state.params).values())
    print(f"{type(wan).__name__} params: {n_base / 1e6:.1f}M | trainable: {n_train / 1e6:.3f}M "
          f"(lora_rank={args.lora_rank}, attn={args.attn_mode})")
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

    put = pinned_put(device, keys=("latents", "text_embed", "text_mask", "pooled"))
    host_iter = itertools.chain([batch0], loader)
    dev_iter = (DevicePrefetcher(host_iter, put, depth=args.prefetch_depth)
                if args.prefetch_depth > 0 else map(put, host_iter))
    profiler = contextlib.ExitStack()   # holds the trace window while it is open
    t_prev = time.time()
    for step in range(start_step, args.steps):
        check_cpu_mem(args.max_cpu_mem_percent)
        if args.profile_dir and step == start_step + args.profile_start:
            profiler.enter_context(profile_trace(args.profile_dir))
        state, metrics = train_step(state, base, next(dev_iter), rng)
        if args.profile_dir and step == start_step + args.profile_start + args.profile_steps:
            profiler.close()
            print(f"profiler trace written to {args.profile_dir}")
        if main_rank and step % args.log_every == 0:
            loss = float(metrics["loss"])  # device sync = true step timing
            now = time.time()
            dt = now - t_prev
            t_prev = now
            steps_done = max(1, args.log_every if step > start_step else 1)
            sps = args.batch * steps_done / dt
            print(f"step {step} loss {loss:.4f} | {dt / steps_done:.3f}s/step "
                  f"| {sps:.2f} samples/s | {sps * T:.1f} frames/s")
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            to_save = dict(state.params)
            if base is not None:
                to_save["wan_base"] = base
            ckpt = os.path.join(args.out_dir, f"ckpt_{step + 1}")
            if args.ckpt_async:
                # every rank writes its shard: the device->host copy here,
                # the file IO on a background thread
                save_checkpoint_sharded(ckpt, to_save, None, step + 1, state.ema_params,
                                        _save_meta(meta, loader), async_save=True)
            elif main_rank:
                save_checkpoint(ckpt, to_save, None, step + 1, state.ema_params,
                                _save_meta(meta, loader))
    profiler.close()   # the run ended inside the window
    if args.ckpt_async:
        wait_for_async_saves()   # the last checkpoint must be durable
    if hasattr(dev_iter, "close"):
        dev_iter.close()   # stop the prefetch thread, free queued batches
    return state


if __name__ == "__main__":
    main()
