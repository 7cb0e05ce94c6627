"""Stage-2 (Phase-2) wansynth evaluation: refined-vs-lerp latent MSE (port of
diagnostics/eval_wansynth_stage2.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.eval_wansynth_stage2 \\
        --p2_ckpt RUN_OR_CKPT --data_root DIR --anchors_root DIR [flags]

Loads a Phase-2 checkpoint of either package (the port's, or a JAX
directory with params.msgpack), joins the tar data stream with the Phase-1
anchor shards and runs the level loop levels -> 1 from the lerp between the
anchors, twice: from the ground-truth anchor frames (confidence 0.95, the
oracle bound) and from the precomputed Phase-1 anchors (confidence 0.5, the
production path). Reports the latent token MSE of {gt, p1} x {lerp,
refined} and the Phase-1 anchors' own MSE; a working Stage 2 moves
`refined` below `lerp` at the same anchors. The nested masks grow from the
anchor frames (ops/keyframes.build_nested_masks_from_base) with their
uniforms drawn per batch (`make_eval_draws`). Writes summary.json
({anchor_mse_p1, lerp_gt_mse, refined_gt_mse, lerp_p1_mse, refined_p1_mse,
samples_per_sec, p2_ckpt, stage2_helps_gt, stage2_helps_p1}),
run_config.json and the evidence archive. Runs on the GPU unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from ..models import loading
from ..ops.keyframes import build_nested_masks_from_base
from ..ops.video_keyframes import interpolate_video_from_indices
from ..train.common import resolve_device
from ..train.train_interp_levels_wansynth import FRAME_FEATURES, level_features
from ..train.wansynth_common import make_wansynth_loader
from ..utils.checkpoint import read_meta
from ..utils.run_config import archive_evidence, write_run_config
from ..utils.video_tokens import patchify_latents, unpatchify_tokens

MSE_KEYS = ("anchor_mse_p1", "lerp_gt_mse", "refined_gt_mse", "lerp_p1_mse", "refined_p1_mse")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eval_wansynth_stage2")
    p.add_argument("--p2_ckpt", type=str, required=True)
    p.add_argument("--p1_ckpt", type=str, default=None,
                   help="unused (anchors come from --anchors_root); kept so that pipelines "
                        "can record the provenance pair")
    p.add_argument("--data", type=str, default="tar")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--anchors_root", type=str, required=True)
    p.add_argument("--T", type=int, default=21)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--num_batches", type=int, default=8)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/eval_wansynth_stage2")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def load_stage2(path: str, bf16: bool, device, **kw):
    """(model, fc, meta) of a Phase-2 checkpoint: the WanDiT with its frame
    projector (frame_cond_dim 6 + 1 in adj mode), or the token model."""
    _, meta = read_meta(loading.resolve_ckpt(path))
    fc_dim = FRAME_FEATURES + (1 if meta.get("mode", "adj") == "adj" else 0)
    return loading.load_wansynth_model(path, "interp_levels_wansynth", bf16, device,
                                       frame_cond=1, frame_cond_dim=fc_dim, **kw)


def make_eval_draws(generator: torch.Generator, B: int, T: int) -> Dict[str, torch.Tensor]:
    """One batch's draws: "mask_rand" [B, T], the uniforms that rank the
    frames the nested masks add to the anchors."""
    return {"mask_rand": torch.rand((B, T), generator=generator, device=generator.device)}


def make_stage2_eval(model, fc, meta: Dict):
    """run(latents [B, T, C, H, W], text [B, L, text_dim], anchors [B, K, C,
    H, W], anchor_idx [B, K], mask_rand [B, T]) -> {MSE_KEYS: 0-d f32
    tensors}, on the inputs' device, without gradients."""
    T, levels = int(meta["T"]), int(meta["levels"])
    mode, p_sz = meta.get("mode", "adj"), int(meta["patch_size"])
    use_wan = bool(meta.get("use_wan"))
    level_t_scale = int(meta.get("level_t_scale", 100))

    def apply_level(x_tok, s, mask_s, mask_prev, conf, text, spatial):
        """One refinement step: x_{s-1} = x_s + delta_hat."""
        B, _, N, _ = x_tok.shape
        if use_wan:
            s_b = torch.full((B,), s * level_t_scale, dtype=torch.long, device=x_tok.device)
            extra = fc(level_features(mask_s, conf, mask_prev if mode == "adj" else None))
            lat = unpatchify_tokens(x_tok, p_sz, spatial).transpose(1, 2)
            delta = patchify_latents(model(lat, s_b, text, None, extra).transpose(1, 2),
                                     p_sz)[0]
        else:
            chans = [mask_s] + ([mask_prev] if mode == "adj" else [])
            mask_in = torch.stack([c[:, :, None].expand(B, T, N).float() for c in chans]
                                  + [conf[:, :, None].expand(B, T, N)], dim=-1)
            s_b = torch.full((B,), s, dtype=torch.long, device=x_tok.device)
            delta = model(x_tok, s_b, mask_in, {"text_embed": text}, spatial)
        return x_tok + delta

    @torch.inference_mode()
    def run(latents, text, anchors, anchor_idx, mask_rand):
        tokens, spatial = patchify_latents(latents.float(), p_sz)       # [B, T, N, D]
        a_tok = patchify_latents(anchors.float(), p_sz)[0]              # [B, K, N, D]
        idx = anchor_idx.long()
        B, _, N, D = tokens.shape
        gt_vals = torch.gather(tokens, 1, idx[..., None, None].expand(-1, -1, N, D))
        masks_levels, _ = build_nested_masks_from_base(
            idx, T, levels, k_schedule=meta.get("k_schedule", "doubling"), rand=mask_rand)
        out = {"anchor_mse_p1": ((a_tok - gt_vals) ** 2).mean()}
        for name, vals, conf_a in (("gt", gt_vals, 0.95), ("p1", a_tok, 0.5)):
            lerp = interpolate_video_from_indices(idx, vals.reshape(B, vals.shape[1], -1),
                                                  T).reshape(B, T, N, D)
            x = lerp
            for s in range(levels, 0, -1):
                mask_s, mask_prev = masks_levels[:, s], masks_levels[:, s - 1]
                conf = torch.where(mask_s, conf_a, 0.0).float()
                x = apply_level(x, s, mask_s, mask_prev, conf, text, spatial)
            out[f"lerp_{name}_mse"] = ((lerp - tokens) ** 2).mean()
            out[f"refined_{name}_mse"] = ((x - tokens) ** 2).mean()
        return out

    return run


def main(argv=None) -> Dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    path = loading.resolve_ckpt(args.p2_ckpt)
    _, meta = read_meta(path)
    if meta.get("stage") != "interp_levels_wansynth":
        raise ValueError(f"{path} is not a Phase-2 checkpoint")
    model, fc, meta = load_stage2(path, bool(args.bf16), device)
    run = make_stage2_eval(model, fc, meta)
    C, H, W = (int(meta[k]) for k in ("latent_c", "latent_h", "latent_w"))
    dns = argparse.Namespace(data=args.data, data_root=args.data_root, T=args.T,
                             anchors_root=args.anchors_root, batch=args.batch,
                             num_samples=10 ** 9, latent_c=C, latent_h=H, latent_w=W,
                             text_len=8, text_dim=int(meta["text_dim"]))
    loader = make_wansynth_loader(dns, args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    agg: Dict[str, list] = {}
    t0, n = time.time(), 0
    for bi in range(args.num_batches):
        batch = next(loader)
        B = batch["latents"].shape[0]
        draws = make_eval_draws(generator, B, int(meta["T"]))
        out = run(to_dev(batch["latents"]), to_dev(batch["text_embed"]), to_dev(batch["anchors"]),
                  to_dev(batch["anchor_idx"]), draws["mask_rand"])
        out = {k: float(v) for k, v in out.items()}   # the copy synchronises
        n += B
        for k, v in out.items():
            agg.setdefault(k, []).append(v)
        print(f"batch {bi}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(out.items())))
    summary = {k: float(np.mean(v)) for k, v in agg.items()}
    summary["samples_per_sec"] = n / max(time.time() - t0, 1e-9)
    summary["p2_ckpt"] = path
    summary["stage2_helps_gt"] = bool(summary["refined_gt_mse"] < summary["lerp_gt_mse"])
    summary["stage2_helps_p1"] = bool(summary["refined_p1_mse"] < summary["lerp_p1_mse"])
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    write_run_config(args.out_dir, args)
    archive_evidence(args.out_dir)
    print("summary:", json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
