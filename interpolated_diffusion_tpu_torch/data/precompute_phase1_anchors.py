"""Precompute Phase-1 anchors: sample the Wan keyframes of every clip into
tar shards (port of data/precompute_phase1_anchors.py).

    python -m interpolated_diffusion_tpu_torch.data.precompute_phase1_anchors \\
        --ckpt RUN_OR_CKPT --out_root DIR [--data tar --data_root DIR] [flags]

Loads a Phase-1 (keypoints_wansynth) checkpoint of either package, samples
the K anchor frames of each clip (short mode with absolute-time RoPE;
sample/wan_anchors.py: --solver ddim|pfdiff|dpm, FORA block caching
--cache_interval, the timestep-adaptive --sla_topk_schedule, the
--attn_mode / --sla_topk overrides) and writes `{key}.anchors.npy` (f32
[K, C, H, W]) and `{key}.anchor_idx.npy` (int32 [K]) shards. In tar mode the
output shards mirror the source shards' basenames, which is how the Phase-2
trainer's key join (--anchors_root) pairs them; synthetic data writes
`anchors_{i:05d}.tar` for inspection only. Writes `prep_config.json` and
prints the steady-state samples/s (the first batch excluded). A use_wan 0
checkpoint samples through its token denoiser (ddim, pfdiff or dpm). Runs on
the GPU unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import loading
from ..ops.keyframes import sample_fixed_k_indices_uniform_batch
from ..ops.schedules import make_schedule
from ..sample.wan_anchors import AnchorConfig, make_anchor_sampler
from ..train.common import resolve_device
from ..utils.checkpoint import read_meta
from .wan_synth import SyntheticWanDataset, iter_tar_samples, list_shards, write_tar_shard


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("precompute_phase1_anchors")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out_root", type=str, required=True)
    p.add_argument("--data", type=str, default="synthetic", choices=["synthetic", "tar"])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--shard_size", type=int, default=64)
    p.add_argument("--ddim_steps", type=int, default=4)
    p.add_argument("--solver", type=str, default="ddim", choices=["ddim", "pfdiff", "dpm"],
                   help="pfdiff: ~half the model evals per anchor; dpm: DPM-Solver++(2M). "
                        "Both exclude --cache_interval > 1")
    p.add_argument("--cache_interval", type=int, default=1,
                   help="FORA block caching: run the Wan block stack every Nth step and "
                        "reuse its residual in between (1 = exact; use_wan only)")
    p.add_argument("--attn_mode", type=str, default=None,
                   choices=["dense", "flash", "sla", "sage_sla"],
                   help="override the checkpoint's attention mode for sampling")
    p.add_argument("--sla_topk", type=float, default=None)
    p.add_argument("--sla_topk_schedule", type=str, default="",
                   help="timestep-adaptive sparsity 'frac:topk,frac:topk', e.g. "
                        "'0.5:0.05,1.0:0.1' (sla / sage_sla + use_wan only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def parse_topk_schedule(spec: str) -> Optional[List[Tuple[float, float]]]:
    """'0.5:0.05,1.0:0.1' -> [(0.5, 0.05), (1.0, 0.1)] (validated)."""
    if not spec:
        return None
    segs = []
    for part in spec.split(","):
        frac, tk = part.split(":")
        segs.append((float(frac), float(tk)))
    if any(b[0] <= a[0] for a, b in zip(segs, segs[1:])):
        raise ValueError(f"schedule fractions must increase: {spec}")
    if abs(segs[-1][0] - 1.0) > 1e-6:
        raise ValueError(f"schedule must end at frac 1.0: {spec}")
    return segs


def make_anchor_draws(generator: torch.Generator, B: int, T: int, K: int, N: int,
                      D_tok: int) -> Dict[str, torch.Tensor]:
    """One batch's draws (on the generator's device): "idx_rand" [B, K], the
    anchor jitter's uniforms, and "z" [B, K, N, D_tok], the initial noise."""
    dev = generator.device
    return {"idx_rand": torch.rand((B, K), generator=generator, device=dev),
            "z": torch.randn((B, K, N, D_tok), generator=generator, device=dev)}


def main(argv=None) -> Dict:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    path = loading.resolve_ckpt(args.ckpt)
    _, meta = read_meta(path)
    if meta.get("stage") != "keypoints_wansynth":
        raise ValueError(f"{path} is not a Phase-1 wansynth checkpoint")
    T, K = int(meta["T"]), int(meta["K"])
    C, H, W = int(meta["latent_c"]), int(meta["latent_h"]), int(meta["latent_w"])
    p_sz = int(meta["patch_size"])
    N, D_tok = (H // p_sz) * (W // p_sz), C * p_sz * p_sz
    use_wan = bool(meta.get("use_wan"))
    topk_schedule = parse_topk_schedule(args.sla_topk_schedule)
    if use_wan:
        over = dict(sla_block=128, frame_cond_dim=5)
        if args.attn_mode:
            over["attn_mode"] = args.attn_mode
        if args.sla_topk is not None:
            over["sla_topk"] = args.sla_topk
        model, fc, _ = loading.load_wansynth_model(path, "keypoints_wansynth", bool(args.bf16),
                                                   device, **over)
    else:
        model, fc, _ = loading.load_wansynth_model(path, "keypoints_wansynth", bool(args.bf16),
                                                   device, use_ema=True)
    schedule = make_schedule(meta["schedule"], int(meta["N_train"]), device=device)
    cfg = AnchorConfig(T=T, K=K, latent_c=C, latent_h=H, latent_w=W, patch_size=p_sz,
                       n_train=int(meta["N_train"]), schedule=meta["schedule"],
                       ddim_steps=args.ddim_steps, frame_cond=bool(meta.get("frame_cond", 0)),
                       solver=args.solver, cache_interval=args.cache_interval,
                       topk_schedule=topk_schedule)
    sample_anchors = make_anchor_sampler(cfg, model, fc, schedule)

    # output shards mirror the source shards' basenames (the Phase-2 key join
    # pairs data shard X with anchors_root/X); synthetic data cannot be joined
    if args.data == "tar":
        if not args.data_root:
            raise ValueError("--data_root required for --data tar")

        def shard_groups():
            for sh in list_shards(args.data_root):
                yield os.path.basename(sh), iter_tar_samples(sh)
    else:
        ds = SyntheticWanDataset(n_samples=args.num_samples, T=T, C=C, H=H, W=W,
                                 text_dim=int(meta["text_dim"]), seed=args.seed)

        def shard_groups():
            for shard_id, lo in enumerate(range(0, args.num_samples, args.shard_size)):
                idxs = range(lo, min(args.num_samples, lo + args.shard_size))
                yield (f"anchors_{shard_id:05d}.tar",
                       iter({"__key__": f"{i:08d}", **ds.get(i)} for i in idxs))

    def batched(it):
        items = []
        for s in it:
            items.append(s)
            if len(items) == args.batch:
                yield items
                items = []
        if items:
            yield items

    generator = torch.Generator(device=device).manual_seed(args.seed)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    done, n_shards, t_start, n_timed = 0, 0, None, 0
    os.makedirs(args.out_root, exist_ok=True)
    for out_name, sample_iter in shard_groups():
        out_samples = []
        for items in batched(sample_iter):
            B = len(items)
            draws = make_anchor_draws(generator, B, T, K, N, D_tok)
            idx, _ = sample_fixed_k_indices_uniform_batch(
                B, T, K, ensure_endpoints=False, jitter=0.5, rand=draws["idx_rand"])
            text = torch.from_numpy(np.stack([np.asarray(it["text_embed"], np.float32)
                                              for it in items])).to(device)
            anchors = sample_anchors(draws["z"].to(device), idx.to(device), text)
            anchors = anchors.float().cpu().numpy()   # the copy synchronises
            idx_np = idx.cpu().numpy()
            sync()
            if t_start is None:
                t_start = time.time()   # after the first batch (warm-up, kernel builds)
            else:
                n_timed += B
            for b, it in enumerate(items):
                out_samples.append({"__key__": it["__key__"],
                                    "anchors": anchors[b].astype(np.float32),
                                    "anchor_idx": idx_np[b].astype(np.int32)})
            done += B
            print(f"anchored {done} samples")
        if out_samples:
            write_tar_shard(os.path.join(args.out_root, out_name), out_samples)
            n_shards += 1
    sps = n_timed / (time.time() - t_start) if t_start is not None and n_timed else None
    if sps:
        print(f"steady-state throughput: {sps:.3f} samples/s (excl. first batch)")
    with open(os.path.join(args.out_root, "prep_config.json"), "w") as f:
        json.dump({"args": vars(args), "meta": meta, "samples_per_sec": sps}, f, indent=2,
                  default=str)
    print(f"wrote {n_shards} shards to {args.out_root}")
    return {"n_shards": n_shards, "samples": done, "samples_per_sec": sps}


if __name__ == "__main__":
    main()
