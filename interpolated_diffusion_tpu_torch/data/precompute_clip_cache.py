"""Precompute DiDeMo / LSMDC latent + text caches (port of
data/precompute_clip_cache.py).

    python -m interpolated_diffusion_tpu_torch.data.precompute_clip_cache --cache_dir DIR [flags]

Decodes the annotated clips (data/didemo.read_video_clip), VAE-encodes the
frames to latents (models/frame_vae.TorchFrameVAE, a pretrained diffusers
AutoencoderKL; `--vae none` keeps the frames), CLIP-encodes the captions
(models/clip_text.py, unpooled [77, 512] for ViT-B/32) and writes
CachedClipDataset shards. The real path needs the corpus, `diffusers`,
`transformers` and their weights. With `--synthetic 1` it writes a cache of
procedural toy videos ([T, 3, 16, 16] latents, [1, 64] text) that is the
JAX CLI's bit for bit at the same flags.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .didemo import (
    load_didemo_annotations,
    load_lsmdc_annotations,
    read_video_clip,
    write_clip_cache,
)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("precompute_clip_cache")
    p.add_argument("--dataset", type=str, default="didemo", choices=["didemo", "lsmdc"])
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--video_dir", type=str, default=None)
    p.add_argument("--annotation_csv", type=str, default=None)
    p.add_argument("--cache_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--T", type=int, default=16)
    p.add_argument("--frame_size", type=int, default=64)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--shard_size", type=int, default=256)
    p.add_argument("--vae", type=str, default="torch", choices=["torch", "none"])
    p.add_argument("--clip_model", type=str, default="openai/clip-vit-base-patch32")
    p.add_argument("--synthetic", type=int, default=0,
                   help="build the cache from procedural toy videos instead")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    samples = []
    if args.synthetic:
        from .toy_video import MovingShapesVideoDataset

        ds = MovingShapesVideoDataset(T=args.T, H=args.frame_size,
                                      n_samples=args.max_samples or 64,
                                      seed=args.seed, latent_size=16)
        rng = np.random.RandomState(args.seed)
        for i in range(len(ds)):
            z = ds.get(i)["x"].reshape(args.T, 3, 16, 16)
            samples.append({
                "latents": z.astype(np.float32),
                "text_embed": rng.randn(1, 64).astype(np.float32) * 0.02,
            })
    else:
        if args.dataset == "didemo":
            anns = load_didemo_annotations(args.data_dir, args.split)
        else:
            anns = load_lsmdc_annotations(args.annotation_csv)
        if args.max_samples:
            anns = anns[: args.max_samples]
        vae = None
        if args.vae == "torch":
            from ..models.frame_vae import TorchFrameVAE

            vae = TorchFrameVAE()
        from ..models.clip_text import CLIPTextEncoder

        clip = CLIPTextEncoder(args.clip_model)
        for i, ann in enumerate(anns):
            path = os.path.join(args.video_dir, ann["video"])
            try:
                frames = read_video_clip(path, ann["start_sec"], ann["end_sec"],
                                         args.T, args.frame_size)
            except Exception as e:  # decode-failure retry on neighbour
                print(f"skip {ann['video']}: {e}")
                continue
            if vae is not None:
                lat = vae.encode(frames[None])[0]
            else:
                lat = frames
            text = clip.encode([ann["caption"]], pooled=False)[0]
            samples.append({"latents": lat.astype(np.float32),
                            "text_embed": text.astype(np.float32)})
            if i % 50 == 0:
                print(f"cached {i}/{len(anns)}")
    write_clip_cache(args.cache_dir, args.split, samples, args.shard_size)
    print(f"wrote {len(samples)} samples to {args.cache_dir}/{args.split}")


if __name__ == "__main__":
    main()
