"""Write the synthetic wan-synth dataset as tar shards (port of
data/make_synth_tars.py).

    python -m interpolated_diffusion_tpu_torch.data.make_synth_tars --out_root DIR [flags]

The key-join paths (precomputed anchors, teacher latents) are defined over
tar shards; the in-memory SyntheticWanDataset cannot join them. This writes
the same seeded samples (same seed, same latents and text) as
`{key}.{field}.npy` members of `shard_{i:05d}.tar`, so that every tar-mode
feature (anchor joins, shard shuffling) runs on synthetic data.
"""
from __future__ import annotations

import argparse
import os

from .wan_synth import SyntheticWanDataset, write_tar_shard


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("make_synth_tars")
    p.add_argument("--out_root", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--T", type=int, default=21)
    p.add_argument("--latent_c", type=int, default=16)
    p.add_argument("--latent_h", type=int, default=60)
    p.add_argument("--latent_w", type=int, default=104)
    p.add_argument("--text_len", type=int, default=512)
    p.add_argument("--text_dim", type=int, default=4096)
    p.add_argument("--shard_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    ds = SyntheticWanDataset(n_samples=args.num_samples, T=args.T, C=args.latent_c,
                             H=args.latent_h, W=args.latent_w, text_len=args.text_len,
                             text_dim=args.text_dim, seed=args.seed)
    os.makedirs(args.out_root, exist_ok=True)
    n_shards = 0
    for shard_id, lo in enumerate(range(0, args.num_samples, args.shard_size)):
        idxs = range(lo, min(args.num_samples, lo + args.shard_size))
        write_tar_shard(os.path.join(args.out_root, f"shard_{shard_id:05d}.tar"),
                        [{"__key__": f"{i:08d}", **ds.get(i)} for i in idxs])
        n_shards += 1
    print(f"wrote {args.num_samples} samples in {n_shards} shards to {args.out_root}")
    return n_shards


if __name__ == "__main__":
    main()
