"""Precompute teacher mid-frame latents into key-joined tar shards (port of
data/precompute_teacher.py).

    python -m interpolated_diffusion_tpu_torch.data.precompute_teacher \
        --data_root DIR --out_root DIR [flags]

Teachers: `lerp` (built in), `model:<ckpt>` (a trained flow_interpolator
or sinkhorn_interp checkpoint of either package, on `--device`, cuda
unless asked), or `ldmvfi`, which needs the external LDMVFI repository and
is refused as the JAX CLI refuses it. The shards carry the source shards'
basenames, so WanSynthTarDataset(teacher_root=...) joins them back.
"""
from __future__ import annotations

import argparse
import os

from ..teachers.teacher import LerpTeacher, ModelTeacher, precompute_teacher_shards


def make_teacher(name: str, device: str = "cuda"):
    if name == "lerp":
        return LerpTeacher()
    if name.startswith("model:"):
        from ..train.common import resolve_device

        return ModelTeacher(name.split(":", 1)[1], device=resolve_device(device))
    if name == "ldmvfi":
        raise SystemExit(
            "ldmvfi teacher needs the external LDMVFI repository and its GPU stack, which are "
            "not part of this repository; use --teacher lerp or --teacher model:<interpolator "
            "ckpt>, or precompute on a machine that has it")
    raise ValueError(f"unknown teacher {name}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("precompute_teacher")
    p.add_argument("--data_root", type=str, required=True, help="wan-synth tar shard directory")
    p.add_argument("--out_root", type=str, required=True)
    p.add_argument("--T", type=int, default=21)
    p.add_argument("--teacher", type=str, default="lerp",
                   help="lerp | model:<interpolator ckpt> | ldmvfi")
    p.add_argument("--shard_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="where a model teacher runs: cuda (default; no fallback) or cpu")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    teacher = make_teacher(args.teacher, args.device)
    os.makedirs(args.out_root, exist_ok=True)
    n = precompute_teacher_shards(args.data_root, args.out_root, args.T, teacher=teacher,
                                  shard_size=args.shard_size)
    print(f"wrote teacher shards for {n} clips under {args.out_root}", flush=True)
    return n


if __name__ == "__main__":
    main()
