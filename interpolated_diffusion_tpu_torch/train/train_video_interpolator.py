"""TinyTemporalInterpolator trainer on toy-video or wansynth latents (port of
train/train_video_interpolator.py).

    python -m interpolated_diffusion_tpu_torch.train.train_video_interpolator [--workload toy|wansynth] [flags]

K random anchor frames per clip (endpoints kept), the lerp between them
refined by the depthwise temporal conv (models/interpolators.py) as a
residual, MSE on the hidden frames. AdamW behind a global-norm clip, no EMA;
the model computes in bf16 under `--bf16 1`. No kernel runs (the conv is a
cuDNN depthwise convolution, as XLA's is on the TPU side). Runs on the GPU
unless `--device cpu`.

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
"""
from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from ..data.dataset import BatchLoader
from ..data.toy_video import MovingShapesVideoDataset
from ..models.interpolators import TinyTemporalInterpolator
from ..ops.keyframes import interpolate_from_indices, sample_fixed_k_indices_batch
from ..parallel.mesh import dp_sum, shard_batch
from .batches import gather_keypoints
from .common import build_seeded, data_mesh, resolve_device
from .interp_common import Draws, make_state, setup, train_loop
from .state import TrainState
from .wansynth_common import add_wansynth_data_args


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_video_interpolator")
    p.add_argument("--workload", type=str, default="toy", choices=["toy", "wansynth"])
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--kernel_size", type=int, default=3)
    p.add_argument("--n_conv_layers", type=int, default=2)
    p.add_argument("--latent_size", type=int, default=16)
    add_wansynth_data_args(p)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/video_interp")
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--n_data_shards", type=int, default=None,
                   help="DP width; defaults to all local devices (the processes of a "
                        "torchrun launch, one per GPU)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def data_dim_of(args) -> int:
    if args.workload == "toy":
        return 3 * args.latent_size ** 2
    return args.latent_c * args.latent_h * args.latent_w


def build_model(args, device: torch.device) -> TinyTemporalInterpolator:
    return build_seeded(TinyTemporalInterpolator, args, device, data_dim=data_dim_of(args),
                        kernel_size=args.kernel_size, n_layers=args.n_conv_layers)


def interpolator_loss(model: TinyTemporalInterpolator, args, batch: Dict[str, torch.Tensor],
                      rng: Union[torch.Generator, Draws]):
    """Hidden-frame MSE of the refined lerp (z [B, T, D]). `rng` is a
    generator or {"idx_rand": [B, T - 2] uniforms} (the anchors' draw)."""
    z0 = batch["z"].float()
    B, T, D = z0.shape
    rand = (rng["idx_rand"] if isinstance(rng, dict)
            else torch.rand((B, T - 2), generator=rng, device=rng.device))
    idx, mask = sample_fixed_k_indices_batch(B, T, args.K, rand=rand.to(z0.device))
    z_lerp = interpolate_from_indices(idx, gather_keypoints(z0, idx), T)
    z_hat = z_lerp + model(z_lerp)
    hidden = (~mask)[..., None].float()
    return dp_sum((((z_hat - z0) ** 2) * hidden).sum()) / (dp_sum(hidden.sum()) * D + 1e-8), {}


def run_meta(args) -> Dict:
    return {"stage": "video_interpolator", "T": args.T, "K": args.K,
            "kernel_size": args.kernel_size, "n_layers": args.n_conv_layers,
            "data_dim": data_dim_of(args), "workload": args.workload}


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    if args.workload == "toy":
        device = resolve_device(args.device)
        mesh = data_mesh(args)
        ds = MovingShapesVideoDataset(T=args.T, n_samples=args.num_samples, seed=args.seed,
                                      latent_size=args.latent_size)
        # every rank draws the global batch and keeps its rows
        loader = (shard_batch(b, mesh) for b in BatchLoader(ds, batch_size=args.batch,
                                                            seed=args.seed))
        batch0, key = next(loader), "x"
    else:
        device, loader, batch0 = setup(args)
        key = "latents"
    model = build_model(args, device)
    print(f"video interpolator params: {sum(p.numel() for p in model.parameters())} "
          f"| device: {device} | workload: {args.workload}", flush=True)
    loss_fn = lambda params, batch, rng: interpolator_loss(model, args, batch, rng)
    state, train_step = make_state(model, args, loss_fn)
    flat = lambda b: {"z": b[key].reshape(b[key].shape[0], b[key].shape[1], -1)}
    return train_loop(args, device, loader, batch0, state, train_step, (key,), run_meta(args),
                      prepare=flat)


if __name__ == "__main__":
    main()
