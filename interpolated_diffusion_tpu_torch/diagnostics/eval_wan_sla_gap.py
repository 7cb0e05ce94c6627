"""SLA-vs-dense attention gap on the Wan DiT (port of
diagnostics/eval_wan_sla_gap.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.eval_wan_sla_gap \\
        [--attn_mode sla|sage_sla] [--wan_pretrained FILE.safetensors] [--max_batches 4] [--device cpu]

Runs two WanDiT forwards with the same base weights, one dense and one
block-sparse + linear (`sla`, or int8 `sage_sla`), on q-sampled wan-synth
latents, and reports the eps MSE of each and the prediction gap
MSE(pred_sla, pred_dense): how much accuracy the sparse attention trades for
its speed, on the actual noising distribution. On the GPU the sparse model's
self-attention runs the SLA (or int8 SLA) kernel and every other attention
the flash kernel (L >= 2048), the dense model's self- and cross-attention
too. The SLA model carries the zero-initialised linear-branch projections
the dense model lacks; the dense model takes every parameter it shares with
the SLA model by a state-dict copy (`copy_intersecting`), which must cover
all of its own. The per-batch (t, eps) draws are the `draws` argument of
`main` (a test hands in the JAX CLI's), else drawn from a torch.Generator
seeded by --seed on the device. Prints the JAX CLI's lines and report.
"""
from __future__ import annotations

import argparse
import copy
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import set_compute_dtype
from ..ops.ddpm import q_sample
from ..ops.schedules import make_schedule
from ..train.common import resolve_device
from ..train.wansynth_common import add_wan_model_args, add_wansynth_data_args, build_wan, \
    make_wansynth_loader


def copy_intersecting(src: torch.nn.Module, dst: torch.nn.Module) -> Tuple[int, int]:
    """Copy every parameter of `src` whose name and shape `dst` also has into
    `dst`; returns (copied, dst's parameter count)."""
    have = dict(dst.named_parameters())
    n = 0
    with torch.no_grad():
        for name, value in src.named_parameters():
            if name in have and tuple(have[name].shape) == tuple(value.shape):
                have[name].copy_(value)
                n += 1
    return n, len(have)


def build_eval_wan(args, device, generator: torch.Generator):
    """The evaluated WanDiT: base weights only (no LoRA, no frame
    conditioning, as the JAX CLI builds it), f32 parameters computing in bf16
    under --bf16, the --wan_pretrained weights over the seeded ones."""
    args = copy.copy(args)
    args.lora_rank, args.frame_cond = 0, 0
    wan, _ = build_wan(args, bool(args.bf16), generator=generator, device=device)
    return set_compute_dtype(wan.requires_grad_(False), torch.bfloat16 if args.bf16 else None)


@torch.no_grad()
def predict_eps(wan, schedule, latents: torch.Tensor, text: torch.Tensor, t: torch.Tensor,
                eps: torch.Tensor) -> torch.Tensor:
    """eps prediction [B, T, C, H, W] f32 of `wan` at q_sample(latents, t, eps)."""
    zt, _ = q_sample(latents.float(), t, schedule, noise=eps)
    pred = wan(zt.permute(0, 2, 1, 3, 4), t, text)
    return pred.permute(0, 2, 1, 3, 4).float()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eval_wan_sla_gap")
    add_wansynth_data_args(p)
    add_wan_model_args(p)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--max_batches", type=int, default=4)
    p.add_argument("--N_train", type=int, default=1000)
    p.add_argument("--schedule", type=str, default="cosine")
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def main(argv=None, draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None):
    args = build_argparser().parse_args(argv)
    if args.attn_mode == "dense":
        args.attn_mode = "sla"   # the comparison needs a sparse mode
    device = resolve_device(args.device)
    loader = make_wansynth_loader(args, args.seed)
    schedule = make_schedule(args.schedule, args.N_train, device=device)

    dense_args = copy.copy(args)
    dense_args.attn_mode = "dense"
    gen = torch.Generator(device=device).manual_seed(args.seed)
    wan_sla = build_eval_wan(args, device, gen)
    wan_dense = build_eval_wan(dense_args, device, gen)
    n_shared, n_dense = copy_intersecting(wan_sla, wan_dense)
    print(f"shared {n_shared}/{n_dense} dense-model leaves from the SLA tree")
    if n_shared != n_dense:
        raise RuntimeError("dense tree has leaves missing from the SLA tree")

    draws = iter(draws) if draws is not None else None
    mses_d, mses_s, gaps = [], [], []
    t0 = time.time()
    for step in range(args.max_batches):
        batch = next(loader)
        lat = torch.as_tensor(np.asarray(batch["latents"])).to(device)
        text = torch.as_tensor(np.asarray(batch["text_embed"])).to(device).float()
        if draws is None:
            t = torch.randint(0, args.N_train, (lat.shape[0],), generator=gen, device=device)
            eps = torch.randn(lat.shape, generator=gen, device=device)
        else:
            t, eps = (torch.as_tensor(a).to(device) for a in next(draws))
        pred_d = predict_eps(wan_dense, schedule, lat, text, t, eps)
        pred_s = predict_eps(wan_sla, schedule, lat, text, t, eps)
        mses_d.append(float(((pred_d - eps) ** 2).mean()))
        mses_s.append(float(((pred_s - eps) ** 2).mean()))
        gaps.append(float(((pred_s - pred_d) ** 2).mean()))
        print(f"batch {step}: mse_dense={mses_d[-1]:.5f} "
              f"mse_{args.attn_mode}={mses_s[-1]:.5f} gap={gaps[-1]:.6f}")

    report = {
        "mse_dense_eps": float(np.mean(mses_d)),
        f"mse_{args.attn_mode}_eps": float(np.mean(mses_s)),
        "mse_sla_vs_dense": float(np.mean(gaps)),
        "mse_ratio": float(np.mean(mses_s) / max(np.mean(mses_d), 1e-12)),
        "elapsed_s": time.time() - t0,
    }
    print(report)
    return report


if __name__ == "__main__":
    main()
