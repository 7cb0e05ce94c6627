"""Full-sequence eps-prediction MSE of a Wan DiT on wan-synth latents (port of
diagnostics/eval_wan_fullseq_eps.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.eval_wan_fullseq_eps \\
        [--attn_mode sla|sage_sla|dense|flash] [--wan_pretrained FILE.safetensors] [--device cpu]

How well a (pretrained or trained) Wan backbone predicts eps on full-length
T-frame noised latents under any attention mode: the baseline that the
Phase-1 training and the SLA approximations are measured against. One
forward a batch (the attention kernels of that mode on the GPU), the EMA
(0.98) of the MSE on the host. The per-batch (t, eps) draws are the `draws`
argument of `main`, else drawn from a torch.Generator seeded by --seed on
the device. Prints the JAX CLI's lines and returns the EMA.
"""
from __future__ import annotations

import argparse
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops.schedules import make_schedule
from ..train.common import resolve_device
from ..train.wansynth_common import add_wan_model_args, add_wansynth_data_args, \
    make_wansynth_loader
from .eval_wan_sla_gap import build_eval_wan, predict_eps


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eval_wan_fullseq_eps")
    add_wansynth_data_args(p)
    add_wan_model_args(p)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--max_batches", type=int, default=8)
    p.add_argument("--N_train", type=int, default=1000)
    p.add_argument("--schedule", type=str, default="cosine")
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def main(argv=None, draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    loader = make_wansynth_loader(args, args.seed)
    schedule = make_schedule(args.schedule, args.N_train, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    wan = build_eval_wan(args, device, gen)

    draws = iter(draws) if draws is not None else None
    ema, ema_beta = 0.0, 0.98
    T = args.T
    start = time.time()
    for step in range(args.max_batches):
        batch = next(loader)
        lat = torch.as_tensor(np.asarray(batch["latents"])).to(device)
        text = torch.as_tensor(np.asarray(batch["text_embed"])).to(device).float()
        T = lat.shape[1]
        if draws is None:
            t = torch.randint(0, args.N_train, (lat.shape[0],), generator=gen, device=device)
            eps = torch.randn(lat.shape, generator=gen, device=device)
        else:
            t, eps = (torch.as_tensor(a).to(device) for a in next(draws))
        mse = float(((predict_eps(wan, schedule, lat, text, t, eps) - eps) ** 2).mean())
        ema = mse if step == 0 else ema_beta * ema + (1 - ema_beta) * mse
        if step % args.log_every == 0:
            sps = (step + 1) * lat.shape[0] / max(time.time() - start, 1e-8)
            print(f"step {step}: mse_eps={mse:.5f} ema={ema:.5f} "
                  f"t_mean={float(t.float().mean()):.0f} | {sps:.2f} samples/s")
    print({"mse_eps_ema": ema, "attn_mode": args.attn_mode, "T": T})
    return ema


if __name__ == "__main__":
    main()
