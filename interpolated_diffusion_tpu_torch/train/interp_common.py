"""What the five wansynth interpolator / selector trainers share: their
common arguments, the set-up (device, data), the optimiser state, the triplet
draws of the flow and straightener trainers, and the training loop (log
line, run_config.json, checkpoints).

Each trainer's loss takes its random draws as an argument (a dict, or a
torch.Generator to draw them from), so that a test can hand in JAX's.
Models hold f32 master parameters and compute in bf16 under `--bf16 1`, as
the JAX trainers' `dtype=bfloat16` over f32 params. Under torchrun each rank
trains on its rows of the batch (the loader yields them,
train/wansynth_common.make_wansynth_loader) and rank 0 logs and saves.
"""
from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..utils.checkpoint import save_checkpoint
from ..utils.memguard import check_cpu_mem
from ..utils.prefetch import DevicePrefetcher, pinned_put
from ..parallel.multihost import is_main_process
from .common import data_mesh, model_params, resolve_device, write_run_config
from .state import TrainState, init_train_state, make_optimizer, make_train_step
from .wansynth_common import add_wansynth_data_args, make_wansynth_loader

Draws = Dict[str, torch.Tensor]


def add_interp_train_args(p: argparse.ArgumentParser, *, batch: int, steps: int, lr: float,
                          weight_decay: float, bf16: int, out_dir: str, save_every: int) -> None:
    """The data, optimisation and run flags of the JAX trainers, with their
    per-trainer defaults, and --device (cuda unless asked; no fallback)."""
    add_wansynth_data_args(p)
    p.add_argument("--batch", type=int, default=batch)
    p.add_argument("--steps", type=int, default=steps)
    p.add_argument("--lr", type=float, default=lr)
    p.add_argument("--weight_decay", type=float, default=weight_decay)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--bf16", type=int, default=bf16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default=out_dir)
    p.add_argument("--save_every", type=int, default=save_every)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--n_data_shards", type=int, default=None,
                   help="DP width; defaults to all local devices (the processes of a "
                        "torchrun launch, one per GPU)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")


def setup(args):
    """(device, loader of this rank's rows, first batch); raises when
    --device cuda finds no GPU and when --n_data_shards asks for more shards
    than the run has processes."""
    device = resolve_device(args.device)
    loader = make_wansynth_loader(args, args.seed, mesh=data_mesh(args))
    return device, loader, next(loader)


def make_state(model: torch.nn.Module, args, loss_fn) -> Tuple[TrainState, Callable]:
    """AdamW behind a global-norm clip over every parameter, no EMA."""
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    return (init_train_state(model_params(model), tx, use_ema=False),
            make_train_step(loss_fn, mesh=data_mesh(args)))


def make_triplet_draws(generator: torch.Generator, B: int, T: int, min_gap: int) -> Draws:
    """The flow / straightener trainers' draws: gap in [min_gap, T), t0 in [0, T)."""
    dev = generator.device
    return {"gap": torch.randint(min_gap, T, (B,), generator=generator, device=dev),
            "t0": torch.randint(0, T, (B,), generator=generator, device=dev)}


def take_triplets(latents: torch.Tensor, draws: Draws):
    """(z0, z1, zt, alpha, gap) of triplets t0 < tm < t1 = t0 + gap (clipped
    to the clip): the anchors, the midpoint target, its alpha and the gap, f32."""
    T = latents.shape[1]
    gap, t0 = draws["gap"].long(), draws["t0"].long()
    t0 = t0 % torch.clamp(T - gap, min=1)
    t1 = torch.clamp(t0 + gap, max=T - 1)
    tm = (t0 + t1) // 2
    alpha = (tm - t0).float() / torch.clamp(t1 - t0, min=1).float()
    b = torch.arange(latents.shape[0], device=latents.device)
    return latents[b, t0], latents[b, t1], latents[b, tm], alpha, (t1 - t0).float()


def draws_or(rng: Union[torch.Generator, Draws], make: Callable[[torch.Generator], Draws]
             ) -> Draws:
    return rng if isinstance(rng, dict) else make(rng)


def train_loop(args, device: torch.device, loader, batch0: Dict, state: TrainState, train_step,
               keys: Sequence[str], meta: Dict, *, prefetch: bool = True,
               prepare: Optional[Callable[[Dict], Dict]] = None,
               after_step: Optional[Callable[[int, TrainState, Dict], None]] = None,
               log_keys: Sequence[str] = ()) -> TrainState:
    """The JAX trainers' loop: batch0, then the loader's batches, one step
    each, the log line every --log_every steps (and the last), a checkpoint
    every --save_every steps and at the end. `prepare` turns a device batch
    into the step's batch (the selector's DP labels); `after_step(step,
    state, batch)` runs after each step. With prefetch=False the next batch
    is taken from `loader` right after the step, before `after_step` (which
    may read validation batches from the loader), as the JAX trainers that
    validate do; otherwise a background thread prefetches --prefetch_depth."""
    write_run_config(args, {"args": vars(args), "meta": meta})
    main = is_main_process()
    put = pinned_put(device, keys=tuple(keys))
    use_thread = prefetch and args.prefetch_depth > 0
    dev_iter = (DevicePrefetcher(itertools.chain([batch0], loader), put,
                                 depth=args.prefetch_depth) if use_thread else None)
    nxt = None if use_thread else put(batch0)
    rng = torch.Generator(device=device).manual_seed(args.seed + 1)
    t0 = t_prev = time.time()
    last = -1
    try:
        for step in range(args.steps):
            check_cpu_mem(args.max_cpu_mem_percent)
            batch = next(dev_iter) if use_thread else nxt
            if prepare is not None:
                batch = prepare(batch)
            state, metrics = train_step(state, batch, rng)
            if not use_thread:
                nxt = put(next(loader))
            if after_step is not None:
                after_step(step, state, batch)
            if main and (step % args.log_every == 0 or step + 1 == args.steps):
                loss = float(metrics["loss"])   # waits for the device: true step timing
                now = time.time()
                extra = "".join(f" {k} {float(metrics[k]):.5f}" for k in log_keys)
                print(f"step {step} loss {loss:.5f}{extra} | "
                      f"{(now - t_prev) / (step - last):.4f} s/step | "
                      f"{args.batch * (step + 1) / max(now - t0, 1e-9):.1f} samples/s",
                      flush=True)
                t_prev, last = now, step
            if main and ((step + 1) % args.save_every == 0 or step + 1 == args.steps):
                save_checkpoint(os.path.join(args.out_dir, f"ckpt_{step + 1}"), state.params,
                                None, step + 1, None, meta)
    finally:
        if dev_iter is not None:
            dev_iter.close()   # stop the prefetch thread, free queued batches
    return state
