"""Shared plumbing of the maze trainers (port of train/common.py): the data
and training flags, datasets from args, host-side index policies (numpy),
the device, and the model state the trainers hand to the train step.

Conventions of the JAX package: int-as-bool flags, "name:weight" policy
mixes, meta-rich checkpoints, per-run seeding. `--device` is new here: cuda
by default, with no fallback when there is no GPU.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import BatchLoader, ParticleMazeDataset, PreparedTrajectoryDataset
from .batches import parse_policy_mix
from .state import TrainState, stack_batches


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", type=str, default="particle", choices=["particle", "prepared"])
    p.add_argument("--prepared_path", type=str, default=None)
    p.add_argument("--num_samples", type=int, default=100000)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--maze_h", type=int, default=21)
    p.add_argument("--maze_w", type=int, default=21)
    p.add_argument("--with_velocity", type=int, default=0)
    p.add_argument("--use_sdf", type=int, default=0)
    p.add_argument("--data_seed", type=int, default=123)


def add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--use_ema", type=int, default=1)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/out")
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--n_data_shards", type=int, default=None,
                   help="data-parallel shards of the batch (not ported)")
    p.add_argument("--steps_per_call", type=int, default=10,
                   help="train steps per call: their batches go to the device in one "
                        "transfer and the host waits for the device once per call")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")


def make_dataset(args) -> Tuple[object, int]:
    """Returns (dataset, data_dim)."""
    if args.dataset == "prepared":
        if not args.prepared_path:
            raise ValueError("--prepared_path required for --dataset prepared")
        ds = PreparedTrajectoryDataset(args.prepared_path)
        return ds, ds.data_dim
    ds = ParticleMazeDataset(
        num_samples=args.num_samples,
        h=args.maze_h,
        w=args.maze_w,
        T=args.T,
        with_velocity=bool(args.with_velocity),
        use_sdf=bool(args.use_sdf),
        cache_dir=args.cache_dir,
        seed=args.data_seed,
    )
    return ds, ds.data_dim


def make_loader(ds, args) -> BatchLoader:
    return BatchLoader(ds, batch_size=args.batch, seed=args.seed)


def sample_idx_policy(
    rng: np.random.RandomState,
    policy_mix: str,
    B: int,
    T: int,
    K: int,
    kp_idx: Optional[np.ndarray] = None,
    uniform_jitter: float = 0.0,
    selector_idx: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host-side anchor-index sampling with per-sample policy mixing.

    Policies: random (sorted random interior + endpoints), uniform (evenly
    spaced, optional jitter), dp (precomputed kp_idx from the dataset),
    selector (indices produced by a learned selector, passed in).
    """
    mix = parse_policy_mix(policy_mix) or [("random", 1.0)]
    names = [n for n, _ in mix]
    probs = np.asarray([w for _, w in mix])
    choice = rng.choice(len(names), size=B, p=probs)
    idx = np.zeros((B, K), dtype=np.int32)
    for b in range(B):
        name = names[choice[b]]
        if name == "dp" and kp_idx is not None:
            idx[b] = kp_idx[b][:K]
        elif name == "selector" and selector_idx is not None:
            idx[b] = selector_idx[b][:K]
        elif name == "uniform":
            base = np.linspace(0, T - 1, K)
            if uniform_jitter > 0 and K > 2:
                spacing = (T - 1) / (K - 1)
                noise = (rng.rand(K) - 0.5) * spacing * uniform_jitter
                noise[0] = noise[-1] = 0.0
                base = base + noise
            row = np.clip(np.round(base).astype(np.int64), 0, T - 1)
            for k in range(1, K):
                row[k] = max(row[k], row[k - 1] + 1)
            for k in range(K - 2, -1, -1):
                row[k] = min(row[k], row[k + 1] - 1)
            row = np.clip(row, 0, T - 1)
            row[0], row[-1] = 0, T - 1
            idx[b] = row
        else:  # random
            interior = rng.choice(np.arange(1, T - 1), size=K - 2, replace=False)
            idx[b] = np.sort(np.concatenate([[0], interior, [T - 1]]))
    return idx


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to "
                           "run on the CPU)")
    return device


def check_train_args_ported(args) -> None:
    if args.n_data_shards is not None:
        raise NotImplementedError("--n_data_shards: the data-parallel mesh (parallel/mesh.py) "
                                  "is not ported yet")


def build_seeded(cls, args, device: torch.device, **kwargs):
    """cls(**kwargs) with f32 master parameters drawn from --seed on `device`,
    computing in bf16 under --bf16 1 (the JAX trainers' `dtype=bfloat16` over
    f32 parameters)."""
    from ..models.init import build_model
    from ..models.transformer import set_compute_dtype

    model = build_model(cls, generator=torch.Generator(device=device).manual_seed(args.seed),
                        device=device, **kwargs)
    return set_compute_dtype(model, torch.bfloat16 if args.bf16 else None)


def model_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's own parameters by state_dict name: the trainers' params
    dict (the optimizer updates these tensors in place) and what a checkpoint
    stores."""
    return dict(model.named_parameters())


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A (super)batch of numpy arrays and scalars onto `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def resume_state(state, resume: str, device: torch.device):
    """(state, start_step) from --resume (a checkpoint or a run directory):
    parameters, optimizer state and EMA are copied into the state's own
    tensors. No checkpoint under `resume`: the state as it is, step 0."""
    from ..utils.checkpoint import latest_checkpoint, load_checkpoint

    path = (resume if os.path.exists(os.path.join(resume, "meta.json"))
            else latest_checkpoint(resume))
    if not path:
        return state, 0
    step, payload = load_checkpoint(path, map_location=device)
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(payload["params"][name])
        if state.ema_params is not None and "ema" in payload:
            for name, p in state.ema_params.items():
                p.copy_(payload["ema"][name])
    if "opt_state" in payload:
        state.opt_state.load_state_dict(payload["opt_state"])
    print(f"resumed from {path} @ step {step}")
    return state._replace(step=step), step


def run_training(args, device, loader, first_batch, state: TrainState, train_step, make_host_batch,
                 meta: Dict, start_step: int) -> TrainState:
    """The loop the maze, toy-video and DiDeMo trainers share:
    `--steps_per_call` host batches per call in one transfer (one without
    that flag), the log line, checkpoints."""
    from ..utils.checkpoint import save_checkpoint

    spc = max(1, getattr(args, "steps_per_call", 1))
    rng = torch.Generator(device=device).manual_seed(args.seed + 2 + start_step)
    t0 = time.time()
    batch, step = first_batch, start_step
    while step < args.steps:
        n_micro = min(spc, args.steps - step)
        micro = []
        for mi in range(n_micro):
            micro.append(make_host_batch(batch, step + mi))
            batch = next(loader)
        dev = to_device(stack_batches(micro) if spc > 1 else micro[0], device)
        state, metrics = train_step(state, dev, rng)
        step += n_micro
        if (step // spc) % max(1, args.log_every // spc) == 0 or step >= args.steps:
            loss = float(metrics["loss"])   # waits for the device: true step timing
            dt = time.time() - t0
            done = step - start_step
            print(f"step {step} loss {loss:.4f} | {dt / done:.4f} s/step | "
                  f"{args.batch * done / max(dt, 1e-9):.1f} samples/s", flush=True)
        if step % args.save_every < n_micro or step >= args.steps:
            ckpt = os.path.join(args.out_dir, f"ckpt_{step}")
            save_checkpoint(ckpt, state.params, state.opt_state.state_dict(), step,
                            state.ema_params, meta)
            print(f"saved {ckpt}", flush=True)
    return state
