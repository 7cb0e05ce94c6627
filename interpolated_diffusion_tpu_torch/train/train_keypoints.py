"""Stage-1 keypoint DDPM trainer, maze family (port of train/train_keypoints.py).

    python -m interpolated_diffusion_tpu_torch.train.train_keypoints [flags]

Gathers K keypoints under a mixed index policy, optional logit-space
transform, q_sample, known-endpoint clamping of z_t with eps zeroed at the
known dims, masked eps-MSE; gradient accumulation, global-norm clip, AdamW
and EMA in train/state.py; meta-rich checkpoints. The model holds f32 master
parameters and computes in bf16 (`--bf16 1`). Runs on the GPU unless
`--device cpu`. Exactly `--steps` optimizer steps are taken (the JAX trainer
rounds up to a multiple of `--steps_per_call`).

`--objective rf` trains rectified-flow velocity matching instead
(ops/rectified_flow.py), optionally on a frozen rf teacher's own couplings
(`--reflow_teacher`, ReFlow).

Keypoint selection: `--use_kp_feat 1 --kp_feat_dim F` feeds the index
features of the anchors to the model (ops/selection.build_kp_feat_full),
their cost channels from a frozen D_phi (`--dphi_ckpt`, F >= 5); the
`selector` entry of `--idx_policy` takes anchors from a frozen keypoint
selector (`--selector_ckpt`, top-K of its logits, Gumbel-perturbed under
`--selector_stochastic` from a generator seeded by `--seed`).

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..models.denoisers import KeypointDenoiser
from ..ops.ddpm import q_sample
from ..ops.keyframes import sample_fixed_k_indices_batch, sample_fixed_k_indices_uniform_batch
from ..ops.normalize import logit_pos
from ..ops.rectified_flow import rf_integrate, rf_interpolate
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..ops.selection import build_kp_feat_full
from ..parallel.mesh import dp_sum
from .batches import Rng, build_known_mask_values, draw, gather_keypoints, parse_policy_mix
from .common import (add_data_args, add_train_args, build_seeded, data_mesh, make_dataset,
                     make_loader, model_params, resolve_device, resume_state, run_training,
                     sample_idx_policy, write_run_config)
from .state import TrainState, init_train_state, make_optimizer, make_train_multi_step


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_keypoints (Stage-1)")
    p.add_argument("--T", type=int, default=64)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--N_train", type=int, default=100)
    p.add_argument("--schedule", type=str, default="linear", choices=["linear", "cosine"])
    p.add_argument("--objective", type=str, default="eps", choices=["eps", "rf"],
                   help="rf: rectified-flow velocity matching")
    p.add_argument("--reflow_teacher", type=str, default=None,
                   help="rf checkpoint whose (noise, generated) couplings to train on")
    p.add_argument("--reflow_steps", type=int, default=20)
    p.add_argument("--d_model", type=int, default=384)
    p.add_argument("--n_layers", type=int, default=12)
    p.add_argument("--n_heads", type=int, default=12)
    p.add_argument("--d_ff", type=int, default=1536)
    p.add_argument("--d_cond", type=int, default=128)
    p.add_argument("--maze_channels", type=str, default="32,64,128,128")
    p.add_argument("--kp_feat_dim", type=int, default=0)
    p.add_argument("--use_kp_feat", type=int, default=0)
    p.add_argument("--dphi_ckpt", type=str, default=None,
                   help="segment-cost ckpt: fills kp_feat channels 3/4 with the D_phi cost of "
                        "each keypoint's left/right segment (use_kp_feat=1, kp_feat_dim>=5)")
    p.add_argument("--logit_space", type=int, default=0)
    p.add_argument("--logit_eps", type=float, default=1e-5)
    p.add_argument("--clamp_endpoints", type=int, default=1)
    p.add_argument("--cond_start_goal", type=int, default=1)
    p.add_argument("--idx_policy", type=str, default="random:1.0",
                   help='mix like "dp:0.5,uniform:0.2,random:0.2,selector:0.1"')
    p.add_argument("--uniform_jitter", type=float, default=0.0)
    p.add_argument("--selector_ckpt", type=str, default=None)
    p.add_argument("--selector_stochastic", type=int, default=0)
    p.add_argument("--selector_tau", type=float, default=1.0)
    p.add_argument("--attn_policy", type=str, default="fused", choices=["fused", "block", "dense"],
                   help="small-L attention route of every block (models/transformer.py)")
    add_data_args(p)
    add_train_args(p)
    return p


def make_meta(args, data_dim: int) -> Dict:
    return {
        "stage": "keypoints", "T": args.T, "K": args.K, "N_train": args.N_train,
        "schedule": args.schedule, "objective": args.objective,
        "d_model": args.d_model, "n_layers": args.n_layers, "n_heads": args.n_heads,
        "d_ff": args.d_ff, "d_cond": args.d_cond, "maze_channels": args.maze_channels,
        "kp_feat_dim": args.kp_feat_dim, "use_kp_feat": args.use_kp_feat,
        "kp_feat_dphi": int(bool(args.dphi_ckpt)),
        "logit_space": args.logit_space, "logit_eps": args.logit_eps,
        "clamp_endpoints": args.clamp_endpoints, "cond_start_goal": args.cond_start_goal,
        "with_velocity": args.with_velocity, "use_sdf": args.use_sdf, "data_dim": data_dim,
        "maze_h": args.maze_h, "maze_w": args.maze_w,
    }


def build_model(args, data_dim: int, device: torch.device) -> KeypointDenoiser:
    """The denoiser with f32 masters from --seed, bf16 compute under --bf16."""
    return build_seeded(
        KeypointDenoiser, args, device, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, d_ff=args.d_ff, d_cond=args.d_cond, use_sdf=bool(args.use_sdf),
        use_start_goal=bool(args.cond_start_goal), data_dim=data_dim,
        kp_feat_dim=args.kp_feat_dim if args.use_kp_feat else 0,
        maze_channels=tuple(int(c) for c in args.maze_channels.split(",")),
        attn_policy=getattr(args, "attn_policy", "fused"))


def device_policy_of(args) -> Optional[str]:
    """"random" / "uniform" when the policy mix has that one entry (the
    indices are then drawn on the device inside the step), else None (the
    host mixes policies per sample)."""
    names = {n for n, _ in (parse_policy_mix(args.idx_policy) or [("random", 1.0)])}
    return next(iter(names)) if names in ({"random"}, {"uniform"}) else None


def make_loss_fn(model: KeypointDenoiser, args, schedule: DiffusionSchedule,
                 device_policy: Optional[str] = None, reflow_fn=None, dphi_fn=None):
    """loss_fn(params, batch, rng) -> (loss, {}); batch has x, occ,
    start_goal[, sdf][, idx]. `params` are the model's own tensors. Under
    --use_kp_feat the model gets the anchors' index features, whose cost
    channels come from the frozen dphi_fn(cond, idx) -> [B, K-1] when given.

    device_policy ("random" / "uniform") samples the anchor indices inside
    the step; without it the batch carries `idx` from the host policy mix.
    Draws of `rng` (train/batches.Rng), in order: "policy_rand" uniform
    [B, T-2] (random) or [B, K] (uniform with jitter); then under eps "t"
    randint [B] in [0, N_train) and "eps" normal [B, K, D]; under rf "tau"
    uniform [B] and "eps" normal [B, K, D], or with `reflow_fn` (from
    make_reflow_fn) its "reflow_noise" normal [B, K, D].
    """
    T = args.T

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng: Rng):
        x0 = batch["x"].float()
        B, _, D = x0.shape
        dev = x0.device
        injected = isinstance(rng, dict)
        if device_policy == "uniform":
            idx, _ = sample_fixed_k_indices_uniform_batch(
                B, T, args.K, jitter=args.uniform_jitter,
                rand=rng["policy_rand"].to(dev) if injected and args.uniform_jitter else None,
                generator=None if injected else rng, device=dev)
        elif device_policy == "random":
            idx, _ = sample_fixed_k_indices_batch(
                B, T, args.K, rand=draw(rng, "policy_rand", "uniform", (B, T - 2)).to(dev))
        else:
            idx = batch["idx"].long()
        cond = {"occ": batch["occ"], "start_goal": batch["start_goal"]}
        if "sdf" in batch:
            cond["sdf"] = batch["sdf"]
        z0 = gather_keypoints(x0, idx)
        known_mask, known_values = build_known_mask_values(idx, cond, D, T,
                                                           bool(args.clamp_endpoints))
        if args.logit_space:
            z0 = logit_pos(z0, eps=args.logit_eps)
            known_values = logit_pos(known_values, eps=args.logit_eps)
        if args.use_kp_feat:
            with torch.no_grad():
                seg_cost = dphi_fn(cond, idx) if dphi_fn is not None else None
            cond["kp_feat"] = build_kp_feat_full(idx, T, args.kp_feat_dim, seg_cost)
        valid = (~known_mask).float()
        if args.objective == "rf":
            # straight-path velocity matching; the eps head doubles as the
            # velocity head, and tau rides the integer timestep embedding
            tau = draw(rng, "tau", "uniform", (B,)).to(dev).float()
            if reflow_fn is not None:
                # ReFlow: the frozen teacher's own (noise, generated) coupling
                noise, z0 = reflow_fn(rng, idx, cond, known_mask, known_values)
            else:
                noise = draw(rng, "eps", "normal", tuple(z0.shape)).to(z0)
            z_t, v = rf_interpolate(z0, tau, noise)
            z_t = torch.where(known_mask, known_values, z_t)
            v_hat = model(z_t, (tau * (args.N_train - 1)).to(torch.int32), idx, known_mask,
                          cond, T)
            v = v * (~known_mask)
            return dp_sum(((v_hat - v) ** 2 * valid).sum()) / (dp_sum(valid.sum()) + 1e-8), {}
        t = draw(rng, "t", "randint", (B,), 0, args.N_train).to(dev).long()
        z_t, eps = q_sample(z0, t, schedule,
                            noise=draw(rng, "eps", "normal", tuple(z0.shape)).to(z0))
        z_t = torch.where(known_mask, known_values, z_t)
        eps = eps * valid
        eps_hat = model(z_t, t, idx, known_mask, cond, T)
        loss = dp_sum(((eps_hat - eps) ** 2 * valid).sum()) / (dp_sum(valid.sum()) + 1e-8)
        return loss, {}

    return loss_fn


def make_reflow_fn(args, device: torch.device):
    """The frozen rf teacher (--reflow_teacher, EMA weights) -> reflow_fn(rng,
    idx, cond, known_mask, known_values) -> (noise, generated): the teacher
    integrates its velocity field from the noise the loss then interpolates
    against (the ReFlow coupling), clamping the known values every step.
    Draw: "reflow_noise" normal [B, K, D]."""
    from ..models.loading import load_keypoint_model

    t_model, t_meta = load_keypoint_model(args.reflow_teacher, bool(args.bf16), device=device)
    if t_meta.get("objective") != "rf":
        raise ValueError("--reflow_teacher must be an rf-objective Stage-1 checkpoint "
                         "(meta objective=rf)")
    t_model.set_attn_policy(getattr(args, "attn_policy", "fused"))
    n_tr, T = int(t_meta["N_train"]), args.T

    @torch.no_grad()
    def reflow_fn(rng: Rng, idx, cond, known_mask, known_values):
        noise = draw(rng, "reflow_noise", "normal", tuple(known_values.shape)).to(
            known_values)
        vel = lambda z, t: t_model(z, (t * (n_tr - 1)).to(torch.int32), idx, known_mask,
                                   cond, T)
        post = lambda z: torch.where(known_mask, known_values, z)
        x = rf_integrate(vel, torch.where(known_mask, known_values, noise),
                         args.reflow_steps, post=post)
        return noise, x

    return reflow_fn


def make_trainer(args, device: torch.device, data_dim: int, model=None):
    """(state, train_step, model): the model (built from --seed unless
    given), the optimizer state over its own parameters, and
    train_step(state, batch or superbatch, rng) -> (state, metrics)."""
    if model is None:
        model = build_model(args, data_dim, device)
    schedule = make_schedule(args.schedule, args.N_train, device=device)
    reflow_fn = make_reflow_fn(args, device) if args.reflow_teacher else None
    dphi_fn = None
    if args.dphi_ckpt:
        if not args.use_kp_feat or args.kp_feat_dim < 5:
            raise ValueError("dphi_ckpt requires use_kp_feat=1 and kp_feat_dim>=5")
        from ..models.loading import make_dphi_seg_cost_fn

        dphi_fn, _ = make_dphi_seg_cost_fn(args.dphi_ckpt, args.T, bool(args.use_sdf),
                                           bool(args.bf16), device=device)
    loss_fn = make_loss_fn(model, args, schedule, device_policy_of(args), dphi_fn=dphi_fn,
                           reflow_fn=reflow_fn)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip)
    state = init_train_state(model_params(model), tx, use_ema=bool(args.use_ema))
    train_step = make_train_multi_step(loss_fn, args.ema_decay, args.grad_accum,
                                       max(1, args.steps_per_call),
                                       mesh=data_mesh(args))
    return state, train_step, model


def make_selector_idx_fn(args, device: torch.device):
    """The `selector` index policy: selector_fn(batch) -> idx [B, K] int32
    (numpy), the top-K frames of a frozen selector's logits (--selector_ckpt),
    Gumbel-perturbed under --selector_stochastic with draws from a generator
    seeded by --seed + 3."""
    if not args.selector_ckpt:
        raise ValueError("idx_policy includes selector but --selector_ckpt missing")
    from ..models.loading import load_selector_model
    from ..models.selector import select_topk_indices

    sel_model, sel_meta = load_selector_model(args.selector_ckpt, bool(args.bf16), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 3)

    @torch.no_grad()
    def selector_fn(batch: Dict[str, np.ndarray]) -> np.ndarray:
        cond = {k: torch.as_tensor(batch[k]).to(device) for k in ("occ", "start_goal")}
        if sel_meta.get("use_sdf") and "sdf" in batch:
            cond["sdf"] = torch.as_tensor(batch["sdf"]).to(device)
        if sel_meta.get("use_level"):
            cond["level"] = torch.full((cond["occ"].shape[0], 1), args.K / max(1, args.T - 1),
                                       device=device)
        idx = select_topk_indices(sel_model(cond), args.K, bool(args.selector_stochastic),
                                  args.selector_tau, generator=gen)
        return idx.cpu().numpy().astype(np.int32)

    return selector_fn


def host_batch(args, batch: Dict[str, np.ndarray], device_policy: Optional[str],
               host_rng: np.random.RandomState, selector_fn=None) -> Dict[str, np.ndarray]:
    """What one step takes from a loader batch, with the host policy mix's
    anchor indices when the policy is not drawn on the device (the selector's
    choices under a `selector` entry)."""
    out = {"x": batch["x"], "occ": batch["occ"], "start_goal": batch["start_goal"]}
    if device_policy is None:
        sel_idx = selector_fn(batch) if selector_fn is not None else None
        out["idx"] = sample_idx_policy(host_rng, args.idx_policy, args.batch, args.T, args.K,
                                       batch.get("kp_idx"), args.uniform_jitter, sel_idx)
    if "sdf" in batch and args.use_sdf:
        out["sdf"] = batch["sdf"]
    return out


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    data_mesh(args)
    ds, data_dim = make_dataset(args)
    loader = iter(make_loader(ds, args))
    first = next(loader)

    state, train_step, model = make_trainer(args, device, data_dim)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M | device: {device} | "
          f"attn_policy: {args.attn_policy}", flush=True)
    start_step = 0
    if args.resume:
        state, start_step = resume_state(state, args.resume, device)

    device_policy = device_policy_of(args)
    selector_fn = (make_selector_idx_fn(args, device) if "selector" in args.idx_policy
                   else None)
    host_rng = np.random.RandomState(args.seed + 1)
    meta = make_meta(args, data_dim)
    write_run_config(args, {"args": vars(args), "meta": meta, "n_params": n_params})
    return run_training(args, device, loader, first, state, train_step,
                        lambda b, _step: host_batch(args, b, device_policy, host_rng,
                                                    selector_fn), meta,
                        start_step)


if __name__ == "__main__":
    main()
