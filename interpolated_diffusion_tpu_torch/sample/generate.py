"""End-to-end generation: Stage-1 keypoints -> interpolation -> Stage-2 refine
(port of sample/generate.py: make_pipeline and the sampling CLI).

    python -m interpolated_diffusion_tpu_torch.sample.generate --kp_ckpt <run> --interp_ckpt <run>

The JAX package compiles the pipeline into one XLA program; here it runs
eagerly under torch.inference_mode(). Random draws are explicit (see
`make_draws`): the Stage-1 initial noise `z_init` [B, K, D] ([N, B, K, D]
under best-of-N), the Stage-2 mask priorities `mask_rand` [B, T] and the
Stage-2 sampling noise `s2_noise` [levels + 1, B, T, 2] (row s used at level
s). They are drawn from a `torch.Generator` unless the caller passes them; a
parity test passes the draws JAX made (k1, k2 = split(key); normal(k1, (B,
K, D)), or normal(keys[n], ...) over keys = split(k1, N); uniform(k2, (B,
T)); normal(split(fold_in(k2, 7), levels + 1)[s], (B, T, 2))). The CLI's
stochastic selector top-k draws its Gumbel noise from the same generator,
before the pipeline's draws.

Keypoint selection: a Stage-1 checkpoint trained with `--use_kp_feat` gets
its index features rebuilt inside the pipeline (`kp_feat_dim`; the D_phi
cost channels from `dphi_fn`, see models/loading.make_dphi_seg_cost_fn); the
CLI's `--kp_index_mode selector` and `--stage2_mask_policy selector` run the
keypoint selector (`--selector_ckpt`). `--save_plots` / `--save_steps` write
PNGs (and a GIF) through eval/visualize.py, which needs matplotlib (and PIL).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.tuning import add_attn_policy_arg
from ..eval.metrics import compute_metrics_batch
from ..models.loading import (load_interp_model, load_keypoint_model, load_selector_model,
                              make_dphi_seg_cost_fn)
from ..models.selector import select_topk_indices
from ..ops.anchor_search import pick_anchors
from ..ops.clamp import apply_clamp, apply_soft_clamp
from ..ops.ddpm import SOLVERS, make_timesteps, run_solver
from ..ops.keyframes import (build_nested_masks_from_base, build_nested_masks_from_logits,
                             compute_k_schedule, interpolate_from_indices)
from ..ops.normalize import logit_pos, sigmoid_pos
from ..ops.rectified_flow import rf_integrate
from ..ops.selection import build_kp_feat_full
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..train.batches import build_known_mask_values, compute_sigma_for_level, gather_keypoints
from ..train.common import add_data_args, make_dataset, resolve_device, sample_idx_policy
from ..train.train_interp_levels import anneal_conf, build_anchor_conf
from ..utils.profiling import span


CALL, ENCODE, STAGE1, LERP, LEVEL = ("idt.plan.call", "idt.plan.encode", "idt.plan.stage1",
                                    "idt.plan.lerp", "idt.plan.level")


@dataclass
class PipelineConfig:
    """Static pipeline knobs (names and defaults of the JAX PipelineConfig)."""

    T: int
    K: int
    levels: int
    K_min: int
    ddim_steps: int = 20
    time_spacing: str = "linear"
    k_schedule: str = "doubling"
    stage2_mode: str = "adj"            # adj | x0
    anchor_conf: bool = False
    anchor_conf_anneal_mode: str = "none"
    anchor_conf_teacher: float = 0.95
    anchor_conf_endpoints: float = 1.0
    anchor_conf_missing: float = 0.0
    clamp_endpoints: bool = True
    clamp_policy: str = "endpoints"     # endpoints | all_anchors | none
    clamp_dims: str = "pos"
    soft_anchor_clamp: bool = False
    soft_clamp_schedule: str = "linear"
    soft_clamp_max: float = 0.5
    s2_noise_mode: str = "none"         # none | constant | level
    s2_noise_sigma: float = 0.0
    s2_noise_scale: float = 1.0
    s2_sigma_min: float = 0.0
    s2_sigma_pow: float = 1.0
    pos_clip: bool = False
    pos_clip_min: float = 0.0
    pos_clip_max: float = 1.0
    logit_space: bool = False
    logit_eps: float = 1e-5
    recompute_vel: bool = False
    stage2_mask_policy: str = "base"    # base | selector (ranked by the selector logits)
    collect_steps: bool = False         # also return the per-step states
    stage1_cache_interval: int = 1      # FORA: the block stack every Nth DDIM step
    stage1_solver: str = "ddim"         # ddim | pfdiff | dpm
    stage1_objective: str = "eps"       # eps | rf (Euler-integrate the velocity head)
    stage1_best_of: int = 1             # N candidate anchor sets, the least colliding kept
    stage1_best_of_mode: str = "set"    # set: whole-set argmin; dp: per-anchor chain DP
    kp_feat_dim: int = 0                # > 0: rebuild kp_feat for Stage 1 (cost channels: dphi_fn)
    x0_clip: float = 0.0                # > 0: clamp the solver's per-step x0 to +-x0_clip
    s2_delta_smooth: int = 0            # N passes of a 3-tap binomial filter at missing frames


def check_supported(cfg: PipelineConfig) -> None:
    if cfg.stage2_mode not in ("adj", "x0"):
        raise ValueError(f"unknown stage2_mode {cfg.stage2_mode!r}")
    if cfg.clamp_policy not in ("endpoints", "all_anchors", "none"):
        raise ValueError(f"unknown clamp_policy {cfg.clamp_policy!r}")
    if cfg.stage1_solver not in SOLVERS:
        raise ValueError(f"unknown solver {cfg.stage1_solver!r}; pick from {SOLVERS}")
    if cfg.stage1_objective == "rf" and (cfg.stage1_cache_interval > 1
                                         or cfg.stage1_solver != "ddim"):
        raise ValueError("rf checkpoints integrate their velocity field directly — "
                         "stage1_solver/cache_interval do not apply")


def resolve_s2_noise_schedule(mode, sigma, sigma_min, sigma_pow, il_meta) -> Dict:
    """The Stage-2 sampling-noise schedule; unset values default to the interp
    checkpoint's training corruption schedule (corrupt_sigma_{max,min,pow})."""
    return dict(
        s2_noise_sigma=(float(sigma) if sigma is not None
                        else float(il_meta.get("corrupt_sigma_max", 0.0))
                        if mode == "level" else 0.0),
        s2_sigma_min=(float(sigma_min) if sigma_min is not None
                      else float(il_meta.get("corrupt_sigma_min", 0.0))),
        s2_sigma_pow=(float(sigma_pow) if sigma_pow is not None
                      else float(il_meta.get("corrupt_sigma_pow", 1.0))),
    )


def _soft_clamp_lambda(s: int, levels: int, schedule: str, max_val: float) -> float:
    if levels <= 0:
        return float(max_val)
    frac = float(s) / float(levels)
    if schedule == "linear":
        return float(max_val) * frac
    if schedule == "cosine":
        return float(max_val) * 0.5 * (1.0 + np.cos(np.pi * (1.0 - frac)))
    return float(max_val)


def hoist_cond_vec(model, cond: Optional[Dict[str, torch.Tensor]]):
    """Run a denoiser's maze encoder once, returning cond with `cond_vec` set
    (the denoisers then skip their encoder on every DDIM / level step)."""
    if cond is None or "occ" not in cond:
        return cond
    out = dict(cond)
    out["cond_vec"] = model.cond_enc(cond)
    return out


def make_draws(cfg: PipelineConfig, B: int, data_dim: int, generator: torch.Generator,
               device=None) -> Dict[str, torch.Tensor]:
    """Every random draw of one pipeline call, in this order: z_init normal
    [B, K, D] ([N, B, K, D] when best-of-N runs), mask_rand uniform
    [B, T], and, unless s2_noise_mode is none, s2_noise normal
    [levels + 1, B, T, 2]."""
    device = device if device is not None else generator.device
    N = cfg.stage1_best_of
    shape = (N, B, cfg.K, data_dim) if _best_of_runs(cfg) else (B, cfg.K, data_dim)
    out = {"z_init": torch.randn(shape, generator=generator, device=device),
           "mask_rand": torch.rand((B, cfg.T), generator=generator, device=device)}
    if cfg.s2_noise_mode != "none":
        out["s2_noise"] = torch.randn((cfg.levels + 1, B, cfg.T, 2), generator=generator,
                                      device=device)
    return out


def _best_of_runs(cfg: PipelineConfig) -> bool:
    """Best-of-N Stage 1 runs unless collect_steps takes precedence (as in the
    JAX pipeline)."""
    return cfg.stage1_best_of > 1 and not cfg.collect_steps


def _repeat(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.repeat(n, *([1] * (t.ndim - 1)))


def make_pipeline(kp_model, interp_model, schedule: DiffusionSchedule,
                  cfg: PipelineConfig, data_dim: int, dphi_fn=None):
    """Returns pipeline(idx, cond, *, generator=None, z_init=None,
    mask_rand=None, s2_noise=None, z_override=None, selector_logits=None) ->
    (x_interp [B,T,D], x_refined [B,T,D], z_pred [B,K,D]), and with
    collect_steps a fourth item (z_steps [S1,B,K,D], x_steps [S2,B,T,D]).

    idx [B, K] holds sorted anchor frames; cond has "occ" [B, 1, G, G] and
    "start_goal" [B, 4]. z_override [B, K, D] replaces Stage 1;
    selector_logits [B, T] rank the Stage-2 masks under
    stage2_mask_policy="selector" (without them the masks grow from idx, as
    in the JAX pipeline). With cfg.kp_feat_dim > 0 Stage 1 gets the index
    features of idx, whose cost channels (kp_feat_dim >= 5) come from
    dphi_fn(cond, idx) -> [B, K-1] when it is given and stay zero otherwise.
    Everything runs on idx's device.
    """
    check_supported(cfg)
    T, K, levels = cfg.T, cfg.K, cfg.levels
    times = make_timesteps(schedule.n_timesteps, cfg.ddim_steps, cfg.time_spacing)
    k_list = compute_k_schedule(T, cfg.K_min, levels, cfg.k_schedule)
    x0_clip = cfg.x0_clip if cfg.x0_clip > 0 else None

    def clip_pos(z: torch.Tensor) -> torch.Tensor:
        if not cfg.pos_clip:
            return z
        pos = torch.clamp(z[..., :2], cfg.pos_clip_min, cfg.pos_clip_max)
        return torch.cat([pos, z[..., 2:]], dim=-1)

    def stage1(sched, idx, cond, z):
        """z [M, K, D] initial noise -> (z_pred [M, K, D], per-step states or None)."""
        if cfg.kp_feat_dim > 0:
            seg_cost = dphi_fn(cond, idx) if dphi_fn is not None else None
            cond = dict(cond, kp_feat=build_kp_feat_full(idx, T, cfg.kp_feat_dim, seg_cost))
        known_mask, known_values = build_known_mask_values(
            idx, cond, data_dim, T, cfg.clamp_endpoints)
        if cfg.logit_space:
            known_values = logit_pos(known_values, eps=cfg.logit_eps)
        post = lambda z: clip_pos(torch.where(known_mask, known_values, z))
        z, z_steps = post(z), None
        if cfg.stage1_objective == "rf":
            n_tr = sched.n_timesteps
            vel = lambda z, t: kp_model(z, (t * (n_tr - 1)).to(torch.int32), idx, known_mask,
                                        cond, T)
            z = rf_integrate(vel, z, cfg.ddim_steps, post=post)
        else:
            eps_fn = lambda z, t_b, **cache_kw: kp_model(z, t_b, idx, known_mask, cond, T,
                                                         **cache_kw)
            delta0 = torch.zeros((z.shape[0], K, kp_model.d_model), dtype=kp_model.dtype,
                                 device=z.device)
            res = run_solver(cfg.stage1_solver, eps_fn, z, times, sched, post=post,
                             collect=cfg.collect_steps, cache_interval=cfg.stage1_cache_interval,
                             delta0=delta0, x0_clip=x0_clip)
            z, z_steps = res if cfg.collect_steps else (res, None)
        if cfg.logit_space:
            z = sigmoid_pos(z)
            if z_steps is not None:
                z_steps = sigmoid_pos(z_steps)
        return z, z_steps

    def best_of(sched, idx, cond, occ, z_init):
        """N candidate anchor sets in one batch of N * B rows (one launch per
        block for all of them), then the set argmin or the chain-DP mix."""
        N, B = z_init.shape[:2]
        z_cands, _ = stage1(sched, _repeat(idx, N), {k: _repeat(v, N) for k, v in cond.items()},
                            z_init.reshape(N * B, K, data_dim))
        return pick_anchors(z_cands.view(N, B, K, data_dim), idx, occ, T,
                            cfg.stage1_best_of_mode, cfg.recompute_vel)

    def stage2(x_pred, idx, cond, mask_rand, s2_noise, selector_logits):
        B = idx.shape[0]
        if cfg.stage2_mask_policy == "selector" and selector_logits is not None:
            masks, _ = build_nested_masks_from_logits(selector_logits, cfg.K_min, levels,
                                                      k_schedule=cfg.k_schedule)
        else:
            masks, _ = build_nested_masks_from_base(idx, T, levels, k_schedule=cfg.k_schedule,
                                                    rand=mask_rand)
        x, x_steps = x_pred, []
        end_mask = torch.zeros_like(masks[:, 0])
        end_mask[:, 0] = end_mask[:, -1] = True
        for s in ([levels] if cfg.stage2_mode == "x0" else range(levels, 0, -1)):
            with span(LEVEL):
                mask_s = masks[:, s]
                conf_s = None
                if cfg.anchor_conf:
                    conf_s = build_anchor_conf(mask_s, None, cfg.anchor_conf_teacher, 0.5,
                                               cfg.anchor_conf_endpoints, cfg.anchor_conf_missing,
                                               cfg.clamp_endpoints)
                    conf_s = anneal_conf(conf_s, torch.full((B,), s, device=idx.device), levels,
                                         cfg.anchor_conf_anneal_mode)
                chans = [mask_s.float()]
                if cfg.stage2_mode == "adj":
                    chans.append(masks[:, s - 1].float())
                if conf_s is not None:
                    chans.append(conf_s)
                mask_in = torch.stack(chans, dim=-1) if len(chans) > 1 else mask_s
                s_level = torch.full((B,), s, dtype=torch.long, device=idx.device)
                x = x + interp_model(x, s_level, mask_in, cond)
                if cfg.s2_delta_smooth > 0:
                    # binomial smoothing at missing frames (roll wraps around, as
                    # jnp.roll does); endpoints and anchors keep their values
                    keep = mask_s.clone()
                    keep[:, 0] = keep[:, -1] = True
                    for _ in range(cfg.s2_delta_smooth):
                        xs = (0.25 * torch.roll(x, 1, dims=1) + 0.5 * x
                              + 0.25 * torch.roll(x, -1, dims=1))
                        xs[:, 0], xs[:, -1] = x[:, 0], x[:, -1]
                        x = torch.where(keep[..., None], x, xs)
                if cfg.s2_noise_mode != "none":
                    sigma = (cfg.s2_noise_sigma if cfg.s2_noise_mode == "constant"
                             else compute_sigma_for_level(int(k_list[s]), cfg.K_min,
                                                          cfg.s2_noise_sigma, cfg.s2_sigma_min,
                                                          cfg.s2_sigma_pow))
                    if sigma > 0 and cfg.s2_noise_scale > 0:
                        nz = s2_noise[s] * sigma * cfg.s2_noise_scale * (~mask_s)[..., None]
                        x = torch.cat([x[..., :2] + nz, x[..., 2:]], dim=-1)
                if cfg.soft_anchor_clamp and conf_s is not None:
                    lam = _soft_clamp_lambda(s, levels, cfg.soft_clamp_schedule, cfg.soft_clamp_max)
                    x = apply_soft_clamp(x, x_pred, conf_s, lam, cfg.clamp_dims)
                if cfg.clamp_policy == "all_anchors":
                    x = apply_clamp(x, x_pred, mask_s, cfg.clamp_dims)
                elif cfg.clamp_policy == "endpoints":
                    x = apply_clamp(x, x_pred, end_mask, cfg.clamp_dims)
                x = clip_pos(x)
                if cfg.collect_steps:
                    x_steps.append(x)
        return x, (torch.stack(x_steps, dim=0) if cfg.collect_steps else None)

    @torch.inference_mode()
    def pipeline(idx: torch.Tensor, cond: Dict[str, torch.Tensor], *,
                 generator: Optional[torch.Generator] = None,
                 z_init: Optional[torch.Tensor] = None,
                 mask_rand: Optional[torch.Tensor] = None,
                 s2_noise: Optional[torch.Tensor] = None,
                 z_override: Optional[torch.Tensor] = None,
                 selector_logits: Optional[torch.Tensor] = None):
        with span(CALL):
            B, device = idx.shape[0], idx.device
            need_z = z_override is None and z_init is None
            need_noise = cfg.s2_noise_mode != "none" and s2_noise is None
            if need_z or mask_rand is None or need_noise:
                if generator is None:
                    raise ValueError("pipeline needs a generator unless its draws are given")
                drawn = make_draws(cfg, B, data_dim, generator, device)
                z_init = drawn["z_init"] if z_init is None else z_init
                mask_rand = drawn["mask_rand"] if mask_rand is None else mask_rand
                s2_noise = drawn.get("s2_noise") if s2_noise is None else s2_noise
            sched = schedule if schedule.betas.device == device else schedule.to(device)
            idx = idx.long()
            # the maze CNN runs once per call, not once per DDIM / level step
            with span(ENCODE):
                kp_cond = hoist_cond_vec(kp_model, cond)
                it_cond = hoist_cond_vec(interp_model, cond)
            z_steps = None
            with span(STAGE1):
                if z_override is not None:
                    z_pred = z_override.float()
                elif _best_of_runs(cfg):
                    occ = cond["occ"][:, 0] if cond["occ"].ndim == 4 else cond["occ"]
                    z_pred = best_of(sched, idx, kp_cond, occ, z_init.float())
                else:
                    z_pred, z_steps = stage1(sched, idx, kp_cond, z_init.float())
            with span(LERP):
                x_interp = interpolate_from_indices(idx, z_pred, T,
                                                    recompute_velocity=cfg.recompute_vel)
            x_refined, x_steps = stage2(x_interp, idx, it_cond, mask_rand, s2_noise,
                                        selector_logits)
        if not cfg.collect_steps:
            return x_interp, x_refined, z_pred
        if z_steps is None:   # z_override, rf, or pfdiff without a springboard group
            z_steps = z_pred[None]
        return x_interp, x_refined, z_pred, (z_steps, x_steps)

    return pipeline


def export_viz(args, batch, idx, z_pred, x_interp, x_refined, steps, T):
    """Per-sample PNG plots (`--save_plots N`: the first N samples) and
    per-step diffusion frames + a GIF of sample 0 (`--save_steps`)."""
    from ..eval.visualize import plot_occupancy_trajectories

    occ, sg, gt = batch["occ"], batch["start_goal"], batch["x"]
    host = lambda t: t.float().cpu().numpy()
    z_np, xi_np, xr_np = host(z_pred), host(x_interp), host(x_refined)
    plots_dir = os.path.join(args.out_dir, "plots")
    os.makedirs(plots_dir, exist_ok=True)
    for b in range(min(int(args.save_plots), xi_np.shape[0])):
        plot_occupancy_trajectories(
            occ[b], [gt[b], xi_np[b], xr_np[b]], labels=["gt", "interp", "refined"],
            keypoints=z_np[b], start_goal=sg[b],
            out_path=os.path.join(plots_dir, f"sample_{b:03d}.png"), title=f"sample {b}")
    if not (args.save_steps and steps is not None):
        return
    z_steps, x_steps = steps       # [S1,B,K,D], [S2,B,T,D]
    frames_dir = os.path.join(args.out_dir, "steps")
    os.makedirs(frames_dir, exist_ok=True)
    frames = [("stage1", si, host(interpolate_from_indices(idx[:1], z_steps[si][:1].float(), T))[0])
              for si in range(z_steps.shape[0])]
    frames += [("stage2", si, host(x_steps[si][0])) for si in range(x_steps.shape[0])]
    paths = [plot_occupancy_trajectories(
        occ[0], [gt[0], traj], labels=["gt", stage], keypoints=z_np[0], start_goal=sg[0],
        out_path=os.path.join(frames_dir, f"frame_{fi:03d}.png"), title=f"{stage} step {si}")
        for fi, (stage, si, traj) in enumerate(frames)]
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("--save_steps writes a GIF and needs the PIL (Pillow) package, "
                          "which is not installed") from e
    try:
        imgs = [Image.open(p) for p in paths]
        imgs[0].save(os.path.join(args.out_dir, "diffusion_steps.gif"), save_all=True,
                     append_images=imgs[1:], duration=200, loop=0)
    except Exception as e:  # the PNG frames remain the durable output
        print(f"gif export skipped ({e})")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sample_generate (end-to-end, GPU)")
    p.add_argument("--kp_ckpt", type=str, required=True)
    p.add_argument("--interp_ckpt", type=str, required=True)
    p.add_argument("--use_ema", type=int, default=1)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--ddim_steps", type=int, default=20)
    p.add_argument("--time_spacing", type=str, default="quadratic",
                   choices=["linear", "quadratic", "sqrt"])
    p.add_argument("--kp_index_mode", type=str, default="uniform",
                   choices=["random", "uniform", "uniform_jitter", "selector"])
    p.add_argument("--kp_jitter", type=float, default=0.0)
    p.add_argument("--selector_ckpt", type=str, default=None)
    p.add_argument("--dphi_ckpt", type=str, default=None,
                   help="segment-cost ckpt for the kp_feat cost channels; required when the "
                        "Stage-1 meta says kp_feat_dphi")
    p.add_argument("--selector_stochastic", type=int, default=0)
    p.add_argument("--selector_tau", type=float, default=1.0)
    p.add_argument("--stage2_mask_policy", type=str, default="base",
                   choices=["base", "selector"])
    p.add_argument("--stage2_mode", type=str, default=None, help="default: from meta")
    p.add_argument("--clamp_policy", type=str, default="endpoints",
                   choices=["endpoints", "all_anchors", "none"])
    p.add_argument("--clamp_dims", type=str, default="pos", choices=["pos", "all"])
    p.add_argument("--soft_anchor_clamp", type=int, default=0)
    p.add_argument("--s2_delta_smooth", type=int, default=0,
                   help="N passes of 3-tap binomial smoothing at missing frames after each "
                        "Stage-2 level (0 = off)")
    p.add_argument("--anchor_conf_override", type=float, default=None,
                   help="confidence presented for interior anchors in the Stage-2 conf "
                        "channel (default: the training teacher value)")
    p.add_argument("--soft_clamp_schedule", type=str, default="linear")
    p.add_argument("--soft_clamp_max", type=float, default=0.5)
    p.add_argument("--s2_noise_mode", type=str, default="none",
                   choices=["none", "constant", "level"])
    p.add_argument("--s2_noise_sigma", type=float, default=None,
                   help="level mode: sigma_max (default: the interp ckpt's corrupt_sigma_max); "
                        "constant mode: the sigma")
    p.add_argument("--s2_sigma_min", type=float, default=None)
    p.add_argument("--s2_sigma_pow", type=float, default=None)
    p.add_argument("--s2_noise_scale", type=float, default=1.0)
    p.add_argument("--pos_clip", type=int, default=1)
    p.add_argument("--x0_clip", type=float, default=0.0,
                   help=">0: clamp the Stage-1 solver's per-step x0 estimate to +-x0_clip")
    p.add_argument("--compare_oracle", type=int, default=0)
    p.add_argument("--stage1_best_of", type=int, default=1)
    p.add_argument("--stage1_best_of_mode", type=str, default="set", choices=["set", "dp"])
    p.add_argument("--stage1_cache_interval", type=int, default=1)
    p.add_argument("--stage1_solver", type=str, default="ddim", choices=list(SOLVERS))
    p.add_argument("--stage1_cache", type=str, default="")
    p.add_argument("--stage1_cache_mode", type=str, default="none",
                   choices=["none", "save", "load", "auto"])
    p.add_argument("--sample_seed", type=int, default=1234)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--out_dir", type=str, default="runs/samples")
    p.add_argument("--save_npz", type=int, default=1)
    p.add_argument("--sanity", type=int, default=0,
                   help="exit 2 when the summary trips check_summary_sanity (tiny or briefly "
                        "trained models trip it by design)")
    p.add_argument("--save_plots", type=int, default=0,
                   help="plot the first N samples of batch 0 as PNGs (needs matplotlib)")
    p.add_argument("--save_steps", type=int, default=0,
                   help="export per-step diffusion frames (PNG + GIF) for sample 0 of batch 0")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    add_attn_policy_arg(p)
    add_data_args(p)
    return p


def config_from_args(args, kp_meta: Dict, il_meta: Dict) -> PipelineConfig:
    """The pipeline configuration of a CLI run, from its flags and the two
    checkpoints' metas (the JAX CLI's mapping)."""
    return PipelineConfig(
        T=int(kp_meta["T"]), K=int(kp_meta["K"]), levels=int(il_meta["levels"]),
        K_min=int(il_meta["K_min"]), ddim_steps=args.ddim_steps, time_spacing=args.time_spacing,
        k_schedule=il_meta.get("k_schedule", "doubling"),
        stage2_mode=args.stage2_mode or il_meta.get("mode", "adj"),
        anchor_conf=bool(il_meta.get("anchor_conf", 0)),
        anchor_conf_teacher=(args.anchor_conf_override if args.anchor_conf_override is not None
                             else float(il_meta.get("anchor_conf_teacher", 0.95))),
        anchor_conf_anneal_mode=(il_meta.get("anchor_conf_anneal_mode", "none")
                                 if il_meta.get("anchor_conf_anneal") else "none"),
        clamp_endpoints=bool(kp_meta.get("clamp_endpoints", 1)),
        clamp_policy=args.clamp_policy, clamp_dims=args.clamp_dims,
        soft_anchor_clamp=bool(args.soft_anchor_clamp),
        soft_clamp_schedule=args.soft_clamp_schedule, soft_clamp_max=args.soft_clamp_max,
        s2_noise_mode=args.s2_noise_mode,
        **resolve_s2_noise_schedule(args.s2_noise_mode, args.s2_noise_sigma, args.s2_sigma_min,
                                    args.s2_sigma_pow, il_meta),
        s2_noise_scale=args.s2_noise_scale, pos_clip=bool(args.pos_clip),
        logit_space=bool(kp_meta.get("logit_space", 0)),
        logit_eps=float(kp_meta.get("logit_eps", 1e-5)),
        recompute_vel=bool(il_meta.get("recompute_vel", 0)) and int(kp_meta["data_dim"]) == 4,
        x0_clip=args.x0_clip, s2_delta_smooth=args.s2_delta_smooth,
        stage2_mask_policy=args.stage2_mask_policy, collect_steps=bool(args.save_steps),
        stage1_cache_interval=args.stage1_cache_interval, stage1_solver=args.stage1_solver,
        stage1_objective=kp_meta.get("objective", "eps"), stage1_best_of=args.stage1_best_of,
        stage1_best_of_mode=args.stage1_best_of_mode,
        kp_feat_dim=int(kp_meta.get("kp_feat_dim", 0)) if kp_meta.get("use_kp_feat") else 0)


def _load_stage1_cache(path: str, cond: Dict[str, torch.Tensor], device):
    """(idx, z_pred) of a cached batch; the start endpoint must match the
    current conditioning."""
    with np.load(path) as f:
        idx, z = f["idx"], f["z_pred"]
    sg = cond["start_goal"].cpu().numpy()
    first_is_start = idx[:, 0] == 0
    if np.any(first_is_start):
        err = np.abs(z[first_is_start, 0, :2] - sg[first_is_start, :2]).max()
        if err > 1e-3:
            raise ValueError(f"stage1 cache {path} endpoint mismatch ({err:.4f}); "
                             "conditioning changed since the cache was written")
    return torch.as_tensor(idx).long().to(device), torch.as_tensor(z).to(device)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    kp_model, kp_meta = load_keypoint_model(args.kp_ckpt, bool(args.bf16), bool(args.use_ema),
                                            device=device)
    interp_model, il_meta = load_interp_model(args.interp_ckpt, bool(args.bf16),
                                              bool(args.use_ema), device=device)
    for m in (kp_model, interp_model):
        m.set_attn_policy(args.attn_policy)
    cfg = config_from_args(args, kp_meta, il_meta)
    T, K = cfg.T, cfg.K
    data_dim = int(kp_meta["data_dim"])
    selector, sel_meta = None, {}
    if args.kp_index_mode == "selector" or args.stage2_mask_policy == "selector":
        if not args.selector_ckpt:
            raise ValueError("selector mode requested but --selector_ckpt missing")
        selector, sel_meta = load_selector_model(args.selector_ckpt, bool(args.bf16),
                                                 device=device)
    dphi_fn = None
    if args.dphi_ckpt:
        dphi_fn, _ = make_dphi_seg_cost_fn(args.dphi_ckpt, T, kp_meta.get("use_sdf"),
                                           bool(args.bf16), device=device)
    elif kp_meta.get("kp_feat_dphi"):
        raise ValueError("Stage-1 ckpt was trained with D_phi kp_feat cost channels (meta "
                         "kp_feat_dphi=1): pass --dphi_ckpt, or sampling runs off-distribution "
                         "(channels 3/4 zero)")
    kp_schedule = make_schedule(kp_meta["schedule"], int(kp_meta["N_train"]), device=device)
    pipeline = make_pipeline(kp_model, interp_model, kp_schedule, cfg, data_dim, dphi_fn)

    args.T = T  # for make_dataset
    ds, _ = make_dataset(args)
    host_rng = np.random.RandomState(args.sample_seed)
    gen = torch.Generator(device=device).manual_seed(args.sample_seed)
    to_dev = lambda a: torch.as_tensor(a).to(device)

    os.makedirs(args.out_dir, exist_ok=True)
    rows = []
    all_out = {k: [] for k in ("interp", "refined", "keypoints", "idx", "gt", "occ",
                               "start_goal")}
    policy = {"random": "random:1.0", "uniform": "uniform:1.0", "uniform_jitter": "uniform:1.0",
              "selector": "uniform:1.0"}[args.kp_index_mode]
    jitter = args.kp_jitter if args.kp_index_mode == "uniform_jitter" else 0.0
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    t_total, n_total = 0.0, 0
    for bi in range(args.num_batches):
        batch = ds.get_batch(host_rng.randint(0, len(ds), size=args.batch))
        cond = {"occ": to_dev(batch["occ"]), "start_goal": to_dev(batch["start_goal"])}
        if "sdf" in batch and (kp_meta.get("use_sdf") or il_meta.get("use_sdf")
                               or sel_meta.get("use_sdf")):
            cond["sdf"] = to_dev(batch["sdf"])
        sel_logits = None
        if selector is not None:
            sel_cond = dict(cond)
            if sel_meta.get("use_level"):
                sel_cond["level"] = torch.full((args.batch, 1), K / max(1, T - 1), device=device)
            with torch.no_grad():
                sel_logits = selector(sel_cond)
        if args.kp_index_mode == "selector":
            idx = select_topk_indices(sel_logits, K, bool(args.selector_stochastic),
                                      args.selector_tau, generator=gen)
        else:
            idx = to_dev(sample_idx_policy(host_rng, policy, args.batch, T, K, None,
                                           jitter)).long()
        draws = make_draws(cfg, args.batch, data_dim, gen, device)
        # Stage-1 cache: {idx, z_pred} per batch, checked against the
        # current conditioning on load
        z_override = None
        cache_path = (os.path.join(args.stage1_cache, f"stage1_{bi:04d}.npz")
                      if args.stage1_cache else None)
        mode = args.stage1_cache_mode
        cached = bool(cache_path) and mode in ("load", "auto") and os.path.exists(cache_path)
        if cached:
            idx, z_override = _load_stage1_cache(cache_path, cond, device)
        sync()
        t0 = time.perf_counter()
        out = pipeline(idx, cond, z_override=z_override, selector_logits=sel_logits, **draws)
        x_interp, x_refined, z_pred = out[:3]
        sync()
        dt = time.perf_counter() - t0
        if cache_path and (mode == "save" or (mode == "auto" and not cached)):
            os.makedirs(args.stage1_cache, exist_ok=True)
            np.savez_compressed(cache_path, idx=idx.cpu().numpy().astype(np.int32),
                                z_pred=z_pred.cpu().numpy())
        if bi > 0:  # the first batch holds the warm-up
            t_total += dt
            n_total += args.batch

        gt = to_dev(batch["x"])
        goal = cond["start_goal"][:, 2:]
        variants = {"interp": compute_metrics_batch(cond["occ"], x_interp, goal, gt),
                    "refined": compute_metrics_batch(cond["occ"], x_refined, goal, gt)}
        if args.compare_oracle:
            xo_i, xo_r = pipeline(idx, cond, z_override=gather_keypoints(gt, idx),
                                  selector_logits=sel_logits, **draws)[:2]
            variants["oracle_interp"] = compute_metrics_batch(cond["occ"], xo_i, goal, gt)
            variants["oracle_refined"] = compute_metrics_batch(cond["occ"], xo_r, goal, gt)
        host = {v: {m: t.cpu().numpy() for m, t in vm.items()} for v, vm in variants.items()}
        for b in range(args.batch):
            row = {"batch": bi, "sample": b}
            for vname, vm in host.items():
                for mname, mv in vm.items():
                    row[f"{vname}_{mname}"] = float(mv[b])
            rows.append(row)
        for key, t in (("interp", x_interp), ("refined", x_refined), ("keypoints", z_pred),
                       ("idx", idx.int())):
            all_out[key].append(t.cpu().numpy())
        for key, src in (("gt", "x"), ("occ", "occ"), ("start_goal", "start_goal")):
            all_out[key].append(np.asarray(batch[src]))
        if bi == 0 and (args.save_plots or args.save_steps):
            export_viz(args, batch, idx, z_pred, x_interp, x_refined,
                       out[3] if len(out) > 3 else None, T)
        print(f"batch {bi}: {dt:.3f}s "
              f"coll(interp)={host['interp']['collision_rate'].mean():.4f} "
              f"coll(refined)={host['refined']['collision_rate'].mean():.4f} "
              f"succ={host['refined']['success'].mean():.3f}", flush=True)

    with open(os.path.join(args.out_dir, "metrics.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    summary = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k not in ("batch", "sample")}
    if n_total:
        summary["samples_per_sec"] = n_total / t_total
    sanity = check_summary_sanity(summary)
    summary["sanity"] = sanity
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    from ..utils.run_config import archive_evidence, write_run_config

    write_run_config(args.out_dir, args)
    archive_evidence(args.out_dir)
    if args.save_npz:
        np.savez_compressed(os.path.join(args.out_dir, "samples.npz"),
                            **{k: np.concatenate(v) for k, v in all_out.items()})
    print("summary:", json.dumps(summary, indent=2), flush=True)
    if sanity["failures"] and args.sanity:
        print("SANITY FAILED:", "; ".join(sanity["failures"]), file=sys.stderr)
        sys.exit(2)
    return summary


def check_summary_sanity(summary: Dict[str, float]) -> Dict:
    """Hard quality thresholds for sampling summaries: Stage 2 making
    trajectories drastically worse, or MSE-to-GT at garbage magnitudes
    (positions live in [0, 1]^2), mark a broken pipeline rather than a weak
    model."""
    failures = []
    g = summary.get
    bm = g("mse_to_gt")
    if bm is not None and bm > 5.0:
        failures.append(f"mse_to_gt={bm:.3f} > 5.0")
    for pre in ("", "oracle_"):
        im, rm = g(f"{pre}interp_mse_to_gt"), g(f"{pre}refined_mse_to_gt")
        ic, rc = g(f"{pre}interp_collision_rate"), g(f"{pre}refined_collision_rate")
        if im is not None and im > 5.0:
            failures.append(f"{pre}interp_mse_to_gt={im:.3f} > 5.0")
        if rm is not None and im is not None and rm > max(10.0 * im, im + 0.5):
            failures.append(f"{pre}refined_mse_to_gt={rm:.3f} >> interp {im:.3f} "
                            "(Stage-2 diverges)")
        if rc is not None and ic is not None and rc > ic + 0.2:
            failures.append(f"{pre}refined_collision={rc:.3f} > interp {ic:.3f} + 0.2")
    return {"ok": not failures, "failures": failures}


if __name__ == "__main__":
    main()
