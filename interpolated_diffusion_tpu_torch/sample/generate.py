"""End-to-end generation: Stage-1 keypoints -> interpolation -> Stage-2 refine
(port of sample/generate.py::make_pipeline, the path bench.py times).

The JAX package compiles the pipeline into one XLA program; here it runs
eagerly under torch.inference_mode(). Random draws are explicit: the Stage-1
initial noise `z_init` [B, K, D] and the Stage-2 mask priorities `mask_rand`
[B, T] are drawn from a `torch.Generator` unless the caller passes them (a
parity test passes the draws JAX made: normal(k1, (B, K, D)) and
uniform(k2, (B, T)) with k1, k2 = split(key)).

Supported knobs are those of the bench configuration (DDIM, adj / x0 Stage-2
modes, endpoint / all-anchor / no clamp, position clip, x0 clip); every other
knob of the JAX PipelineConfig raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Optional

import torch

from ..ops.clamp import apply_clamp
from ..ops.ddpm import make_timesteps, run_solver
from ..ops.keyframes import build_nested_masks_from_base, interpolate_from_indices
from ..ops.schedules import DiffusionSchedule
from ..train.batches import build_known_mask_values


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
    clamp_endpoints: bool = True
    clamp_policy: str = "endpoints"     # endpoints | all_anchors | none
    clamp_dims: str = "pos"
    pos_clip: bool = False
    pos_clip_min: float = 0.0
    pos_clip_max: float = 1.0
    recompute_vel: bool = False
    x0_clip: float = 0.0
    # knobs of the JAX pipeline that are not ported yet (NotImplementedError
    # unless left at these values)
    anchor_conf: bool = False
    anchor_conf_anneal_mode: str = "none"
    anchor_conf_teacher: float = 0.95
    anchor_conf_endpoints: float = 1.0
    anchor_conf_missing: float = 0.0
    soft_anchor_clamp: bool = False
    soft_clamp_schedule: str = "linear"
    soft_clamp_max: float = 0.5
    s2_noise_mode: str = "none"
    s2_noise_sigma: float = 0.0
    s2_noise_scale: float = 1.0
    s2_sigma_min: float = 0.0
    s2_sigma_pow: float = 1.0
    logit_space: bool = False
    logit_eps: float = 1e-5
    stage2_mask_policy: str = "base"
    collect_steps: bool = False
    stage1_cache_interval: int = 1
    stage1_solver: str = "ddim"
    stage1_objective: str = "eps"
    stage1_best_of: int = 1
    stage1_best_of_mode: str = "set"
    kp_feat_dim: int = 0
    s2_delta_smooth: int = 0


_UNPORTED = ("anchor_conf", "anchor_conf_anneal_mode", "anchor_conf_teacher",
             "anchor_conf_endpoints", "anchor_conf_missing", "soft_anchor_clamp",
             "soft_clamp_schedule", "soft_clamp_max", "s2_noise_mode", "s2_noise_sigma",
             "s2_noise_scale", "s2_sigma_min", "s2_sigma_pow", "logit_space", "logit_eps",
             "stage2_mask_policy", "collect_steps", "stage1_cache_interval",
             "stage1_solver", "stage1_objective", "stage1_best_of", "stage1_best_of_mode",
             "kp_feat_dim", "s2_delta_smooth")


def _default(name: str):
    return next(f.default for f in fields(PipelineConfig) if f.name == name)


def check_supported(cfg: PipelineConfig) -> None:
    for name in _UNPORTED:
        if getattr(cfg, name) != _default(name):
            raise NotImplementedError(
                f"PipelineConfig.{name}={getattr(cfg, name)!r} is not ported yet")
    if cfg.stage2_mode not in ("adj", "x0"):
        raise ValueError(f"unknown stage2_mode {cfg.stage2_mode!r}")
    if cfg.clamp_policy not in ("endpoints", "all_anchors", "none"):
        raise ValueError(f"unknown clamp_policy {cfg.clamp_policy!r}")


def hoist_cond_vec(model, cond: Optional[Dict[str, torch.Tensor]]):
    """Run a denoiser's maze encoder once, returning cond with `cond_vec` set
    (the denoisers then skip their encoder on every DDIM / level step)."""
    if cond is None or "occ" not in cond:
        return cond
    out = dict(cond)
    out["cond_vec"] = model.cond_enc(cond)
    return out


def make_pipeline(kp_model, interp_model, schedule: DiffusionSchedule,
                  cfg: PipelineConfig, data_dim: int):
    """Returns pipeline(idx, cond, *, generator=None, z_init=None,
    mask_rand=None) -> (x_interp [B,T,D], x_refined [B,T,D], z_pred [B,K,D]).

    idx [B, K] holds sorted anchor frames; cond has "occ" [B, 1, G, G] and
    "start_goal" [B, 4]. Everything runs on idx's device.
    """
    check_supported(cfg)
    T, K, levels = cfg.T, cfg.K, cfg.levels
    times = make_timesteps(schedule.n_timesteps, cfg.ddim_steps, cfg.time_spacing)
    x0_clip = cfg.x0_clip if cfg.x0_clip > 0 else None

    def clip_pos(z: torch.Tensor) -> torch.Tensor:
        if not cfg.pos_clip:
            return z
        pos = torch.clamp(z[..., :2], cfg.pos_clip_min, cfg.pos_clip_max)
        return torch.cat([pos, z[..., 2:]], dim=-1)

    def stage1(sched, idx, cond, z_init):
        known_mask, known_values = build_known_mask_values(
            idx, cond, data_dim, T, cfg.clamp_endpoints)
        post = lambda z: clip_pos(torch.where(known_mask, known_values, z))
        eps_fn = lambda z, t_b: kp_model(z, t_b, idx, known_mask, cond, T)
        return run_solver(cfg.stage1_solver, eps_fn, post(z_init), times, sched,
                          post=post, cache_interval=cfg.stage1_cache_interval,
                          x0_clip=x0_clip)

    def stage2(x_pred, idx, cond, mask_rand):
        B = idx.shape[0]
        masks, _ = build_nested_masks_from_base(idx, T, levels, k_schedule=cfg.k_schedule,
                                                rand=mask_rand)
        x = x_pred
        end_mask = torch.zeros_like(masks[:, 0])
        end_mask[:, 0] = end_mask[:, -1] = True
        for s in ([levels] if cfg.stage2_mode == "x0" else range(levels, 0, -1)):
            mask_s = masks[:, s]
            if cfg.stage2_mode == "adj":
                mask_in = torch.stack([mask_s.float(), masks[:, s - 1].float()], dim=-1)
            else:
                mask_in = mask_s
            s_level = torch.full((B,), s, dtype=torch.long, device=idx.device)
            x = x + interp_model(x, s_level, mask_in, cond)
            if cfg.clamp_policy == "all_anchors":
                x = apply_clamp(x, x_pred, mask_s, cfg.clamp_dims)
            elif cfg.clamp_policy == "endpoints":
                x = apply_clamp(x, x_pred, end_mask, cfg.clamp_dims)
            x = clip_pos(x)
        return x

    @torch.inference_mode()
    def pipeline(idx: torch.Tensor, cond: Dict[str, torch.Tensor], *,
                 generator: Optional[torch.Generator] = None,
                 z_init: Optional[torch.Tensor] = None,
                 mask_rand: Optional[torch.Tensor] = None):
        B, device = idx.shape[0], idx.device
        if (z_init is None or mask_rand is None) and generator is None:
            raise ValueError("pipeline needs a generator unless z_init and mask_rand are given")
        if z_init is None:
            z_init = torch.randn((B, K, data_dim), generator=generator, device=device)
        if mask_rand is None:
            mask_rand = torch.rand((B, T), generator=generator, device=device)
        sched = schedule if schedule.betas.device == device else schedule.to(device)
        idx = idx.long()
        # the maze CNN runs once per call, not once per DDIM / level step
        kp_cond = hoist_cond_vec(kp_model, cond)
        it_cond = hoist_cond_vec(interp_model, cond)
        z_pred = stage1(sched, idx, kp_cond, z_init.float())
        x_interp = interpolate_from_indices(idx, z_pred, T,
                                            recompute_velocity=cfg.recompute_vel)
        x_refined = stage2(x_interp, idx, it_cond, mask_rand)
        return x_interp, x_refined, z_pred

    return pipeline
