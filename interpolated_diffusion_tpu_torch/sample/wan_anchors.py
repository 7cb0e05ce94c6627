"""Phase-1 anchor sampling (port of `sample_anchors` in
data/precompute_phase1_anchors.py::main; the CLI around it is
data/precompute_phase1_anchors.py).

The sampler runs over the K anchor frames of each clip: tokens [B, K, N,
D_tok] (outer patch p: N = (H/p)(W/p), D_tok = C p^2). Through a WanDiT the
tokens are unpatchified to latents [B, C, K, H, W], the model sees the
anchors' absolute frame indices (RoPE) and, with frame conditioning,
per-frame features of the anchor mask as extra cross-attention tokens;
through the token denoiser (use_wan 0) the tokens go in as they are. The
noise `z_init` and the anchor indices `idx` are inputs, so that a test can
hand in JAX's draws.

Solvers (ops/ddpm.run_solver): ddim, pfdiff, dpm. FORA block caching
(`cache_interval` > 1, ddim only, WanDiT only) runs the block stack every
interval-th step and reuses its residual in between. The timestep-adaptive
top-k schedule (`topk_schedule` [(frac, topk), ...], sla / sage_sla WanDiT
only) cuts the timestep grid into contiguous overlapping segments and runs
each under its own SLA top-k, the same weights throughout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.ddpm import make_timesteps, run_solver
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..utils.frame_features import frame_features_from_mask
from ..utils.video_tokens import patchify_latents, unpatchify_tokens


@dataclass
class AnchorConfig:
    """Static sampler knobs: a Phase-1 wansynth checkpoint's meta (T, K,
    latent shape, outer patch, schedule) and the precompute CLI's options."""

    T: int = 21
    K: int = 5
    latent_c: int = 16
    latent_h: int = 60
    latent_w: int = 104
    patch_size: int = 2
    n_train: int = 1000
    schedule: str = "linear"
    ddim_steps: int = 4
    frame_cond: bool = True
    solver: str = "ddim"
    cache_interval: int = 1
    topk_schedule: Optional[Sequence[Tuple[float, float]]] = None

    @property
    def spatial(self):
        return self.latent_h // self.patch_size, self.latent_w // self.patch_size


def topk_segments(times, topk_schedule) -> List[Tuple[list, Optional[float]]]:
    """[(times of the segment, its SLA top-k)]: the whole grid under the
    model's own top-k without a schedule; with one, contiguous slices sharing
    their end points, segment i up to round(frac_i * S) of the S steps."""
    times = np.asarray(times)
    if not topk_schedule:
        return [(times, None)]
    S, prev, segments = len(times) - 1, 0, []
    for frac, tk in topk_schedule:
        hi = min(S, max(prev, round(frac * S)))
        if hi > prev:
            segments.append((times[prev:hi + 1], float(tk)))
        prev = hi
    return segments


def make_anchor_sampler(cfg: AnchorConfig, model, fc=None,
                        schedule: Optional[DiffusionSchedule] = None):
    """Returns sample_anchors(z_init [B, K, N, D_tok], idx [B, K], text
    [B, L_text, text_dim]) -> anchors [B, K, C, H, W] float32.

    `model` is a WanDiT (`fc` its FrameCondProjector, needed when
    cfg.frame_cond) or a VideoTokenKeypointDenoiser. Everything runs on
    z_init's device, under torch.inference_mode().
    """
    from ..models.wan_dit import WanDiT

    use_wan = isinstance(model, WanDiT)
    if use_wan and cfg.frame_cond and fc is None:
        raise ValueError("cfg.frame_cond needs the FrameCondProjector `fc`")
    interval = max(1, int(cfg.cache_interval))
    if interval > 1 and not use_wan:
        raise ValueError("--cache_interval > 1 needs a use_wan checkpoint (block caching "
                         "lives in the WanDiT forward)")
    if interval > 1 and cfg.solver == "pfdiff":
        raise ValueError("--solver pfdiff and --cache_interval > 1 both substitute model "
                         "evals: pick one")
    if cfg.topk_schedule:
        if not use_wan:
            raise ValueError("--sla_topk_schedule needs a use_wan checkpoint")
        if model.blocks[0].attn1.attn_mode not in ("sla", "sage_sla"):
            raise ValueError("--sla_topk_schedule needs attn_mode sla/sage_sla")
    schedule = schedule or make_schedule(cfg.schedule, cfg.n_train)
    segments = topk_segments(make_timesteps(cfg.n_train, cfg.ddim_steps, "quadratic"),
                             cfg.topk_schedule)
    p, spatial = cfg.patch_size, cfg.spatial
    if use_wan:
        pt, ph, pw = model.patch_size
        cache_tokens = (cfg.K // pt) * (cfg.latent_h // ph) * (cfg.latent_w // pw)

    @torch.inference_mode()
    def sample_anchors(z_init: torch.Tensor, idx: torch.Tensor,
                       text: torch.Tensor) -> torch.Tensor:
        B, device = z_init.shape[0], z_init.device
        idx = idx.long()
        sched = schedule if schedule.betas.device == device else schedule.to(device)
        extra = None
        if use_wan and cfg.frame_cond:  # depends on idx only: once per call, not per step
            mask = torch.zeros((B, cfg.T), dtype=torch.bool, device=device)
            mask.scatter_(1, idx, True)
            ff = frame_features_from_mask(mask)
            feat = torch.gather(ff, 1, idx[..., None].expand(-1, -1, ff.shape[-1]))
            extra = fc(feat)

        def eps_fn(z_tokens: torch.Tensor, t_b: torch.Tensor, blocks_delta=None,
                   return_delta: bool = False):
            if not use_wan:
                return model(z_tokens.float(), t_b, idx, {"text_embed": text}, cfg.T, spatial)
            lat_in = unpatchify_tokens(z_tokens.float(), p, spatial).transpose(1, 2)
            pred = model(lat_in, t_b, text, idx, extra, blocks_delta=blocks_delta,
                         return_delta=return_delta)
            pred, delta = pred if return_delta else (pred, None)
            out = patchify_latents(pred.transpose(1, 2), p)[0]
            return (out, delta) if return_delta else out

        z = z_init.float()
        saved = model.blocks[0].attn1.sla.topk if cfg.topk_schedule else None
        try:
            for seg_times, topk in segments:
                if topk is not None:
                    model.set_sla_topk(topk)
                delta0 = None
                if interval > 1:
                    dtype = model.compute_dtype or model.proj_out.weight.dtype
                    delta0 = torch.zeros((B, cache_tokens, model.dim), dtype=dtype, device=device)
                z = run_solver(cfg.solver, eps_fn, z, seg_times, sched,
                               cache_interval=interval, delta0=delta0)
        finally:
            if saved is not None:
                model.set_sla_topk(saved)
        return unpatchify_tokens(z, p, spatial)

    return sample_anchors
