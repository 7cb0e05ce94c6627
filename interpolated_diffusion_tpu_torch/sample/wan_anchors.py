"""Phase-1 anchor sampling through WanDiT (port of the use_wan path of
data/precompute_phase1_anchors.py::main, `sample_anchors`).

DDIM over the K anchor frames of each clip: tokens [B, K, N, D_tok] (outer
patch p: N = (H/p)(W/p), D_tok = C p^2) are unpatchified to latents
[B, C, K, H, W] for the model, which sees the anchors' absolute frame
indices (RoPE) and, with frame conditioning, per-frame features of the
anchor mask as extra cross-attention tokens. The noise `z_init` and the
anchor indices `idx` are inputs, so that a test can hand in JAX's draws.

The solver is DDIM with every step evaluated (the CLI's defaults). The
tar/shard CLI, the pfdiff / dpm solvers, FORA block caching
(--cache_interval > 1) and the timestep-adaptive top-k schedule are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.ddpm import make_timesteps, run_solver
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..utils.frame_features import frame_features_from_mask
from ..utils.video_tokens import patchify_latents, unpatchify_tokens


@dataclass
class AnchorConfig:
    """Static sampler knobs: a Phase-1 wansynth checkpoint's meta (T, K,
    latent shape, outer patch, schedule) and the precompute CLI's defaults."""

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

    @property
    def spatial(self):
        return self.latent_h // self.patch_size, self.latent_w // self.patch_size


def make_anchor_sampler(cfg: AnchorConfig, model, fc=None,
                        schedule: Optional[DiffusionSchedule] = None):
    """Returns sample_anchors(z_init [B, K, N, D_tok], idx [B, K], text
    [B, L_text, text_dim]) -> anchors [B, K, C, H, W] float32.

    `model` is a WanDiT, `fc` its FrameCondProjector (needed when
    cfg.frame_cond). Everything runs on z_init's device, under
    torch.inference_mode().
    """
    if cfg.frame_cond and fc is None:
        raise ValueError("cfg.frame_cond needs the FrameCondProjector `fc`")
    schedule = schedule or make_schedule(cfg.schedule, cfg.n_train)
    times = make_timesteps(cfg.n_train, cfg.ddim_steps, "quadratic")
    p, spatial = cfg.patch_size, cfg.spatial

    @torch.inference_mode()
    def sample_anchors(z_init: torch.Tensor, idx: torch.Tensor,
                       text: torch.Tensor) -> torch.Tensor:
        B, device = z_init.shape[0], z_init.device
        idx = idx.long()
        sched = schedule if schedule.betas.device == device else schedule.to(device)
        extra = None
        if cfg.frame_cond:  # depends on idx only: once per call, not per step
            mask = torch.zeros((B, cfg.T), dtype=torch.bool, device=device)
            mask.scatter_(1, idx, True)
            ff = frame_features_from_mask(mask)
            feat = torch.gather(ff, 1, idx[..., None].expand(-1, -1, ff.shape[-1]))
            extra = fc(feat)

        def eps_fn(z_tokens: torch.Tensor, t_b: torch.Tensor) -> torch.Tensor:
            lat_in = unpatchify_tokens(z_tokens.float(), p, spatial).transpose(1, 2)
            pred = model(lat_in, t_b, text, idx, extra)
            return patchify_latents(pred.transpose(1, 2), p)[0]

        z = run_solver("ddim", eps_fn, z_init.float(), times, sched)
        return unpatchify_tokens(z, p, spatial)

    return sample_anchors
