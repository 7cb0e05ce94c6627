"""GenerationService: checkpoint-backed, bucket-batched end-to-end generation
(port of serve/service.py).

The serving counterpart of sample/generate.py's offline loop:

  * a small set of BATCH BUCKETS: every request batch is padded up to the
    nearest bucket, and `warmup()` runs each bucket once at start-up, so the
    kernels' first launches and the allocator's first blocks come before any
    live request;
  * one call of sample/generate.make_pipeline per request batch (Stage-1
    solver, interpolation, Stage-2 levels), on the card unless the caller
    passes `device="cpu"`, under `attn_policy` (fused by default, as the
    sampling CLI);
  * host-prepared conditioning: the anchor indices come from
    `sample_idx_policy(np.random.RandomState(seed), ...)` exactly as in the
    JAX service; the pipeline's random draws come from a `torch.Generator`
    seeded by `seed` through `make_draws` (not JAX's PRNG, so the samples are
    another, equally valid draw than the JAX service's for the same seed).

A lock serialises the dispatch; copying the results back to the host (the
completion barrier) happens outside it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


class GenerationService:
    """Load once, generate many: thread-safe batched maze/trajectory serving.

    Defaults mirror the sampling CLI's; quality knobs (best-of-N anchors,
    the PFDiff / DPM solvers, FORA caching) compose the same way.
    """

    def __init__(
        self,
        kp_ckpt: str,
        interp_ckpt: str,
        *,
        dphi_ckpt: str = "",
        ddim_steps: int = 20,
        stage1_solver: str = "ddim",
        stage1_best_of: int = 1,
        stage1_cache_interval: int = 1,
        s2_noise_mode: str = "none",
        s2_noise_sigma: float = 0.0,
        idx_policy: str = "uniform:1.0",
        buckets: Sequence[int] = (1, 4, 16, 64),
        bf16: bool = True,
        warm: bool = False,   # call warmup() after set_default_grid so the
                              # warmed shapes match the served grid
        device: str = "cuda",
        attn_policy: str = "fused",
    ) -> None:
        from ..models.loading import (load_interp_model, load_keypoint_model,
                                      make_dphi_seg_cost_fn)
        from ..ops.schedules import make_schedule
        from ..sample.generate import PipelineConfig, make_pipeline
        from ..train.common import resolve_device

        self.device = resolve_device(device)
        kp_model, kp_meta = load_keypoint_model(kp_ckpt, bf16, device=self.device)
        it_model, il_meta = load_interp_model(interp_ckpt, bf16, device=self.device)
        for m in (kp_model, it_model):
            m.set_attn_policy(attn_policy)
        self.T, self.K = int(kp_meta["T"]), int(kp_meta["K"])
        self.data_dim = int(kp_meta["data_dim"])
        self.use_sdf = bool(kp_meta.get("use_sdf") or il_meta.get("use_sdf"))
        self._idx_policy = idx_policy

        dphi_fn = None
        if dphi_ckpt:
            dphi_fn, _ = make_dphi_seg_cost_fn(dphi_ckpt, self.T, kp_meta.get("use_sdf"), bf16,
                                               device=self.device)
        elif kp_meta.get("kp_feat_dphi"):
            raise ValueError("Stage-1 ckpt needs D_phi kp_feat channels — pass dphi_ckpt")

        self.cfg = PipelineConfig(
            T=self.T, K=self.K, levels=int(il_meta["levels"]), K_min=int(il_meta["K_min"]),
            ddim_steps=ddim_steps, k_schedule=il_meta.get("k_schedule", "doubling"),
            stage2_mode=il_meta.get("mode", "adj"),
            anchor_conf=bool(il_meta.get("anchor_conf", 0)),
            anchor_conf_anneal_mode=(il_meta.get("anchor_conf_anneal_mode", "none")
                                     if il_meta.get("anchor_conf_anneal") else "none"),
            clamp_endpoints=bool(kp_meta.get("clamp_endpoints", 1)),
            s2_noise_mode=s2_noise_mode, s2_noise_sigma=s2_noise_sigma,
            logit_space=bool(kp_meta.get("logit_space", 0)),
            logit_eps=float(kp_meta.get("logit_eps", 1e-5)),
            recompute_vel=bool(il_meta.get("recompute_vel", 0)) and self.data_dim == 4,
            stage1_solver=stage1_solver, stage1_best_of=stage1_best_of,
            stage1_cache_interval=stage1_cache_interval,
            kp_feat_dim=(int(kp_meta.get("kp_feat_dim", 0))
                         if kp_meta.get("use_kp_feat") else 0))
        kp_schedule = make_schedule(kp_meta["schedule"], int(kp_meta["N_train"]),
                                    device=self.device)
        self._pipeline = make_pipeline(kp_model, it_model, kp_schedule, self.cfg,
                                       self.data_dim, dphi_fn)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._lock = threading.Lock()   # one dispatch at a time per service
        self._default_grid: Optional[Dict[str, np.ndarray]] = None
        if warm:
            self.warmup()

    # -- conditioning helpers ------------------------------------------------

    def set_default_grid(self, occ: np.ndarray, sdf: Optional[np.ndarray] = None) -> None:
        """Install a server-side occupancy grid ([H, W] or [1, H, W]) used
        when requests carry only start/goal."""
        occ = np.asarray(occ, np.float32)
        if occ.ndim == 2:
            occ = occ[None]
        grid = {"occ": occ}
        if self.use_sdf:
            if sdf is None:
                from ..data.maze import sdf_from_occupancy

                sdf = sdf_from_occupancy(occ[0])[None]
            grid["sdf"] = np.asarray(sdf, np.float32)
        self._default_grid = grid

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds the largest bucket {self.buckets[-1]}; "
                         "split the request")

    def draws(self, nb: int, seed: int) -> Dict[str, torch.Tensor]:
        """The pipeline's random draws for a served batch of nb rows under
        `seed` (sample/generate.make_draws from a generator seeded by seed)."""
        from ..sample.generate import make_draws

        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return make_draws(self.cfg, nb, self.data_dim, gen, self.device)

    # -- the serving entry ---------------------------------------------------

    def generate(
        self,
        start_goal: np.ndarray,                 # [B, 4] (x0, y0, xg, yg)
        occ: Optional[np.ndarray] = None,       # [B, 1, H, W] / [B, H, W]
        sdf: Optional[np.ndarray] = None,
        seed: int = 0,
        timing: Optional[Dict[str, float]] = None,
    ) -> Dict[str, np.ndarray]:
        """Generate refined trajectories for B (start, goal) pairs.

        Pads to the nearest bucket, runs one pipeline call and returns host
        arrays sliced back to B: interp [B, T, D], refined [B, T, D],
        keypoints [B, K, D], idx [B, K], served_batch (the bucket size).

        Determinism: one seed drives the whole call, so a row's draws depend
        on its position in the served batch: the same (inputs, seed) alone
        and coalesced with other requests give different, equally valid
        samples.
        """
        from ..train.common import sample_idx_policy

        t0 = time.perf_counter()
        start_goal = np.atleast_2d(np.asarray(start_goal, np.float32))
        B = start_goal.shape[0]
        if occ is None:
            if self._default_grid is None:
                raise ValueError("request has no occ and no default grid is installed "
                                 "(set_default_grid)")
            occ = np.broadcast_to(self._default_grid["occ"][None],
                                  (B, *self._default_grid["occ"].shape))
            if self.use_sdf and sdf is None:
                sdf = np.broadcast_to(self._default_grid["sdf"][None],
                                      (B, *self._default_grid["sdf"].shape))
        occ = np.asarray(occ, np.float32)
        if occ.ndim == 3:
            occ = occ[:, None]
        if occ.shape[0] == 1 and B > 1:
            # one shared grid for the whole request batch
            occ = np.broadcast_to(occ, (B, *occ.shape[1:])).copy()
            if sdf is not None:
                sdf = np.asarray(sdf, np.float32)
                sdf = sdf[None] if sdf.ndim == 2 else sdf
                sdf = sdf[:, None] if sdf.ndim == 3 else sdf
                sdf = np.broadcast_to(sdf, (B, *sdf.shape[1:])).copy()
        if occ.shape[0] != B:
            raise ValueError(f"occ batch {occ.shape[0]} does not match start_goal batch {B} "
                             "(send one grid per sample, or a single shared grid)")
        if self.use_sdf and sdf is None:
            from ..data.maze import sdf_from_occupancy

            sdf = np.stack([sdf_from_occupancy(o[0]) for o in occ])[:, None]
        if sdf is not None:
            sdf = np.asarray(sdf, np.float32)
            if sdf.ndim == 3:
                sdf = sdf[:, None]

        nb = self._bucket(B)
        pad = nb - B

        def padded(x):
            return np.concatenate([x, np.repeat(x[-1:], pad, 0)]) if pad else x

        idx = sample_idx_policy(np.random.RandomState(seed), self._idx_policy, nb, self.T,
                                self.K, None, 0.0)
        t_prep = time.perf_counter()
        to_dev = lambda a: torch.tensor(np.asarray(a)).to(self.device)
        cond = {"occ": to_dev(padded(occ)), "start_goal": to_dev(padded(start_goal))}
        if self.use_sdf:
            cond["sdf"] = to_dev(padded(sdf))
        idx_dev = to_dev(idx).long()
        draws = self.draws(nb, seed)
        t_put = time.perf_counter()
        # the lock covers the dispatch only: the copy back to the host below
        # waits for the device and runs outside it, so that the next
        # request's preparation and dispatch overlap this one's compute
        with self._lock:
            x_interp, x_refined, z_pred = self._pipeline(idx_dev, cond, **draws)[:3]
        t_dispatch = time.perf_counter()
        out = {
            "interp": x_interp[:B].float().cpu().numpy(),
            "refined": x_refined[:B].float().cpu().numpy(),
            "keypoints": z_pred[:B].float().cpu().numpy(),
            "idx": idx[:B],
            "served_batch": nb,
        }
        if timing is not None:
            timing.update(prep_s=t_prep - t0, put_s=t_put - t_prep,
                          dispatch_s=t_dispatch - t_put,
                          pull_s=time.perf_counter() - t_dispatch, served_batch=nb)
        return out

    def warmup(self) -> None:
        """Run every bucket once, so that no live request pays a first call."""
        H = W = 8
        if self._default_grid is not None:
            H, W = self._default_grid["occ"].shape[-2:]
        for b in self.buckets:
            sg = np.tile(np.asarray([[0.1, 0.1, 0.9, 0.9]], np.float32), (b, 1))
            self.generate(sg, np.zeros((b, 1, H, W), np.float32), seed=0)
