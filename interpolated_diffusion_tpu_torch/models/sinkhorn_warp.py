"""Sinkhorn correspondence warp interpolator (port of models/sinkhorn_warp.py).

Global SE(2) alignment by phase correlation (an FFT cross-power peak per
rotation of a fixed angle list), windowed log-domain Sinkhorn matching of
L2-normalised patch tokens with a dustbin row and column, a learnable
temperature (softplus) and dustbin logit, optional spatial penalty / radius,
forward-backward consistency confidence, the flow composed through the
global SE(2), and a confidence-weighted warp of both anchors with a lerp
fallback where the confidence vanishes. Optionally matches (and warps) in a
straightener's space.

Windows are batched per window-size class: the main grid in one batch,
then the right, bottom and corner tails; overlapping windows
(win_stride < win_size) accumulate confidence-weighted. The phase-
correlation argmax and the best angle are discrete choices: on inputs
without one clear peak, rounding can pick another.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import grid_sample_bilinear, resize_bilinear, warp
from ..utils.video_tokens import patchify_latents
from .flow_interpolator import gather_frames, segment_of_frames, set_anchors


def sinkhorn_log(logits: torch.Tensor, iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn normalisation over the last two dims."""
    logp = logits
    for _ in range(int(iters)):
        logp = logp - torch.logsumexp(logp, dim=-1, keepdim=True)
        logp = logp - torch.logsumexp(logp, dim=-2, keepdim=True)
    return logp


def _linspace(n: int, device) -> torch.Tensor:
    return torch.linspace(-1.0, 1.0, n, device=device) if n > 1 else torch.zeros(1, device=device)


def _affine_sample(feats: torch.Tensor, theta: torch.Tensor, dx: torch.Tensor,
                   dy: torch.Tensor, pad_zero: bool = True) -> torch.Tensor:
    """Per-sample SE(2) (rotation about the centre, then a shift in tokens)
    of feats [B, Hp, Wp, D] by align_corners=True sampling; zero outside."""
    B, Hp, Wp, D = feats.shape
    gy, gx = torch.meshgrid(_linspace(Hp, feats.device), _linspace(Wp, feats.device),
                            indexing="ij")
    cos_t, sin_t = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    tx = (2.0 * dx / max(Wp - 1, 1))[:, None, None]
    ty = (2.0 * dy / max(Hp - 1, 1))[:, None, None]
    sx = cos_t * gx[None] - sin_t * gy[None] + tx
    sy = sin_t * gx[None] + cos_t * gy[None] + ty
    out = grid_sample_bilinear(feats.permute(0, 3, 1, 2), torch.stack([sx, sy], dim=-1))
    if pad_zero:
        inside = (sx >= -1.0) & (sx <= 1.0) & (sy >= -1.0) & (sy <= 1.0)
        out = out * inside[:, None]
    return out.permute(0, 2, 3, 1)


def _phasecorr_shift(f0: torch.Tensor, f1: torch.Tensor):
    """FFT cross-power peak shift of f0 / f1 [B, C, Hp, Wp] -> (dx, dy, peak) [B]."""
    B, C, Hp, Wp = f0.shape
    f0 = f0 - f0.mean(dim=(2, 3), keepdim=True)
    f1 = f1 - f1.mean(dim=(2, 3), keepdim=True)
    R = (torch.fft.rfft2(f0) * torch.conj(torch.fft.rfft2(f1))).sum(dim=1)
    R = R / (torch.abs(R) + 1e-6)
    flat = torch.fft.irfft2(R, s=(Hp, Wp)).reshape(B, -1)
    idx = torch.argmax(flat, dim=-1)
    peak = torch.gather(flat, 1, idx[:, None])[:, 0]
    dy, dx = idx // Wp, idx % Wp
    dy = torch.where(dy > Hp // 2, dy - Hp, dy).float()
    dx = torch.where(dx > Wp // 2, dx - Wp, dx).float()
    return dx, dy, peak


def _coords(h: int, w: int, device) -> torch.Tensor:
    """[h*w, 2] (x, y) token coordinates of an h x w window, row-major."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return torch.stack([xx, yy], dim=-1).reshape(h * w, 2).float()


class SinkhornWarpInterpolator(nn.Module):
    def __init__(self, in_channels: int, patch_size: int = 4, win_size: int = 5,
                 win_stride: int = 0, global_mode: str = "phasecorr",
                 angles_deg: Tuple[float, ...] = (-10.0, -5.0, 0.0, 5.0, 10.0),
                 sinkhorn_iters: int = 20, sinkhorn_tau: float = 0.05,
                 dustbin_logit: float = -2.0, spatial_gamma: float = 0.0,
                 spatial_radius: int = 0, fb_sigma: float = 0.0, d_match: int = 0,
                 learn_tau: bool = False, learn_dustbin: bool = False, tau_min: float = 1e-3,
                 straightener: Optional[nn.Module] = None, warp_space: str = "z"):
        super().__init__()
        if global_mode not in ("phasecorr", "none"):
            raise ValueError(f"global_mode {global_mode!r} not in ('phasecorr', 'none')")
        self.in_channels, self.patch_size = in_channels, patch_size
        self.win_size, self.win_stride, self.global_mode = win_size, win_stride, global_mode
        self.angles_deg, self.sinkhorn_iters = tuple(angles_deg), sinkhorn_iters
        self.sinkhorn_tau, self.dustbin_logit = sinkhorn_tau, dustbin_logit
        self.spatial_gamma, self.spatial_radius = spatial_gamma, spatial_radius
        self.fb_sigma, self.d_match, self.tau_min = fb_sigma, d_match, tau_min
        self.learn_tau, self.learn_dustbin = learn_tau, learn_dustbin
        self.straightener, self.warp_space = straightener, warp_space
        if learn_tau:
            self.tau_raw = nn.Parameter(torch.empty(()))
        if learn_dustbin:
            self.dustbin = nn.Parameter(torch.empty(()))

    def init_seeded(self, uniform_) -> None:
        """The learned scalars start at --sinkhorn_tau and --dustbin_logit."""
        if self.learn_tau:
            init = max(self.sinkhorn_tau - self.tau_min, 1e-6)
            self.tau_raw.fill_(math.log(math.expm1(init)))
        if self.learn_dustbin:
            self.dustbin.fill_(self.dustbin_logit)

    @classmethod
    def from_meta(cls, meta: Dict, in_channels: Optional[int] = None
                  ) -> "SinkhornWarpInterpolator":
        """Rebuild from a checkpoint's meta (tau / dustbin defaults apply only
        to checkpoints written before the trainer stamped them)."""
        return cls(in_channels=int(in_channels if in_channels is not None
                                   else meta["in_channels"]),
                   patch_size=int(meta["patch_size"]), win_size=int(meta["win_size"]),
                   global_mode=str(meta["global_mode"]),
                   sinkhorn_iters=int(meta["sinkhorn_iters"]),
                   sinkhorn_tau=float(meta.get("sinkhorn_tau", 0.05)),
                   dustbin_logit=float(meta.get("dustbin_logit", -2.0)),
                   learn_tau=bool(meta["learn_tau"]), learn_dustbin=bool(meta["learn_dustbin"]),
                   fb_sigma=float(meta["fb_sigma"]), d_match=int(meta["d_match"]))

    def _tau(self) -> torch.Tensor:
        if self.learn_tau:
            return F.softplus(self.tau_raw) + self.tau_min
        return torch.tensor(self.sinkhorn_tau)

    def _dustbin(self) -> torch.Tensor:
        return self.dustbin if self.learn_dustbin else torch.tensor(self.dustbin_logit)

    # -- token features ------------------------------------------------------
    def token_features(self, z: torch.Tensor, assume_straightened: bool = False):
        """z [B, C, H, W] -> (L2-normalised tokens [B, Hp, Wp, Dm] f32, hp, wp)."""
        if self.straightener is not None and not assume_straightened:
            z = self.straightener.encode(z)
        tokens, (hp, wp) = patchify_latents(z[:, None], self.patch_size)
        tok = tokens[:, 0].float()
        B, N, D = tok.shape
        if 0 < self.d_match < D:
            if D % self.d_match:
                raise ValueError(f"d_match {self.d_match} must divide token dim {D}")
            tok = tok.reshape(B, N, self.d_match, D // self.d_match).mean(dim=-1)
        tok = tok / torch.clamp(torch.linalg.vector_norm(tok, dim=-1, keepdim=True), min=1e-6)
        return tok.reshape(B, hp, wp, -1), hp, wp

    # -- global alignment ----------------------------------------------------
    def _global_se2(self, f0: torch.Tensor, f1: torch.Tensor):
        """The best (theta, dx, dy) [B] over the angle list: the phase-
        correlation peak of f0 against each rotation of f1."""
        B, dev = f0.shape[0], f0.device
        zeros = torch.zeros((B,), device=dev)
        if self.global_mode == "none":
            return zeros, zeros, zeros
        f0c = f0.permute(0, 3, 1, 2).float()
        best = (torch.full((B,), -math.inf, device=dev), zeros, zeros, zeros)
        for angle_deg in self.angles_deg:
            theta = torch.full((B,), float(angle_deg) * math.pi / 180.0, device=dev)
            f1_rot = _affine_sample(f1, theta, zeros, zeros)
            dx_s, dy_s, peak = _phasecorr_shift(f0c, f1_rot.permute(0, 3, 1, 2).float())
            cos_t, sin_t = torch.cos(theta), torch.sin(theta)
            dx = -(cos_t * dx_s - sin_t * dy_s)
            dy = -(sin_t * dx_s + cos_t * dy_s)
            better = peak > best[0]
            best = tuple(torch.where(better, new, old)
                         for new, old in zip((peak, theta, dx, dy), best))
        return best[1], best[2], best[3]

    # -- windowed sinkhorn ---------------------------------------------------
    def _window_match(self, x: torch.Tensor, y: torch.Tensor, h: int, w: int):
        """x / y [Nb, h*w, D] window tokens -> (delta [Nb, h, w, 2], conf [Nb, h, w])."""
        Nb, n, D = x.shape
        logits = torch.einsum("bnd,bmd->bnm", x, y) / math.sqrt(max(1.0, float(D)))
        logits = logits / torch.clamp(self._tau().to(x.device), min=1e-6)
        coords = _coords(h, w, x.device)
        if self.spatial_gamma > 0.0 or self.spatial_radius > 0:
            diff = coords[:, None] - coords[None]
            dist2 = (diff * diff).sum(-1)
            if self.spatial_gamma > 0.0:
                logits = logits - self.spatial_gamma * dist2[None]
            if self.spatial_radius > 0:
                logits = torch.where(dist2[None] > float(self.spatial_radius ** 2),
                                     torch.full_like(logits, -1e4), logits)
        dust = self._dustbin().to(logits)
        logp = torch.cat([torch.cat([logits, dust.expand(Nb, n, 1)], dim=2),
                          dust.expand(Nb, 1, n + 1)], dim=1)
        p = torch.exp(sinkhorn_log(logp, self.sinkhorn_iters))
        p_xy = p[:, :n, :n]
        mass = torch.clamp(p_xy.sum(dim=2, keepdim=True), min=1e-8)
        q = torch.einsum("bnm,md->bnd", p_xy, coords) / mass
        return (q - coords[None]).reshape(Nb, h, w, 2), (1.0 - p[:, :n, n]).reshape(Nb, h, w)

    def _local_sinkhorn(self, f0: torch.Tensor, f1: torch.Tensor, hp: int, wp: int):
        """Windowed matching over [B, Hp, Wp, D] -> (delta [B, Hp, Wp, 2], conf [B, Hp, Wp])."""
        B, _, _, D = f0.shape
        win = self.win_size
        stride = self.win_stride if self.win_stride > 0 else win
        dev = f0.device
        if stride >= win:
            # non-overlapping: the main grid in one batch, then the tails
            delta = torch.zeros((B, hp, wp, 2), device=dev)
            conf = torch.zeros((B, hp, wp), device=dev)

            def run_block(y0, x0, h, w):
                x = f0[:, y0:y0 + h, x0:x0 + w].reshape(B, h * w, D)
                y = f1[:, y0:y0 + h, x0:x0 + w].reshape(B, h * w, D)
                d, c = self._window_match(x, y, h, w)
                delta[:, y0:y0 + h, x0:x0 + w] = d
                conf[:, y0:y0 + h, x0:x0 + w] = c

            nH, nW = hp // win, wp // win
            if nH > 0 and nW > 0:
                hm, wm = nH * win, nW * win
                blocks = lambda f: (f[:, :hm, :wm].reshape(B, nH, win, nW, win, D)
                                    .permute(0, 1, 3, 2, 4, 5).reshape(B * nH * nW, win * win, D))
                d, c = self._window_match(blocks(f0), blocks(f1), win, win)
                delta[:, :hm, :wm] = (d.reshape(B, nH, nW, win, win, 2)
                                      .permute(0, 1, 3, 2, 4, 5).reshape(B, hm, wm, 2))
                conf[:, :hm, :wm] = (c.reshape(B, nH, nW, win, win)
                                     .permute(0, 1, 3, 2, 4).reshape(B, hm, wm))
            th, tw = hp - nH * win, wp - nW * win
            if tw > 0:
                for yi in range(nH):
                    run_block(yi * win, wp - tw, win, tw)
            if th > 0:
                for xi in range(nW):
                    run_block(hp - th, xi * win, th, win)
            if th > 0 and tw > 0:
                run_block(hp - th, wp - tw, th, tw)
            return delta, conf

        # overlapping windows: confidence-weighted accumulation over the origins
        ys = list(range(0, max(hp - win, 0) + 1, stride))
        xs = list(range(0, max(wp - win, 0) + 1, stride))
        if ys[-1] + win < hp:
            ys.append(hp - win)
        if xs[-1] + win < wp:
            xs.append(wp - win)
        acc_d = torch.zeros((B, hp, wp, 2), device=dev)
        acc_c = torch.zeros((B, hp, wp), device=dev)
        cnt = torch.zeros((hp, wp), device=dev)
        for y0 in ys:
            for x0 in xs:
                x = f0[:, y0:y0 + win, x0:x0 + win].reshape(B, win * win, D)
                y = f1[:, y0:y0 + win, x0:x0 + win].reshape(B, win * win, D)
                d, c = self._window_match(x, y, win, win)
                acc_d[:, y0:y0 + win, x0:x0 + win] += d * c[..., None]
                acc_c[:, y0:y0 + win, x0:x0 + win] += c
                cnt[y0:y0 + win, x0:x0 + win] += 1.0
        delta = acc_d / torch.clamp(acc_c[..., None], min=1e-8)
        conf = torch.clamp(acc_c / torch.clamp(cnt[None], min=1.0), 0.0, 1.0)
        return delta, conf

    def _compose_flow(self, delta, theta, dx, dy, hp: int, wp: int) -> torch.Tensor:
        """flow(x) = R (x - c + delta) + c + t - x, in tokens [B, Hp, Wp, 2]."""
        dev = delta.device
        y, x = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=dev),
                              torch.arange(wp, dtype=torch.float32, device=dev), indexing="ij")
        coords = torch.stack([x, y], dim=-1)
        center = torch.tensor([(wp - 1) / 2.0, (hp - 1) / 2.0], device=dev)
        v = (coords - center)[None] + delta
        cos_t, sin_t = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
        q = torch.stack([cos_t * v[..., 0] - sin_t * v[..., 1],
                         sin_t * v[..., 0] + cos_t * v[..., 1]], dim=-1) + center
        q = q + torch.stack([dx, dy], dim=-1)[:, None, None, :]
        return q - coords[None]

    def _flow_and_conf(self, f0, f1, hp: int, wp: int):
        theta, dx, dy = self._global_se2(f0, f1)
        delta, conf = self._local_sinkhorn(f0, _affine_sample(f1, theta, dx, dy), hp, wp)
        return self._compose_flow(delta, theta, dx, dy, hp, wp), conf

    def _fb_conf(self, flow01_tok: torch.Tensor, flow10_tok: torch.Tensor):
        if self.fb_sigma <= 0.0:
            ones = torch.ones(flow01_tok.shape[:3], device=flow01_tok.device)
            return ones, ones
        f01 = flow01_tok.permute(0, 3, 1, 2).float()
        f10 = flow10_tok.permute(0, 3, 1, 2).float()
        # sqrt(x + eps), not the norm: the residual is exactly 0 where both
        # flows vanish, and the norm's gradient there is NaN
        nrm = lambda v: torch.sqrt((v * v).sum(dim=1) + 1e-12)
        err01 = nrm(f01 + warp(f10, f01))
        err10 = nrm(f10 + warp(f01, f10))
        conf = lambda err: torch.clamp(torch.exp(-0.5 * (err / self.fb_sigma) ** 2), 0.0, 1.0)
        return conf(err01), conf(err10)

    def compute_bidirectional_flow_and_confs(self, f0, f1, hp: int, wp: int):
        flow01, conf01_d = self._flow_and_conf(f0, f1, hp, wp)
        flow10, conf10_d = self._flow_and_conf(f1, f0, hp, wp)
        c01_fb, c10_fb = self._fb_conf(flow01, flow10)
        return flow01, flow10, conf01_d * c01_fb, conf10_d * c10_fb

    # -- the segment forward ---------------------------------------------------
    def forward(self, latents: torch.Tensor, idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Interpolate latents [B, T, C, H, W] at sorted anchors idx [B, K] ->
        (out [B, T, C, H, W], conf [B, T, H, W]); anchors exact, conf 1 there."""
        B, T, C, H, W = latents.shape
        K = idx.shape[1]
        flat = latents.reshape(B * T, C, H, W)
        s_flat = self.straightener.encode(flat) if self.straightener is not None else None
        feats, hp, wp = self.token_features(s_flat if s_flat is not None else flat,
                                            assume_straightened=True)
        feats = feats.reshape(B, T, hp, wp, -1)
        base = latents
        if self.warp_space == "s":
            if s_flat is None:
                raise ValueError("warp_space='s' requires a straightener")
            base = s_flat.reshape(B, T, C, H, W)

        P = B * (K - 1)
        f_l = gather_frames(feats, idx[:, :-1]).reshape(P, hp, wp, -1)
        f_r = gather_frames(feats, idx[:, 1:]).reshape(P, hp, wp, -1)
        flow01_tok, flow10_tok, conf01, conf10 = self.compute_bidirectional_flow_and_confs(
            f_l, f_r, hp, wp)
        ps = float(self.patch_size)
        flow01 = resize_bilinear(flow01_tok.permute(0, 3, 1, 2), (H, W)) * ps
        flow10 = resize_bilinear(flow10_tok.permute(0, 3, 1, 2), (H, W)) * ps
        c01 = torch.clamp(resize_bilinear(conf01[:, None], (H, W)), 0.0, 1.0)
        c10 = torch.clamp(resize_bilinear(conf10[:, None], (H, W)), 0.0, 1.0)

        seg, alpha = segment_of_frames(idx, T)
        a = torch.clamp(alpha, 0.0, 1.0).reshape(B * T, 1, 1, 1)
        per_frame = lambda x: gather_frames(x.reshape(B, K - 1, *x.shape[1:]), seg).reshape(
            B * T, *x.shape[1:])
        z_l = per_frame(gather_frames(base, idx[:, :-1]).reshape(P, C, H, W))
        z_r = per_frame(gather_frames(base, idx[:, 1:]).reshape(P, C, H, W))
        cc01, cc10 = per_frame(c01), per_frame(c10)
        f01_t = per_frame(flow01) * cc01 * a
        f10_t = per_frame(flow10) * cc10 * (1.0 - a)
        z0w, z1w = warp(z_l, -f01_t), warp(z_r, -f10_t)
        c0w, c1w = warp(cc01, -f01_t), warp(cc10, -f10_t)
        w0, w1 = (1.0 - a) * c0w, a * c1w
        denom = w0 + w1
        z_mix = (w0 * z0w + w1 * z1w) / torch.clamp(denom, min=1e-6)
        z_lerp = (1.0 - a) * z_l + a * z_r
        out = torch.where(denom > 1e-6, z_mix, z_lerp)
        conf = torch.minimum(c0w, c1w)[:, 0].reshape(B, T, H, W)
        if self.warp_space == "s":
            out = self.straightener.decode(out)
        out = set_anchors(out.reshape(B, T, C, H, W), idx, gather_frames(latents, idx))
        conf = set_anchors(conf, idx, torch.ones((B, K, H, W), dtype=conf.dtype,
                                                 device=conf.device))
        return out, conf
