"""Learned latent flow interpolator: optical-flow warp + residual refine
(port of models/flow_interpolator.py).

A small UNet (`LatentFlowPredictor`) predicts bidirectional flows, a blend
mask (optionally time-dependent), and an uncertainty map from the two
anchor latents, optionally with the gap and a local cost volume; both
anchors are warped to the frame's alpha, blended, and refined by a residual
conv stack. `LatentFlowInterpolator(latents, idx)` predicts flows for all
B*(K-1) anchor segments at once, then every frame gathers its segment and
blends at its own alpha; anchors are kept exactly.

Convolutions are NCHW with flax's "SAME" padding (`SameConv2d`): a 3x3
stride-2 conv pads (lo, hi) = (0, 1) on an even side and (1, 1) on an odd
one, so that padding=1 would shift every output of `enc2` by one pixel.
Module names are the flax names (net.enc1.conv1, residual.res_0.conv2, ...);
f32 master parameters compute in bf16 under `set_compute_dtype`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import cost_volume, resize_bilinear, warp
from .transformer import Conv2d


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding (lo, hi) of one side: output ceil(size/stride)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """Conv2d with flax's "SAME" padding, computed from the input's size."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, stride: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (t, b), (l, r) = same_pads(x.shape[-2], k, s), same_pads(x.shape[-1], k, s)
        return super().forward(F.pad(x, (l, r, t, b)))


class _ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(in_ch, out_ch, 3, stride)
        self.conv2 = SameConv2d(out_ch, out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv2(F.silu(self.conv1(x))))


class _ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SameConv2d(channels, channels)
        self.conv2 = SameConv2d(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv2(F.silu(self.conv1(x))) + x)


class LatentResidualRefiner(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 n_blocks: int = 2):
        super().__init__()
        self.in_proj = SameConv2d(in_channels, hidden_channels)
        self.n_blocks = max(0, n_blocks)
        for i in range(self.n_blocks):
            setattr(self, f"res_{i}", _ResBlock(hidden_channels))
        self.out_proj = SameConv2d(hidden_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_proj(x)
        for i in range(self.n_blocks):
            h = getattr(self, f"res_{i}")(h)
        return self.out_proj(h)


class LatentFlowPredictor(nn.Module):
    """(z0, z1[, cond]) -> (flow01, flow10, mask_a, mask_b, uncertainty), f32."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, base_channels: int = 32, max_flow: float = 20.0,
                 cond_channels: int = 0, time_mask: bool = False,
                 use_cost_volume: bool = False, cv_radius: int = 2, cv_downscale: int = 2,
                 cv_norm: bool = True):
        super().__init__()
        self.max_flow, self.cond_channels, self.time_mask = max_flow, cond_channels, time_mask
        self.use_cost_volume, self.cv_radius = use_cost_volume, cv_radius
        self.cv_downscale, self.cv_norm = cv_downscale, cv_norm
        c_in = 2 * in_channels + cond_channels + (
            (2 * cv_radius + 1) ** 2 if use_cost_volume else 0)
        b = base_channels
        self.enc1 = _ConvBlock(c_in, b)
        self.enc2 = _ConvBlock(b, 2 * b, stride=2)
        self.enc3 = _ConvBlock(2 * b, 2 * b)
        self.dec1 = _ConvBlock(3 * b, b)
        self.out = SameConv2d(b, 7 if time_mask else 6)

    def forward(self, z0: torch.Tensor, z1: torch.Tensor, cond: Optional[torch.Tensor] = None):
        feats = [z0, z1]
        if self.cond_channels > 0:
            if cond is None:
                raise ValueError("cond is required when cond_channels > 0")
            if cond.ndim == 2:
                cond = cond[:, :, None, None]
            feats.append(cond.to(z0.dtype).expand(*cond.shape[:2], *z0.shape[-2:]))
        if self.use_cost_volume:
            feats.append(cost_volume(z0, z1, self.cv_radius, self.cv_downscale, self.cv_norm))
        dtype = self.compute_dtype or self.out.weight.dtype
        x = torch.cat(feats, dim=1).to(dtype)
        h1 = self.enc1(x)
        h3 = self.enc3(self.enc2(h1))
        h = self.dec1(torch.cat([resize_bilinear(h3, h1.shape[-2:]), h1], dim=1))
        out = self.out(h).float()
        flow01 = torch.tanh(out[:, 0:2]) * self.max_flow
        flow10 = torch.tanh(out[:, 2:4]) * self.max_flow
        if self.time_mask:
            return flow01, flow10, out[:, 4:5], out[:, 5:6], torch.sigmoid(out[:, 6:7])
        mask_a = torch.sigmoid(out[:, 4:5])
        return flow01, flow10, mask_a, torch.zeros_like(mask_a), torch.sigmoid(out[:, 5:6])


def segment_of_frames(idx: torch.Tensor, T: int):
    """For sorted anchors idx [B, K]: each frame's segment [B, T] (clipped to
    0..K-2) and its alpha [B, T] f32 between the segment's two anchors."""
    K = idx.shape[1]
    t_grid = torch.arange(T, dtype=idx.dtype, device=idx.device)
    seg = torch.searchsorted(idx.contiguous(), t_grid.expand(idx.shape[0], T).contiguous(),
                             right=True) - 1
    seg = torch.clamp(seg, 0, K - 2)
    left, right = torch.gather(idx, 1, seg), torch.gather(idx, 1, seg + 1)
    alpha = (t_grid[None] - left).float() / torch.clamp(right - left, min=1).float()
    return seg, alpha


def gather_frames(x: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] at indices at [B, M] along dim 1 -> [B, M, ...]."""
    return torch.gather(x, 1, at.long().reshape(*at.shape, *([1] * (x.ndim - 2))).expand(
        *at.shape, *x.shape[2:]))


def set_anchors(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out [B, T, ...] with frames idx [B, K] replaced by vals [B, K, ...]."""
    index = idx.long().reshape(*idx.shape, *([1] * (out.ndim - 2))).expand(*idx.shape,
                                                                          *out.shape[2:])
    return out.scatter(1, index, vals.to(out.dtype))


class LatentFlowInterpolator(nn.Module):
    """Flow-warped blending + optional residual refinement between anchors."""

    def __init__(self, in_channels: int, base_channels: int = 32, max_flow: float = 20.0,
                 residual_channels: Optional[int] = None, residual_blocks: int = 2,
                 time_mask: bool = False, gap_cond: bool = False,
                 use_cost_volume: bool = False, cv_radius: int = 2, cv_downscale: int = 2,
                 cv_norm: bool = True):
        super().__init__()
        self.time_mask, self.gap_cond = time_mask, gap_cond
        self.net = LatentFlowPredictor(in_channels, base_channels, max_flow,
                                       1 if gap_cond else 0, time_mask, use_cost_volume,
                                       cv_radius, cv_downscale, cv_norm)
        self.residual = None
        if residual_blocks > 0:
            res_in = 3 * in_channels + 1 + (1 if gap_cond else 0)
            self.residual = LatentResidualRefiner(res_in, residual_channels or base_channels,
                                                  in_channels, residual_blocks)

    def _gap(self, gap: Optional[torch.Tensor]) -> torch.Tensor:
        if gap is None:
            raise ValueError("gap must be provided when gap_cond is enabled")
        return gap[:, None] if gap.ndim == 1 else gap

    def predict_flow(self, z0: torch.Tensor, z1: torch.Tensor,
                     gap: Optional[torch.Tensor] = None):
        if self.gap_cond:
            return self.net(z0, z1, self._gap(gap))
        return self.net(z0, z1)

    def blend_from_flow(self, z0, z1, alpha, flow01, flow10, mask_a, mask_b=None, gap=None):
        if alpha.ndim == 1:
            alpha = alpha[:, None, None, None]
        alpha = torch.clamp(alpha.to(z0.dtype), 0.0, 1.0)
        if self.time_mask:
            if mask_b is None:
                raise ValueError("mask_b must be provided when time_mask is enabled")
            mask = torch.sigmoid(mask_a + mask_b * (2.0 * alpha - 1.0))
        else:
            mask = mask_a
        z_t = mask * warp(z0, -alpha * flow01) + (1.0 - mask) * warp(z1, -(1.0 - alpha) * flow10)
        if self.residual is not None:
            shape = (z_t.shape[0], 1, *z_t.shape[-2:])
            feats = [z_t, z0, z1, alpha.expand(shape)]
            if self.gap_cond:
                feats.append(self._gap(gap)[:, :, None, None].to(z_t.dtype).expand(shape))
            z_t = z_t + self.residual(torch.cat(feats, dim=1)).to(z_t.dtype)
        return z_t

    def interpolate_pair(self, z0, z1, alpha, gap=None):
        flow01, flow10, mask_a, mask_b, unc = self.predict_flow(z0, z1, gap=gap)
        return self.blend_from_flow(z0, z1, alpha, flow01, flow10, mask_a, mask_b, gap=gap), unc

    def forward(self, latents: torch.Tensor, idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Segment-wise interpolation of latents [B, T, C, H, W] at sorted
        anchors idx [B, K] -> (out [B, T, C, H, W], conf [B, T, H, W]); conf
        is 1 at anchors and 1 - uncertainty inside."""
        B, T, C, H, W = latents.shape
        K = idx.shape[1]
        z_l, z_r = gather_frames(latents, idx[:, :-1]), gather_frames(latents, idx[:, 1:])
        gap = (idx[:, 1:] - idx[:, :-1]).float()                        # [B, K-1]
        flow01, flow10, mask_a, mask_b, unc = self.predict_flow(
            z_l.reshape(-1, C, H, W), z_r.reshape(-1, C, H, W),
            gap=gap.reshape(-1) if self.gap_cond else None)
        seg, alpha = segment_of_frames(idx, T)
        per_frame = lambda x: gather_frames(x.reshape(B, K - 1, *x.shape[1:]), seg).reshape(
            B * T, *x.shape[1:])
        out = self.blend_from_flow(
            per_frame(z_l.reshape(-1, C, H, W)), per_frame(z_r.reshape(-1, C, H, W)),
            alpha.reshape(-1), per_frame(flow01), per_frame(flow10), per_frame(mask_a),
            per_frame(mask_b), gap=gather_frames(gap, seg).reshape(-1) if self.gap_cond else None)
        out = set_anchors(out.reshape(B, T, C, H, W), idx, gather_frames(latents, idx))
        conf = 1.0 - per_frame(unc).reshape(B, T, H, W)
        conf = set_anchors(conf, idx, torch.ones((B, K, H, W), dtype=conf.dtype,
                                                 device=conf.device))
        return out, conf


def flow_interpolator_from_meta(meta) -> LatentFlowInterpolator:
    """The interpolator a flow_interpolator checkpoint's meta describes."""
    return LatentFlowInterpolator(
        in_channels=int(meta["in_channels"]), base_channels=int(meta["base_channels"]),
        max_flow=float(meta["max_flow"]), residual_blocks=int(meta["residual_blocks"]),
        time_mask=bool(meta["time_mask"]), gap_cond=bool(meta["gap_cond"]),
        use_cost_volume=bool(meta["cost_volume"]), cv_radius=int(meta["cv_radius"]))
