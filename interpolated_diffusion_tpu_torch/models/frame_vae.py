"""Frame VAE: RGB frames <-> latents with the SD 0.18215 scaling (port of
models/frame_vae.py).

  * `FrameVAE`: a from-scratch conv VAE with the SD latent layout (8x
    spatial downsample, 4 channels, 0.18215 scaling). Its convolutions are
    NCHW with flax's "SAME" padding (models/flow_interpolator.SameConv2d: the
    stride-2 convs pad (0, 1) on an even side); module names are the flax
    names (enc_blocks_0.Conv_0, enc_out, dec_in, dec_blocks_2.Conv_1,
    dec_out), so that models/jax_import.module_tree_to_state_dict reads a
    JAX tree.
  * `TorchFrameVAE`: a frozen pretrained diffusers AutoencoderKL, used when a
    clip cache is built (data/precompute_clip_cache.py). It needs the
    `diffusers` package and its weights, and raises ImportError without them.
    models/sd_vae.SDVAE is the same network in this package, for a diffusers
    safetensors file without `diffusers` itself.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .flow_interpolator import SameConv2d
from .sd_vae import SD_SCALE


class TorchFrameVAE:
    """Frozen diffusers AutoencoderKL wrapper (cache building only)."""

    def __init__(self, model_name: str = "stabilityai/sd-vae-ft-ema", device: str = "cpu"):
        try:
            from diffusers import AutoencoderKL  # type: ignore
        except ImportError as e:
            raise ImportError("TorchFrameVAE needs diffusers (cache building only)") from e
        self.vae = AutoencoderKL.from_pretrained(model_name).to(device).eval()
        self.device = device

    def encode(self, frames: np.ndarray) -> np.ndarray:
        """[B, T, 3, H, W] in [0, 1] -> latents [B, T, 4, H/8, W/8] (scaled)."""
        B, T = frames.shape[:2]
        x = torch.from_numpy(frames.reshape(B * T, *frames.shape[2:])).to(self.device)
        with torch.no_grad():
            z = self.vae.encode(x * 2.0 - 1.0).latent_dist.sample() * SD_SCALE
        return z.cpu().numpy().reshape(B, T, *z.shape[1:])

    def decode(self, latents: np.ndarray) -> np.ndarray:
        B, T = latents.shape[:2]
        z = torch.from_numpy(latents.reshape(B * T, *latents.shape[2:])).to(self.device)
        with torch.no_grad():
            x = self.vae.decode(z / SD_SCALE).sample
        x = ((x + 1.0) / 2.0).clamp(0, 1)
        return x.cpu().numpy().reshape(B, T, *x.shape[1:])


class _Down(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, ch, 3, stride=2)
        self.Conv_1 = SameConv2d(ch, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.Conv_1(F.silu(self.Conv_0(x))))


class _Up(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, ch, 3)
        self.Conv_1 = SameConv2d(ch, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return F.silu(self.Conv_1(F.silu(self.Conv_0(x))))


class FrameVAE(nn.Module):
    """From-scratch conv VAE with the SD latent contract (8x down, 4 channels)."""

    def __init__(self, latent_channels: int = 4, base_ch: int = 32):
        super().__init__()
        chans = [base_ch * m for m in (1, 2, 4)]
        for i, ch in enumerate(chans):
            setattr(self, f"enc_blocks_{i}", _Down(3 if i == 0 else chans[i - 1], ch))
        self.enc_out = SameConv2d(chans[-1], 2 * latent_channels, 3)
        self.dec_in = SameConv2d(latent_channels, base_ch * 4, 3)
        dec = [base_ch * m for m in (4, 2, 1)]
        for i, ch in enumerate(dec):
            setattr(self, f"dec_blocks_{i}", _Up(base_ch * 4 if i == 0 else dec[i - 1], ch))
        self.dec_out = SameConv2d(base_ch, 3, 3)

    @property
    def dtype(self) -> torch.dtype:
        return self.enc_out.compute_dtype or self.enc_out.weight.dtype

    def encode(self, frames: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, 3, H, W] in [0, 1] -> latents [B, T, 4, H/8, W/8] (scaled):
        the mean, or a sample with `noise` (normals of the output's shape) or
        normals drawn from `generator`."""
        B, T = frames.shape[:2]
        x = frames.reshape(B * T, *frames.shape[2:]).to(self.dtype) * 2.0 - 1.0
        for i in range(3):
            x = getattr(self, f"enc_blocks_{i}")(x)
        mean, logvar = torch.chunk(self.enc_out(x), 2, dim=1)
        z = mean
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device)
        if noise is not None:
            noise = noise.reshape(mean.shape).to(device=mean.device, dtype=mean.dtype)
            z = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * noise
        z = z * SD_SCALE
        return z.reshape(B, T, *z.shape[1:]).float()

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        B, T = latents.shape[:2]
        x = (latents.reshape(B * T, *latents.shape[2:]) / SD_SCALE).to(self.dtype)
        x = self.dec_in(x)
        for i in range(3):
            x = getattr(self, f"dec_blocks_{i}")(x)
        x = torch.tanh(self.dec_out(x)) * 0.5 + 0.5
        return x.reshape(B, T, *x.shape[1:]).float()

    def forward(self, frames: torch.Tensor, noise: Optional[torch.Tensor] = None):
        z = self.encode(frames, noise)
        return self.decode(z), z
