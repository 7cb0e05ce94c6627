"""Latent straighteners: a learned space in which lerp follows the clip
(port of models/straightener.py).

`LatentStraightener` is a conv encoder / decoder pair (each a conv stack
with a global residual and a zero-initialised `out_conv`, so that it starts
as the identity); `LatentStraightenerTokenTransformer` patchifies, runs a
plain pre-norm transformer (no FiLM) with 2D sincos positions, and adds a
zero-initialised `out_proj` delta. `interpolate_pair` encodes both anchors,
lerps in the straightened space and decodes. `load_latent_straightener`
rebuilds either from a checkpoint's meta (stage "straightener").
Module names are the flax names; f32 master parameters compute in bf16
under `set_compute_dtype`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.video_tokens import patchify_latents, unpatchify_tokens
from .flow_interpolator import SameConv2d
from .transformer import Linear, TransformerEncoder
from .video_denoisers import sincos_2d


class _StraightenerNet(nn.Module):
    """Conv stack with an optional global residual (identity at init)."""

    def __init__(self, in_channels: int, hidden_channels: int = 64, blocks: int = 2,
                 use_residual: bool = True, kernel_size: int = 3):
        super().__init__()
        self.blocks, self.use_residual = max(0, blocks), use_residual
        k = kernel_size
        self.in_conv = SameConv2d(in_channels, hidden_channels, k)
        for i in range(self.blocks):
            setattr(self, f"block_{i}_conv1", SameConv2d(hidden_channels, hidden_channels, k))
            setattr(self, f"block_{i}_conv2", SameConv2d(hidden_channels, hidden_channels, k))
        self.out_conv = SameConv2d(hidden_channels, in_channels, k)
        self.out_conv.zero_init = True

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.in_conv(z))
        for i in range(self.blocks):
            r = getattr(self, f"block_{i}_conv2")(F.silu(getattr(self, f"block_{i}_conv1")(h)))
            h = F.silu(h + r)
        out = self.out_conv(h).to(z.dtype)
        return z + out if self.use_residual else out


class _TokenTransformerNet(nn.Module):
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, token_dim: int, patch_size: int, d_model: int = 256, n_layers: int = 4,
                 n_heads: int = 8, d_ff: int = 1024, use_residual: bool = True):
        super().__init__()
        self.patch_size, self.d_model, self.use_residual = patch_size, d_model, use_residual
        self.in_proj = Linear(token_dim, d_model, bias=False) if d_model != token_dim else None
        self.tr = TransformerEncoder(d_model, n_layers, n_heads, d_ff, use_film=False)
        self.out_proj = Linear(d_model, token_dim, bias=False)
        self.out_proj.zero_init = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, C, H, W]
        dtype = self.compute_dtype or self.out_proj.weight.dtype
        tokens, (hp, wp) = patchify_latents(x[:, None], self.patch_size)
        h = tokens[:, 0].to(dtype)
        if self.in_proj is not None:
            h = self.in_proj(h)
        h = h + sincos_2d(hp, wp, self.d_model, x.device).to(dtype)[None]
        h = self.out_proj(self.tr(h))
        delta = unpatchify_tokens(h[:, None].to(x.dtype), self.patch_size, (hp, wp))[:, 0]
        return x + delta if self.use_residual else delta


class _EncoderDecoder(nn.Module):
    def encode(self, z: torch.Tensor) -> torch.Tensor:
        return self.encoder(z)

    def decode(self, s: torch.Tensor) -> torch.Tensor:
        return self.decoder(s)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(z))

    def interpolate_pair(self, z0: torch.Tensor, z1: torch.Tensor, alpha: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(decode(lerp(encode(z0), encode(z1), alpha)), the lerped code)."""
        if alpha.ndim == 1:
            alpha = alpha[:, None, None, None]
        alpha = torch.clamp(alpha.to(z0.dtype), 0.0, 1.0)
        s = (1.0 - alpha) * self.encode(z0) + alpha * self.encode(z1)
        return self.decode(s), s


class LatentStraightener(_EncoderDecoder):
    """Conv encoder / decoder pair; lerp happens in the straightened space."""

    def __init__(self, in_channels: int, hidden_channels: int = 64, blocks: int = 2,
                 use_residual: bool = True, kernel_size: int = 3):
        super().__init__()
        kw = dict(in_channels=in_channels, hidden_channels=hidden_channels, blocks=blocks,
                  use_residual=use_residual, kernel_size=kernel_size)
        self.encoder = _StraightenerNet(**kw)
        self.decoder = _StraightenerNet(**kw)


class LatentStraightenerTokenTransformer(_EncoderDecoder):
    """Token-grid transformer straightener (patchify -> transformer -> unpatchify)."""

    def __init__(self, in_channels: int, patch_size: int = 4, d_model: int = 256,
                 n_layers: int = 4, n_heads: int = 8, d_ff: int = 1024,
                 use_residual: bool = True):
        super().__init__()
        kw = dict(token_dim=in_channels * patch_size ** 2, patch_size=patch_size,
                  d_model=d_model, n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
                  use_residual=use_residual)
        self.encoder = _TokenTransformerNet(**kw)
        self.decoder = _TokenTransformerNet(**kw)


def straightener_from_meta(meta: Dict) -> nn.Module:
    """The straightener a checkpoint's meta describes (arch conv or token)."""
    c = int(meta["in_channels"])
    if meta.get("arch", "conv") == "conv":
        return LatentStraightener(in_channels=c, hidden_channels=int(meta["hidden_channels"]),
                                  blocks=int(meta["blocks"]))
    return LatentStraightenerTokenTransformer(
        in_channels=c, patch_size=int(meta["token_patch"]), d_model=int(meta["token_d_model"]),
        n_layers=int(meta["token_layers"]))


def load_latent_straightener(path: str, device="cuda", bf16: bool = False):
    """(model, meta) of a straightener checkpoint (or the newest under a run
    dir), either package's: f32 parameters on `device`, bf16 compute under
    `bf16`, eval mode without gradients."""
    from .loading import load_stage_model

    return load_stage_model(path, "straightener", straightener_from_meta, device, bf16)
