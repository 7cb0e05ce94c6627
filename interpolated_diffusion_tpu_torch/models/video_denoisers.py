"""Video token denoisers (port of models/video_denoisers.py): Stage 1 over
[B, K, N, D] anchor-frame token grids and Stage 2 over [B, T, N, D] grids.

1D time x 2D space sinusoidal embeddings; the tokens flatten to K*N (T*N)
for full attention through the FiLM transformer, which dispatches as the JAX
package's does (models/transformer.py): the block and packed kernels only
where the sequence fits their windows (L <= 256), plain attention otherwise.
Conditioning is text (TextConditionEncoder, when built with `text_dim`) or
none. Parameter names follow the original PyTorch reference (in_proj,
t_embed.{0,2}, level_emb, level_proj.{0,2}, cond_enc.proj.{0,2}, cond_proj,
transformer.layers.*, out); the Stage-2 head is zero-initialised. Outputs
are float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .denoisers import continuous_time_embedding, timestep_embedding
from .encoders import TextConditionEncoder
from .transformer import Embedding, Linear, TransformerEncoder

Cond = Optional[Dict[str, torch.Tensor]]


def sincos_1d(n: int, dim: int, device=None) -> torch.Tensor:
    return continuous_time_embedding(torch.linspace(0.0, 1.0, n, device=device), dim)


def sincos_2d(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """[h*w, dim]: row embedding in the first half, column in the second
    (a zero column last for odd dim)."""
    orig, dim = dim, dim - (dim % 2)
    half = dim // 2
    eh, ew = sincos_1d(h, half, device), sincos_1d(w, half, device)
    emb = torch.cat([eh[:, None, :].expand(h, w, half), ew[None, :, :].expand(h, w, half)],
                    dim=-1).reshape(h * w, dim)
    return torch.nn.functional.pad(emb, (0, orig - dim))


class _VideoDenoiser(nn.Module):
    compute_dtype: Optional[torch.dtype] = None

    def _init_common(self, d_model: int, n_layers: int, n_heads: int, d_ff: int, d_cond: int,
                     text_dim: Optional[int], attn_policy: str) -> None:
        self.d_model, self.d_cond = d_model, d_cond
        self.cond_enc = TextConditionEncoder(text_dim, d_cond) if text_dim else None
        self.cond_proj = Linear(d_cond, d_model)
        self.transformer = TransformerEncoder(d_model, n_layers, n_heads, d_ff, d_cond, True,
                                              attn_policy)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.in_proj.weight.dtype

    def _cond_vec(self, cond: Cond, B: int, device) -> torch.Tensor:
        if cond is not None and "text_embed" in cond:
            if self.cond_enc is None:
                raise ValueError("text_embed given to a video denoiser built without text_dim")
            return self.cond_enc(cond)
        return torch.zeros((B, self.d_cond), dtype=self.dtype, device=device)

    def set_attn_policy(self, policy: str) -> None:
        self.transformer.set_attn_policy(policy)


class VideoTokenKeypointDenoiser(_VideoDenoiser):
    """Eps prediction over the K anchor frames' tokens; each token sees its
    frame's absolute time (idx / (T - 1)) and its spatial position."""

    def __init__(self, d_model: int = 512, n_layers: int = 8, n_heads: int = 8,
                 d_ff: int = 2048, d_cond: int = 128, data_dim: int = 256,
                 text_dim: Optional[int] = None, attn_policy: str = "fused"):
        super().__init__()
        self.in_proj = Linear(data_dim, d_model)
        self.t_embed = nn.Sequential(Linear(d_model, d_model), nn.SiLU(),
                                     Linear(d_model, d_model))
        self._init_common(d_model, n_layers, n_heads, d_ff, d_cond, text_dim, attn_policy)
        self.out = Linear(d_model, data_dim)

    def forward(self, z_t: torch.Tensor, t: torch.Tensor, idx: torch.Tensor, cond: Cond,
                T: int, spatial_shape: Tuple[int, int]) -> torch.Tensor:
        B, K, N, D = z_t.shape
        dtype, dev = self.dtype, z_t.device
        h = self.in_proj(z_t.to(dtype))
        time_emb = sincos_1d(T, self.d_model, dev)[idx.long()].to(dtype)
        space_emb = sincos_2d(*spatial_shape, self.d_model, dev).to(dtype)
        h = h + time_emb[:, :, None, :] + space_emb[None, None]
        h = h + self.t_embed(timestep_embedding(t, self.d_model).to(dtype))[:, None, None, :]
        cond_vec = self._cond_vec(cond, B, dev)
        h = h + self.cond_proj(cond_vec)[:, None, None, :]
        h = self.transformer(h.reshape(B, K * N, self.d_model), cond_vec)
        return self.out(h).reshape(B, K, N, D).float()


class VideoTokenInterpLevelDenoiser(_VideoDenoiser):
    """Stage-2 refinement over T frames' tokens: input [x_s, mask channels],
    the level s through an embedding -> MLP, a zero-initialised head."""

    def __init__(self, d_model: int = 512, n_layers: int = 8, n_heads: int = 8,
                 d_ff: int = 2048, d_cond: int = 128, data_dim: int = 256,
                 max_levels: int = 8, mask_channels: int = 1, text_dim: Optional[int] = None,
                 attn_policy: str = "fused"):
        super().__init__()
        self.mask_channels = mask_channels
        self.in_proj = Linear(data_dim + mask_channels, d_model)
        self.level_emb = Embedding(max_levels + 1, d_model)
        self.level_proj = nn.Sequential(Linear(d_model, d_model), nn.SiLU(),
                                        Linear(d_model, d_model))
        self._init_common(d_model, n_layers, n_heads, d_ff, d_cond, text_dim, attn_policy)
        self.out = Linear(d_model, data_dim)
        self.out.zero_init = True
        nn.init.zeros_(self.out.weight)
        nn.init.zeros_(self.out.bias)

    def forward(self, x_s: torch.Tensor, s: torch.Tensor, mask: torch.Tensor, cond: Cond,
                spatial_shape: Tuple[int, int]) -> torch.Tensor:
        B, T, N, D = x_s.shape
        dtype, dev = self.dtype, x_s.device
        mask_in = (mask[..., None] if mask.ndim == 3 else mask).to(x_s.dtype)
        if mask_in.shape[-1] != self.mask_channels:
            raise ValueError(f"mask has {mask_in.shape[-1]} channels, "
                             f"expected {self.mask_channels}")
        h = self.in_proj(torch.cat([x_s, mask_in], dim=-1).to(dtype))
        time_emb = sincos_1d(T, self.d_model, dev).to(dtype)
        space_emb = sincos_2d(*spatial_shape, self.d_model, dev).to(dtype)
        pos = (time_emb[:, None, :] + space_emb[None]).reshape(T * N, self.d_model)
        h = h.reshape(B, T * N, self.d_model) + pos[None]
        h = h + self.level_proj(self.level_emb(s.long()))[:, None, :]
        cond_vec = self._cond_vec(cond, B, dev)
        h = h + self.cond_proj(cond_vec)[:, None, :]
        h = self.transformer(h, cond_vec)
        return self.out(h).reshape(B, T, N, D).float()
