"""Stage-1 keypoint denoiser and Stage-2 interp-level denoiser
(port of models/denoisers.py; the Stage-2 denoiser also causal).

Parameter names follow the original PyTorch reference's state_dict
(in_proj, t_embed.{0,2}, level_emb, level_proj.{0,2}, cond_enc.*, cond_proj,
transformer.layers.*, out). The compute dtype is the parameters' dtype
(`model.to(torch.bfloat16)` holds a model in bf16 throughout) unless
models/transformer.set_compute_dtype names another: the trainers keep f32
master parameters and compute in bf16, as the JAX package does with
`dtype=bfloat16`. Outputs are float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .encoders import MazeConditionEncoder
from .transformer import Embedding, Linear, TransformerEncoder

Cond = Optional[Dict[str, torch.Tensor]]


def _sinusoid(args: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=args.device) / half)
    a = args.float()[..., None] * freqs
    emb = torch.cat([torch.sin(a), torch.cos(a)], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding for integer diffusion timesteps [B] -> [B, dim]."""
    return _sinusoid(t, dim)


def continuous_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding for continuous positions in [0,1]; [..] -> [.., dim]."""
    return _sinusoid(t, dim)


class _Denoiser(nn.Module):
    """Shared conditioning: the maze encoder (or a hoisted `cond_vec`)."""

    compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.in_proj.weight.dtype

    def _cond_vec(self, cond: Cond, B: int, device) -> torch.Tensor:
        dtype = self.dtype
        if cond is not None and "cond_vec" in cond:
            return cond["cond_vec"].to(dtype)
        if cond is not None and "occ" in cond:
            if self.cond_enc is None:
                raise ValueError("occ given to a denoiser built without the maze encoder")
            return self.cond_enc(cond)
        return torch.zeros((B, self.d_cond), dtype=dtype, device=device)

    def set_attn_policy(self, policy: str) -> None:
        """Route every transformer block: "fused" | "block" | "dense"."""
        self.transformer.set_attn_policy(policy)

    def set_attn_impl(self, impl: str, group=None) -> None:
        """Every block's attention: "dense", or "ring" / "ring_sla" over the
        sequence sharded on `group` (the forward then takes this rank's chunk
        and its global positions, pos_frac)."""
        self.transformer.set_attn_impl(impl, group)


class KeypointDenoiser(_Denoiser):
    """Eps-prediction transformer over K keypoint tokens.

    Inputs per token: [z_t, sinusoid(idx/(T-1)), known_mask, kp_feat]; the
    timestep enters via sinusoid -> MLP added to every token; the cond vector
    is added and FiLM-modulates every block. `maze_cond=False` builds no maze
    encoder (the toy-video stages: the JAX module then has no cond_enc
    parameters and the cond vector is zero).
    """

    def __init__(self, d_model: int = 256, n_layers: int = 8, n_heads: int = 8,
                 d_ff: int = 1024, d_cond: int = 128, use_sdf: bool = False,
                 use_start_goal: bool = True, data_dim: int = 2,
                 pos_dim: Optional[int] = None, kp_feat_dim: int = 0,
                 maze_channels: Sequence[int] = (32, 64), attn_policy: str = "fused",
                 maze_cond: bool = True):
        super().__init__()
        self.d_model, self.d_cond, self.kp_feat_dim = d_model, d_cond, kp_feat_dim
        self.pos_dim = pos_dim if pos_dim is not None else d_model // 2
        in_dim = data_dim + self.pos_dim + data_dim + kp_feat_dim
        self.in_proj = Linear(in_dim, d_model)
        self.t_embed = nn.Sequential(Linear(d_model, d_model), nn.SiLU(),
                                     Linear(d_model, d_model))
        self.cond_enc = (MazeConditionEncoder(use_sdf, d_cond, use_start_goal, maze_channels)
                         if maze_cond else None)
        self.cond_proj = Linear(d_cond, d_model)
        self.transformer = TransformerEncoder(d_model, n_layers, n_heads, d_ff, d_cond,
                                              True, attn_policy)
        self.out = Linear(d_model, data_dim)

    def forward(self, z_t: torch.Tensor, t: torch.Tensor, idx: torch.Tensor,
                known_mask: torch.Tensor, cond: Cond, T: int,
                blocks_delta: Optional[torch.Tensor] = None, return_delta: bool = False):
        """eps [B, K, D] f32. FORA-style caching of the block stack for DDIM
        sampling: `return_delta` also returns the stack's total residual
        h_out - h_in [B, K, d_model]; `blocks_delta` skips all n_layers blocks
        and adds that residual instead, while the input projection, the
        embeddings and the head run fresh."""
        B, K, _ = z_t.shape
        dtype = self.dtype
        pos = idx.float() / max(1.0, float(T - 1))
        pos_emb = continuous_time_embedding(pos, self.pos_dim)
        if self.kp_feat_dim > 0 and cond is not None and "kp_feat" in cond:
            kp_feat = cond["kp_feat"].to(z_t.dtype)
        else:
            kp_feat = z_t.new_zeros((B, K, self.kp_feat_dim))
        x = torch.cat([z_t, pos_emb, known_mask.to(z_t.dtype), kp_feat], dim=-1).to(dtype)
        h = self.in_proj(x)
        h = h + self.t_embed(timestep_embedding(t, self.d_model).to(dtype))[:, None, :]
        cond_vec = self._cond_vec(cond, B, z_t.device)
        h_in = h + self.cond_proj(cond_vec)[:, None, :]
        if blocks_delta is not None:
            h = h_in + blocks_delta.to(h_in.dtype)
        else:
            h = self.transformer(h_in, cond_vec)
        out = self.out(h).float()
        return (out, h - h_in) if return_delta else out


class InterpLevelDenoiser(_Denoiser):
    """Stage-2 delta/x0-prediction transformer over the full T sequence.

    Inputs per token: [x_s, mask channels]; the discrete level s enters via a
    learned embedding -> MLP; sinusoidal positions over T. The output head is
    zero-initialised (as in the JAX package), so an untrained model is the
    identity refiner. `causal=True` is the autoregressive variant: frame t
    attends to frames 0..t only (the causal sampler, sample/generate_causal.py).
    """

    def __init__(self, d_model: int = 256, n_layers: int = 8, n_heads: int = 8,
                 d_ff: int = 1024, d_cond: int = 128, use_sdf: bool = False,
                 use_start_goal: bool = True, data_dim: int = 2, max_levels: int = 8,
                 mask_channels: int = 1, maze_channels: Sequence[int] = (32, 64),
                 attn_policy: str = "fused", causal: bool = False, maze_cond: bool = True):
        super().__init__()
        self.d_model, self.d_cond, self.mask_channels = d_model, d_cond, mask_channels
        self.causal = causal
        self.in_proj = Linear(data_dim + mask_channels, d_model)
        self.level_emb = Embedding(max_levels + 1, d_model)
        self.level_proj = nn.Sequential(Linear(d_model, d_model), nn.SiLU(),
                                        Linear(d_model, d_model))
        self.cond_enc = (MazeConditionEncoder(use_sdf, d_cond, use_start_goal, maze_channels)
                         if maze_cond else None)
        self.cond_proj = Linear(d_cond, d_model)
        self.transformer = TransformerEncoder(d_model, n_layers, n_heads, d_ff, d_cond,
                                              True, attn_policy, causal=causal)
        self.out = Linear(d_model, data_dim)
        self.out.zero_init = True
        nn.init.zeros_(self.out.weight)
        nn.init.zeros_(self.out.bias)

    def forward(self, x_s: torch.Tensor, s: torch.Tensor, mask: torch.Tensor,
                cond: Cond, pos_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pos_frac [T]: the frames' global positions in [0, 1] (default
        linspace over T; a sequence-sharded call passes its chunk's)."""
        B, T, _ = x_s.shape
        dtype = self.dtype
        mask_in = (mask[..., None] if mask.ndim == 2 else mask).to(x_s.dtype)
        if mask_in.shape[-1] != self.mask_channels:
            raise ValueError(f"mask has {mask_in.shape[-1]} channels, "
                             f"expected {self.mask_channels}")
        h = self.in_proj(torch.cat([x_s, mask_in], dim=-1).to(dtype))
        pos = torch.linspace(0.0, 1.0, T, device=x_s.device) if pos_frac is None else pos_frac
        h = h + continuous_time_embedding(pos, self.d_model).to(dtype)[None]
        h = h + self.level_proj(self.level_emb(s.long()))[:, None, :]
        cond_vec = self._cond_vec(cond, B, x_s.device)
        h = h + self.cond_proj(cond_vec)[:, None, :]
        h = self.transformer(h, cond_vec)
        return self.out(h).float()
