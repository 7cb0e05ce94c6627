"""Learned keypoint selection models (port of models/selector.py).

`SegmentCostPredictor` (D_phi): a cost MLP over the maze condition vector and
per-segment features. `KeypointSelector`: conv spatial tokens of occ (+ sdf)
(+ start/goal gaussian heatmaps) form a memory; T sinusoidal time queries
cross-attend into it through `CrossAttnBlock`s; optional start/goal and
goal-distance tokens, a query-side condition bias (memory mean or its own
maze encoder) and level conditioning. `select_topk_indices` takes the top
K-2 interior frames by logit, optionally under a Gumbel draw the caller
passes (or a generator draws).

Parameter names follow the original PyTorch reference's state_dict
(spatial_conv.{0,2,..}, spatial_proj, sg_token.{0,2}, goal_dist_token.{0,2},
time_proj, level_mlp.{0,2}, cond_bias.{0,2}, cond_enc.*, blocks.{i}.{norm1,
norm2, attn.in_proj_weight, attn.in_proj_bias, attn.out_proj, ff.0, ff.2},
out; D_phi: cond_enc.*, mlp.{0,2,..}), which the JAX package's
models/torch_import.convert_keypoint_selector / convert_segment_cost read.
The attention is flax's MultiHeadDotProductAttention in plain PyTorch ops:
q scaled by 1/sqrt(Dh) before q k^T, a softmax and the value product, each
rounded to the compute dtype where flax rounds; LayerNorm eps 1e-6. Compute
dtype and parameters are separate as in models/transformer.py
(`set_compute_dtype`); outputs are float32. No Pallas kernel is behind
either model in the JAX package, so none is here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .denoisers import continuous_time_embedding
from .encoders import MazeConditionEncoder
from .transformer import Conv2d, LayerNorm, Linear, SelfAttentionParams


def _mlp2(d_in: int, d: int) -> nn.Sequential:
    return nn.Sequential(Linear(d_in, d), nn.SiLU(), Linear(d, d))


class SegmentCostPredictor(nn.Module):
    """D_phi: (cond, [i/T, j/T, gap/T]) -> scalar cost per segment."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, d_cond: int = 128, seg_feat_dim: int = 3, hidden_dim: int = 256,
                 n_layers: int = 3, use_sdf: bool = False, use_start_goal: bool = True,
                 maze_channels: Sequence[int] = (32, 64)):
        super().__init__()
        self.d_cond, self.seg_feat_dim = d_cond, seg_feat_dim
        self.cond_enc = MazeConditionEncoder(use_sdf, d_cond, use_start_goal, maze_channels)
        layers, d_in = [], d_cond + seg_feat_dim
        for _ in range(max(1, n_layers - 1)):
            layers += [Linear(d_in, hidden_dim), nn.SiLU()]
            d_in = hidden_dim
        self.mlp = nn.Sequential(*layers, Linear(d_in, 1))

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.mlp[0].weight.dtype

    def forward(self, cond: Dict[str, torch.Tensor], seg_feat: torch.Tensor) -> torch.Tensor:
        """seg_feat [S, F] (shared) or [B, S, F] -> cost [B, S] f32."""
        cond_vec = self.cond_enc(cond)
        B = cond_vec.shape[0]
        if seg_feat.ndim == 2:
            seg_feat = seg_feat[None].expand(B, *seg_feat.shape)
        if seg_feat.shape[-1] != self.seg_feat_dim:
            raise ValueError("seg_feat_dim mismatch")
        cond_exp = cond_vec[:, None, :].expand(B, seg_feat.shape[1], self.d_cond)
        x = torch.cat([cond_exp, seg_feat.to(cond_exp.dtype)], dim=-1)
        return self.mlp(x)[..., 0].float()


def cross_attention(q_in: torch.Tensor, kv: torch.Tensor, attn: SelfAttentionParams,
                    n_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """flax MultiHeadDotProductAttention(q_in, kv) from torch's packed
    in-projection [Wq; Wk; Wv] and out_proj, computed in `dtype`."""
    B, L, D = q_in.shape
    dh = D // n_heads
    w, b = attn.in_proj_weight.to(dtype), attn.in_proj_bias.to(dtype)
    heads = lambda t: t.reshape(B, t.shape[1], n_heads, dh).transpose(1, 2)
    q = heads(nn.functional.linear(q_in.to(dtype), w[:D], b[:D]))
    k = heads(nn.functional.linear(kv.to(dtype), w[D:2 * D], b[D:2 * D]))
    v = heads(nn.functional.linear(kv.to(dtype), w[2 * D:], b[2 * D:]))
    q = q / torch.tensor(math.sqrt(dh), dtype=dtype)
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1).to(dtype)
    return attn.out_proj((p @ v).transpose(1, 2).reshape(B, L, D))


class CrossAttnBlock(nn.Module):
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.n_heads = n_heads
        self.norm1 = LayerNorm(d_model)
        self.attn = SelfAttentionParams(d_model)
        self.norm2 = LayerNorm(d_model)
        self.ff = nn.Sequential(Linear(d_model, d_ff), nn.SiLU(), Linear(d_ff, d_model))

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.attn.in_proj_weight.dtype
        x = q + cross_attention(self.norm1(q), kv, self.attn, self.n_heads, dtype)
        return x + self.ff(self.norm2(x))


class KeypointSelector(nn.Module):
    """Per-frame keypoint logits [B, T] from maze conditioning."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, T: int, d_model: int = 256, n_heads: int = 8, d_ff: int = 512,
                 n_layers: int = 2, pos_dim: int = 64, use_sdf: bool = False,
                 use_start_goal: bool = True, use_sg_map: bool = True,
                 use_sg_token: bool = True, use_goal_dist_token: bool = False,
                 use_cond_bias: bool = False, cond_bias_mode: str = "memory",
                 use_level: bool = False, sg_map_sigma: float = 1.5,
                 maze_channels: Sequence[int] = (32, 64)):
        super().__init__()
        if cond_bias_mode not in ("memory", "encoder"):
            raise ValueError(f"cond_bias_mode {cond_bias_mode!r} not in (memory, encoder)")
        self.T, self.d_model, self.pos_dim = T, d_model, pos_dim
        self.use_sdf, self.use_start_goal = use_sdf, use_start_goal
        self.use_sg_map, self.use_level = use_sg_map, use_level
        self.use_cond_bias, self.cond_bias_mode = use_cond_bias, cond_bias_mode
        self.sg_map_sigma = sg_map_sigma
        c_in = 1 + int(use_sdf) + (2 if use_start_goal and use_sg_map else 0)
        layers = []
        for c in maze_channels:
            layers += [Conv2d(c_in, c, 3, padding=1), nn.SiLU()]
            c_in = c
        self.spatial_conv = nn.Sequential(*layers)
        self.spatial_proj = Conv2d(c_in, d_model, 1) if c_in != d_model else None
        self.sg_token = _mlp2(4, d_model) if use_start_goal and use_sg_token else None
        self.goal_dist_token = _mlp2(1, d_model) if use_goal_dist_token else None
        self.time_proj = Linear(pos_dim, d_model)
        self.level_mlp = _mlp2(1, d_model) if use_level else None
        self.cond_bias = _mlp2(d_model, d_model) if use_cond_bias else None
        self.cond_enc = (MazeConditionEncoder(use_sdf, d_model, use_start_goal, maze_channels)
                         if use_cond_bias and cond_bias_mode == "encoder" else None)
        self.blocks = nn.ModuleList([CrossAttnBlock(d_model, n_heads, d_ff)
                                     for _ in range(max(1, n_layers))])
        self.out = Linear(d_model, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.time_proj.weight.dtype

    def _sg_map(self, start_goal: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """Gaussian heatmaps of start and goal: [B, 2, H, W] f32."""
        dev = start_goal.device
        yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        sg = torch.clamp(start_goal.float(), 0, 1)[:, :, None, None]
        sx, sy, gx, gy = sg[:, 0] * (W - 1), sg[:, 1] * (H - 1), sg[:, 2] * (W - 1), sg[:, 3] * (H - 1)
        if self.sg_map_sigma <= 0:
            s_map = ((torch.round(sx) == xx) & (torch.round(sy) == yy)).float()
            g_map = ((torch.round(gx) == xx) & (torch.round(gy) == yy)).float()
        else:
            s2 = 2.0 * self.sg_map_sigma ** 2
            s_map = torch.exp(-((xx - sx) ** 2 + (yy - sy) ** 2) / s2)
            g_map = torch.exp(-((xx - gx) ** 2 + (yy - gy) ** 2) / s2)
        return torch.stack([s_map, g_map], dim=1)

    def forward(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        dtype = self.dtype
        occ = cond["occ"]
        feats = [occ.float()]
        if self.use_sdf:
            if cond.get("sdf") is None:
                raise ValueError("use_sdf is True but sdf missing from cond")
            feats.append(cond["sdf"].float())
        if self.use_start_goal and self.use_sg_map:
            if "start_goal" not in cond:
                raise ValueError("use_start_goal is True but start_goal missing")
            feats.append(self._sg_map(cond["start_goal"], occ.shape[-2], occ.shape[-1]))
        x = self.spatial_conv(torch.cat(feats, dim=1).to(dtype))
        if self.spatial_proj is not None:
            x = self.spatial_proj(x)
        B = x.shape[0]
        tokens = [x.flatten(2).transpose(1, 2)]           # [B, H*W, d] in row-major cells
        if self.sg_token is not None:
            tokens.insert(0, self.sg_token(cond["start_goal"].to(dtype))[:, None, :])
        if self.goal_dist_token is not None:
            sg = cond["start_goal"].float()
            gd = torch.linalg.vector_norm(sg[:, :2] - sg[:, 2:], dim=-1, keepdim=True)
            tokens.insert(0, self.goal_dist_token(gd.to(dtype))[:, None, :])
        memory = torch.cat(tokens, dim=1)

        t = torch.linspace(0.0, 1.0, self.T, device=occ.device)
        q = self.time_proj(continuous_time_embedding(t, self.pos_dim).to(dtype))
        q = q[None].expand(B, self.T, self.d_model)
        if self.cond_bias is not None:
            cond_vec = self.cond_enc(cond) if self.cond_enc is not None else memory.mean(dim=1)
            q = q + self.cond_bias(cond_vec)[:, None, :]
        if self.level_mlp is not None:
            level = cond.get("level")
            if level is None:
                raise ValueError("use_level is True but level missing from cond")
            if level.ndim == 1:
                level = level[:, None]
            q = q + self.level_mlp(level.to(dtype))[:, None, :]
        for block in self.blocks:
            q = block(q, memory)
        return self.out(q)[..., 0].float()


def select_topk_indices(logits: torch.Tensor, K: int, stochastic: bool = False,
                        tau: float = 1.0, gumbel: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Top-K interior frames by logit, endpoints forced, sorted [B, K] long.

    Stochastic selection adds a Gumbel draw [B, T-2] (`gumbel`, or drawn from
    `generator` as -log(-log(U))) and divides by tau. Ties go to the lower
    index, as jax.lax.top_k breaks them."""
    if logits.ndim != 2:
        raise ValueError("logits must be [B,T]")
    B, T = logits.shape
    if K < 2:
        raise ValueError("K must be >= 2")
    K = min(K, T)
    ends = torch.tensor([0, T - 1], dtype=torch.long, device=logits.device).expand(B, 2)
    if K == 2:
        return ends.clone()
    scores = logits[:, 1:-1].float()
    if stochastic:
        if gumbel is None:
            if generator is None:
                raise ValueError("stochastic selection needs a gumbel draw or a generator")
            u = torch.rand(scores.shape, generator=generator, device=generator.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        scores = (scores + gumbel.to(scores)) / (tau if tau > 0 else 1.0)
    top = torch.argsort(-scores, dim=1, stable=True)[:, :K - 2] + 1
    idx = torch.cat([ends[:, :1], top, ends[:, 1:]], dim=1)
    return torch.sort(idx, dim=1).values
