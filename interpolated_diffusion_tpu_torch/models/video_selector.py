"""Text-conditioned video keyframe selector (port of models/video_selector.py).

T time tokens (a learned embedding plus projected sinusoid positions) pass
a FiLM transformer conditioned on the pooled text embedding (plus an
optional level input) and come out as per-frame logits [B, T], f32.
Module names are the flax names (text_enc, lvl_fc1, pos_proj, time_embed,
transformer, out); f32 master parameters compute in bf16 under
`set_compute_dtype`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .denoisers import continuous_time_embedding
from .encoders import TextConditionEncoder
from .transformer import Linear, TransformerEncoder


class VideoKeyframeSelector(nn.Module):
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, T: int, text_dim: int, d_model: int = 256, d_cond: int = 256,
                 n_layers: int = 6, n_heads: int = 8, d_ff: int = 1024, pos_dim: int = 64,
                 use_level: bool = False, attn_policy: str = "fused"):
        super().__init__()
        self.T, self.pos_dim, self.use_level = T, pos_dim, use_level
        self.text_enc = TextConditionEncoder(text_dim, d_cond)
        if use_level:
            self.lvl_fc1 = Linear(1, d_cond)
            self.lvl_fc2 = Linear(d_cond, d_cond)
        self.pos_proj = Linear(pos_dim, d_model)
        self.time_embed = nn.Parameter(torch.empty(T, d_model))
        self.transformer = TransformerEncoder(d_model, n_layers, n_heads, d_ff, d_cond, True,
                                              attn_policy)
        self.out = Linear(d_model, 1)

    def init_seeded(self, uniform_) -> None:
        uniform_(self.time_embed, 0.02 * math.sqrt(3.0))   # std 0.02, as the JAX init

    def forward(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        dtype = self.compute_dtype or self.out.weight.dtype
        cond_vec = self.text_enc(cond)
        if self.use_level:
            level = cond.get("level")
            if level is None:
                raise ValueError("use_level=True but level missing from cond")
            if level.ndim == 1:
                level = level[:, None]
            cond_vec = cond_vec + self.lvl_fc2(F.silu(self.lvl_fc1(level.to(dtype))))
        B, dev = cond_vec.shape[0], cond_vec.device
        pos = continuous_time_embedding(torch.linspace(0.0, 1.0, self.T, device=dev),
                                        self.pos_dim).to(dtype)
        x = self.pos_proj(pos)[None].expand(B, -1, -1) + self.time_embed.to(dtype)[None]
        return self.out(self.transformer(x, cond_vec))[..., 0].float()


def video_selector_from_meta(meta) -> VideoKeyframeSelector:
    """The selector a video_selector checkpoint's meta describes."""
    return VideoKeyframeSelector(
        T=int(meta["T"]), text_dim=int(meta["text_dim"]), d_model=int(meta["d_model"]),
        d_cond=int(meta["d_cond"]), n_layers=int(meta["n_layers"]),
        n_heads=int(meta["n_heads"]), d_ff=int(meta["d_ff"]), use_level=bool(meta["use_level"]))
