"""Maze and text condition encoders (port of models/encoders.py).

Parameter names follow the original PyTorch reference (`maze.convs.{0,2,..}`,
`maze.fc`, `sg.mlp.{0,2}`, the text encoder's `proj.{0,2}`), so models/jax_import.py and the JAX package's
torch_import.convert_state_dict map between the two. Convolutions run NCHW,
3x3 with padding 1 (flax "SAME").
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .transformer import Conv2d, Linear


class MazeEncoder(nn.Module):
    """Conv3x3+SiLU stack -> spatial mean -> linear."""

    def __init__(self, in_channels: int = 1, d_cond: int = 128,
                 channels: Sequence[int] = (32, 64)):
        super().__init__()
        layers, cin = [], in_channels
        for c in channels:
            layers += [Conv2d(cin, c, 3, padding=1), nn.SiLU()]
            cin = c
        self.convs = nn.Sequential(*layers)
        self.fc = Linear(cin, d_cond)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs(x)
        return self.fc(x.mean(dim=(2, 3)))


class StartGoalEncoder(nn.Module):
    def __init__(self, d_cond: int = 128):
        super().__init__()
        self.mlp = nn.Sequential(Linear(4, d_cond), nn.SiLU(), Linear(d_cond, d_cond))

    def forward(self, start_goal: torch.Tensor) -> torch.Tensor:
        return self.mlp(start_goal)


class MazeConditionEncoder(nn.Module):
    """occ [B, 1, G, G] (+ sdf) CNN embedding, plus the start/goal MLP."""

    def __init__(self, use_sdf: bool = False, d_cond: int = 128,
                 use_start_goal: bool = True, maze_channels: Sequence[int] = (32, 64)):
        super().__init__()
        self.use_sdf = use_sdf
        self.maze = MazeEncoder(2 if use_sdf else 1, d_cond, maze_channels)
        self.sg = StartGoalEncoder(d_cond) if use_start_goal else None

    def forward(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = cond["occ"]
        if self.use_sdf:
            if cond.get("sdf") is None:
                raise ValueError("use_sdf is True but sdf missing from cond")
            x = torch.cat([x, cond["sdf"]], dim=1)
        emb = self.maze(x)
        if self.sg is not None:
            if "start_goal" not in cond:
                raise ValueError("use_start_goal is True but start_goal missing from cond")
            emb = emb + self.sg(cond["start_goal"])
        return emb


class TextConditionEncoder(nn.Module):
    """Text embeddings [B, L, text_dim] (or [B, text_dim]) -> [B, d_cond]:
    mean over the tokens, then Linear -> SiLU -> Linear (the JAX package's
    text_enc fc1 / fc2, the reference's proj.0 / proj.2)."""

    def __init__(self, text_dim: int, d_cond: int = 128):
        super().__init__()
        self.proj = nn.Sequential(Linear(text_dim, d_cond), nn.SiLU(), Linear(d_cond, d_cond))

    def forward(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        text = cond.get("text_embed")
        if text is None:
            raise ValueError("text_embed missing from cond")
        if text.ndim > 2:
            text = text.mean(dim=tuple(range(1, text.ndim - 1)))
        return self.proj(text)
