"""Trajectory metrics, batched (port of eval/metrics.py).

collision_rate (cell lookup + out of bounds), goal_distance, success (< one
cell), path_length, smoothness = mean |accel|, and mse_to_gt.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _pos_to_cell(pos: torch.Tensor, h: int, w: int):
    """(row i, column j, out of bounds) of positions [..., 2] in [0, 1]^2."""
    x, y = pos[..., 0], pos[..., 1]
    oob = (x < 0) | (x > 1) | (y < 0) | (y > 1)
    j = torch.clamp(torch.round(x * max(w - 1, 1)).long(), 0, w - 1)
    i = torch.clamp(torch.round(y * max(h - 1, 1)).long(), 0, h - 1)
    return i, j, oob


def compute_metrics_batch(occ: torch.Tensor, traj: torch.Tensor, goal: torch.Tensor,
                          gt: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """occ [B, h, w] (or [B, 1, h, w]), traj [B, T, >=2] (positions in dims
    0:2), goal [B, 2], gt like traj -> per-sample metrics [B]."""
    if occ.ndim == 4:
        occ = occ[:, 0]
    pos = traj[..., :2]
    B, T = pos.shape[:2]
    h, w = occ.shape[-2:]
    i, j, oob = _pos_to_cell(pos, h, w)
    b = torch.arange(B, device=pos.device)[:, None]
    collision = ((occ[b, i, j] > 0.5) | oob).float().mean(dim=1)
    goal_dist = torch.linalg.vector_norm(pos[:, -1] - goal, dim=-1)
    success = (goal_dist < (1.0 / float(w))).float()
    path_len = torch.linalg.vector_norm(pos[:, 1:] - pos[:, :-1], dim=-1).sum(dim=1)
    if T < 3:
        smooth = torch.zeros_like(goal_dist)
    else:
        acc = pos[:, 2:] - 2 * pos[:, 1:-1] + pos[:, :-2]
        smooth = torch.linalg.vector_norm(acc, dim=-1).mean(dim=1)
    out = {"collision_rate": collision, "goal_dist": goal_dist, "success": success,
           "path_length": path_len, "smoothness": smooth}
    if gt is not None:
        out["mse_to_gt"] = ((traj - gt) ** 2).mean(dim=(1, 2))
    return out


def compute_metrics(occ, traj, goal, gt=None) -> Dict[str, float]:
    """One sample's metrics as floats: occ [h, w], traj [T, D], goal [2]."""
    batch = compute_metrics_batch(
        occ[None] if occ.ndim == 2 else occ, traj[None] if traj.ndim == 2 else traj,
        goal[None] if goal.ndim == 1 else goal,
        None if gt is None else (gt[None] if gt.ndim == 2 else gt))
    return {k: float(v[0]) for k, v in batch.items()}
