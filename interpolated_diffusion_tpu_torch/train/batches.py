"""Keypoint batch helpers (port subset of train/batches.py)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def gather_keypoints(x0: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x0 [B, T, D], idx [B, K] -> [B, K, D]."""
    return torch.gather(x0, 1, idx.long()[..., None].expand(-1, -1, x0.shape[-1]))


def build_known_mask_values(idx: torch.Tensor, cond: Dict[str, torch.Tensor],
                            D: int, T: int, clamp_endpoints: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Known-endpoint mask/values over keypoint slots.

    Position dims (0:2) of tokens sitting at frame 0 / frame T-1 are known and
    clamped to start/goal; velocity dims stay free.
    """
    B, K = idx.shape
    known_mask = torch.zeros((B, K, D), dtype=torch.bool, device=idx.device)
    known_values = torch.zeros((B, K, D), dtype=torch.float32, device=idx.device)
    if clamp_endpoints and D >= 2:
        if "start_goal" not in cond:
            raise ValueError("clamp_endpoints=True but start_goal missing from cond")
        sg = cond["start_goal"].to(torch.float32)
        start, goal = sg[:, None, :2], sg[:, None, 2:]
        mask_start = (idx == 0)[..., None]
        mask_goal = (idx == T - 1)[..., None]
        known_mask[:, :, :2] = (mask_start | mask_goal).expand(B, K, 2)
        pos_vals = torch.where(mask_start, start, torch.zeros_like(start))
        known_values[:, :, :2] = torch.where(mask_goal, goal, pos_vals)
    return known_mask, known_values
