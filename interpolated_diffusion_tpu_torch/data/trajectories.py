"""Grid path -> normalized trajectory resampling (own copy of the JAX package's
data/trajectories.py; numpy only, host-side).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def grid_path_to_xy(path: List[Tuple[int, int]], h: int, w: int) -> np.ndarray:
    """Cell (i, j) centers to normalized (x, y) in [0, 1]²."""
    arr = np.asarray(path, dtype=np.float32)
    x = (arr[:, 1] + 0.5) / w
    y = (arr[:, 0] + 0.5) / h
    return np.stack([x, y], axis=1)


def resample_polyline(points: np.ndarray, T: int) -> np.ndarray:
    """Arclength-uniform resampling of a polyline to T points (vectorized)."""
    if points.shape[0] == 1:
        return np.repeat(points, T, axis=0)
    seg = points[1:] - points[:-1]
    seg_len = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = cum[-1]
    if total <= 1e-8:
        return np.repeat(points[:1], T, axis=0)
    samples = np.linspace(0.0, total, T)
    idx = np.clip(np.searchsorted(cum, samples, side="right") - 1, 0, len(seg_len) - 1)
    denom = seg_len[idx]
    t = np.where(denom <= 1e-8, 0.0, (samples - cum[idx]) / np.where(denom <= 1e-8, 1.0, denom))
    out = points[idx] + t[:, None] * seg[idx]
    return out.astype(np.float32)


def path_to_trajectory(
    path: List[Tuple[int, int]], h: int, w: int, T: int, with_velocity: bool = False
) -> np.ndarray:
    """Grid path → [T, 2] positions, or [T, 4] with finite-diff velocity."""
    pos = resample_polyline(grid_path_to_xy(path, h, w), T)
    if not with_velocity:
        return pos.astype(np.float32)
    dt = 1.0 / float(T)
    v = np.zeros_like(pos)
    v[:-1] = (pos[1:] - pos[:-1]) / dt
    return np.concatenate([pos, v], axis=-1).astype(np.float32)
