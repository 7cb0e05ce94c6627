"""Procedural maze generation with guaranteed A*-solvable paths (own copy of
the JAX package's data/maze.py; numpy only, host-side). The SDF uses a
vectorized L1 distance transform.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .astar import astar


def generate_maze(
    rng: np.random.RandomState,
    h: int = 21,
    w: int = 21,
    p_wall: float = 0.2,
    min_l1: Optional[int] = None,
    max_tries: int = 100,
):
    """Random occupancy grid + far-apart start/goal + guaranteed A* path.

    Rejection sampling, fully array-oriented per attempt: the wall field, the
    bordered frame, and the endpoint pair come from vectorized draws; only the
    A* solvability check walks cells. Endpoints are drawn from the interior
    free set (the frame is closed before sampling), which keeps the same
    guarantee as the reference — free, separated, connected — with one fewer
    carve-back step.
    """
    sep = h // 2 if min_l1 is None else min_l1
    for _ in range(max_tries):
        occ = (rng.rand(h, w) < p_wall).astype(np.int32)
        occ[[0, -1], :] = 1
        occ[:, [0, -1]] = 1
        free_flat = np.flatnonzero(occ.ravel() == 0)
        if free_flat.size < 2:
            continue
        a, b = free_flat[rng.randint(0, free_flat.size, size=2)]
        start, goal = divmod(int(a), w), divmod(int(b), w)
        if abs(start[0] - goal[0]) + abs(start[1] - goal[1]) < sep:
            continue
        path = astar(occ, start, goal)
        if path is not None:
            return occ, start, goal, path
    raise RuntimeError(
        f"maze sampling exhausted {max_tries} attempts without an "
        f"A*-solvable layout (h={h}, w={w}, p_wall={p_wall}, min_l1={sep})"
    )


def sdf_from_occupancy(occ: np.ndarray, signed: bool = True) -> np.ndarray:
    """L1 distance to the nearest wall cell, negated inside walls.

    Vectorized two-pass chamfer sweep (O(h·w), vs the reference's O(n²)
    cdist) — identical values for the L1 metric.
    """
    h, w = occ.shape
    INF = np.float32(h + w + 10)
    dist = np.where(occ > 0.5, 0.0, INF).astype(np.float32)
    if (occ > 0.5).sum() == 0:
        return np.zeros((h, w), dtype=np.float32)
    # L1 is separable: sweep down/up along rows (each step vectorized over
    # the full row), then left/right along columns
    for i in range(1, h):
        np.minimum(dist[i], dist[i - 1] + 1, out=dist[i])
    for i in range(h - 2, -1, -1):
        np.minimum(dist[i], dist[i + 1] + 1, out=dist[i])
    for j in range(1, w):
        np.minimum(dist[:, j], dist[:, j - 1] + 1, out=dist[:, j])
    for j in range(w - 2, -1, -1):
        np.minimum(dist[:, j], dist[:, j + 1] + 1, out=dist[:, j])
    if signed:
        dist = dist * (1.0 - 2.0 * occ.astype(np.float32))
    return dist
