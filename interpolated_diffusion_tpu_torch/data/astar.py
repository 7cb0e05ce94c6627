"""4-connected grid A* with Manhattan heuristic (own copy of the JAX package's
data/astar.py; numpy only, host-side).
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

_MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))


def astar(
    occ: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int]
) -> Optional[List[Tuple[int, int]]]:
    """Shortest 4-connected path on a grid where occ==1 is a wall."""
    h, w = occ.shape
    start = tuple(int(v) for v in start)
    goal = tuple(int(v) for v in goal)
    if occ[start] == 1 or occ[goal] == 1:
        return None

    def heur(c):
        return abs(c[0] - goal[0]) + abs(c[1] - goal[1])

    frontier = [(heur(start), 0, start)]
    came_from: dict = {}
    best_g = {start: 0}
    done = set()
    while frontier:
        _, g, cur = heapq.heappop(frontier)
        if cur in done:
            continue
        done.add(cur)
        if cur == goal:
            path = [cur]
            while cur in came_from:
                cur = came_from[cur]
                path.append(cur)
            return path[::-1]
        ci, cj = cur
        for di, dj in _MOVES:
            ni, nj = ci + di, cj + dj
            if not (0 <= ni < h and 0 <= nj < w) or occ[ni, nj] == 1:
                continue
            nxt = (ni, nj)
            ng = g + 1
            if ng < best_g.get(nxt, 1 << 30):
                best_g[nxt] = ng
                came_from[nxt] = cur
                heapq.heappush(frontier, (ng + heur(nxt), ng, nxt))
    return None
