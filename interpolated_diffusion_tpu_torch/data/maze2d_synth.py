"""Gym-free maze2d episode synthesiser: a D4RL `get_dataset()` stand-in (own
copy of the JAX package's data/maze2d_synth.py; numpy only).

D4RL maze2d data is collected by a damped point mass driven by a PD
waypoint controller along planned routes between sampled goals on a fixed
layout. This module runs that process on the real maze2d layouts
(data/d4rl.py MAZE_SPECS) in numpy, vectorised over a batch of episodes,
with routes from the port's data/astar.py, and emits the `get_dataset()`
array layout (observations [N, 4] = x, y, vx, vy; terminals [N]; timeouts
[N]) that data/d4rl.py windows. Same seed, same arrays as the JAX package's.

World coordinates follow data/d4rl.py:normalize_positions: cell (i, j) has
its center at (x=j, y=i), walls on the border, so free positions live in
(0.5, w-1.5) x (0.5, h-1.5).
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np

from .astar import astar
from .d4rl import MAZE_SPECS, maze_map_to_occ


def _free_cells(occ: np.ndarray) -> np.ndarray:
    return np.argwhere(occ < 0.5)


def _plan_route(occ: np.ndarray, rng: np.random.RandomState,
                min_cell_dist: int = 3, tries: int = 50
                ) -> List[Tuple[int, int]]:
    """A* route between two far-apart free cells (grid (i, j) waypoints)."""
    free = _free_cells(occ)
    for _ in range(tries):
        s, g = free[rng.randint(0, len(free), size=2)]
        if abs(int(s[0]) - int(g[0])) + abs(int(s[1]) - int(g[1])) < min_cell_dist:
            continue
        path = astar(occ, tuple(s), tuple(g))
        if path is not None and len(path) >= min_cell_dist:
            return path
    raise RuntimeError("no A*-connected far-apart cell pair found")


def simulate_episodes(
    occ: np.ndarray,
    n_episodes: int,
    max_steps: int = 600,
    dt: float = 0.1,
    kp: float = 10.0,
    kd: float = 2.0,
    a_max: float = 10.0,
    v_max: float = 4.0,
    noise: float = 0.15,
    waypoint_tol: float = 0.35,
    goal_tol: float = 0.25,
    seed: int = 0,
):
    """Batched PD point-mass rollouts along A* routes.

    Returns (observations [N, 4], terminals [N], timeouts [N]) concatenated
    over episodes; a terminal marks goal arrival, a timeout marks hitting
    max_steps first. All episodes step in lockstep (vectorized over the
    episode axis); finished episodes are frozen and trimmed at the end.
    """
    rng = np.random.RandomState(seed)
    routes = [_plan_route(occ, rng) for _ in range(n_episodes)]
    L = max(len(r) for r in routes)
    # waypoint table [E, L, 2] in world xy; short routes repeat their goal
    wp = np.zeros((n_episodes, L, 2), dtype=np.float32)
    n_wp = np.array([len(r) for r in routes], dtype=np.int32)
    for e, r in enumerate(routes):
        cells = np.asarray(r, dtype=np.float32)
        xy = cells[:, ::-1]  # (i, j) -> (x=j, y=i)
        wp[e, : len(r)] = xy
        wp[e, len(r):] = xy[-1]

    pos = wp[:, 0] + rng.uniform(-0.1, 0.1, size=(n_episodes, 2)).astype(np.float32)
    vel = np.zeros_like(pos)
    cur = np.zeros(n_episodes, dtype=np.int32)      # current waypoint index
    done = np.zeros(n_episodes, dtype=bool)
    done_at = np.full(n_episodes, max_steps, dtype=np.int32)
    obs = np.zeros((n_episodes, max_steps, 4), dtype=np.float32)

    h, w = occ.shape
    e_ix = np.arange(n_episodes)
    for t in range(max_steps):
        obs[:, t, :2] = pos
        obs[:, t, 2:] = vel
        target = wp[e_ix, cur]
        d = np.linalg.norm(target - pos, axis=1)
        # advance the waypoint pointer when close enough (goal keeps tighter tol)
        at_last = cur >= n_wp - 1
        adv = (~at_last) & (d < waypoint_tol)
        cur = np.where(adv, cur + 1, cur)
        reached = at_last & (d < goal_tol)
        newly = reached & ~done
        done_at = np.where(newly, t + 1, done_at)
        done |= reached

        target = wp[e_ix, cur]
        acc = kp * (target - pos) - kd * vel
        acc += rng.normal(0.0, noise, size=acc.shape).astype(np.float32)
        acc = np.clip(acc, -a_max, a_max)
        nvel = np.clip(vel + acc * dt, -v_max, v_max)
        npos = pos + nvel * dt
        # wall handling: a component that would enter a wall cell is zeroed
        # (slide along the wall), checked per axis
        for axis in (0, 1):
            trial = pos.copy()
            trial[:, axis] = npos[:, axis]
            j = np.clip(np.round(trial[:, 0]).astype(int), 0, w - 1)
            i = np.clip(np.round(trial[:, 1]).astype(int), 0, h - 1)
            hit = occ[i, j] > 0.5
            nvel[hit, axis] = 0.0
            npos[hit, axis] = pos[hit, axis]
        live = ~done
        pos = np.where(live[:, None], npos, pos)
        vel = np.where(live[:, None], nvel, vel)

    chunks, terms, touts = [], [], []
    for e in range(n_episodes):
        n = int(done_at[e])
        chunks.append(obs[e, :n])
        tm = np.zeros(n, dtype=bool)
        to = np.zeros(n, dtype=bool)
        if done_at[e] < max_steps:
            tm[-1] = True
        else:
            to[-1] = True
        terms.append(tm)
        touts.append(to)
    return (np.concatenate(chunks, axis=0),
            np.concatenate(terms, axis=0),
            np.concatenate(touts, axis=0))


def main(argv=None):
    p = argparse.ArgumentParser("maze2d_synth (gym-free D4RL episode stand-in)")
    p.add_argument("--env_id", type=str, default="maze2d-medium-v1",
                   choices=sorted(MAZE_SPECS))
    p.add_argument("--n_episodes", type=int, default=300)
    p.add_argument("--max_steps", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_path", type=str, required=True)
    args = p.parse_args(argv)

    occ = maze_map_to_occ(MAZE_SPECS[args.env_id])
    observations, terminals, timeouts = simulate_episodes(
        occ, args.n_episodes, args.max_steps, seed=args.seed
    )
    np.savez_compressed(args.out_path, observations=observations,
                        terminals=terminals, timeouts=timeouts)
    ep = int(terminals.sum() + timeouts.sum())
    print(f"wrote {args.out_path}: obs {observations.shape}, {ep} episodes "
          f"({int(terminals.sum())} terminal / {int(timeouts.sum())} timeout)")


if __name__ == "__main__":
    main()
