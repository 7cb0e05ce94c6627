"""D4RL maze2d episode windowing: the gym-free prepared-data route (own copy
of the JAX package's data/d4rl.py; numpy only).

The raw episode arrays (observations + terminals, the layout
`gym.make(env).get_dataset()` returns) are read from an exported npz, and
this module does the rest:

  * maze-map parsing: string specs ('#'/'G'/' ' rows split by '\\') and
    integer encodings {0,1} / {10,11,12} (WALL=10, x-indexed, transposed)
  * episode splitting on terminals (and timeouts), windowing modes
    end / random / episode, a deterministic RNG per sample index
  * position normalisation to [0, 1] from the wall-grid bounds, optional
    y-flip
  * rejection sampling on collision rate / goal distance / path length /
    tortuosity / turn count

The output is the PreparedTrajectoryDataset npz contract (x, occ,
start_goal, optionally sdf), so the trainers, the DP prep and the samplers
read it as they read the particle-maze data. `build_unified` merges several
envs onto one padded grid (`main_unified`, `python -m ...data.d4rl unified`).
The layouts of the three standard maze2d envs ship inline (MAZE_SPECS).
Everything is numpy, so its arrays equal the JAX package's bit for bit.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np

# Standard maze2d layouts (public D4RL maze specs).
MAZE_SPECS = {
    "maze2d-umaze-v1": "#####\\#GOO#\\###O#\\#OOO#\\#####",
    "maze2d-medium-v1": "########\\#OO##OO#\\#OO#OOO#\\##OOO###\\#OO#OOO#\\#O#OO#O#\\#OOO#OG#\\########",
    "maze2d-large-v1": "############\\#OOOO#OOOOO#\\#O##O#O#O#O#\\#OOOOOO#OOO#\\#O####O###O#\\#OO#O#OOOOO#\\##O#O#O#O###\\#OO#OOO#OGO#\\############",
}


def parse_maze_spec(maze_str: str) -> np.ndarray:
    """String spec rows split by '\\' → {10,11,12} int array [x, y]."""
    lines = maze_str.strip().split("\\")
    width, height = len(lines), len(lines[0])
    arr = np.zeros((width, height), dtype=np.int32)
    for wi in range(width):
        for hi in range(height):
            tile = lines[wi][hi]
            arr[wi, hi] = 10 if tile == "#" else (12 if tile == "G" else 11)
    return arr


def maze_map_to_occ(maze_map) -> np.ndarray:
    """Any supported maze_map encoding → occupancy [h, w] float."""
    if isinstance(maze_map, str):
        maze_map = parse_maze_spec(maze_map)
    arr = np.asarray(maze_map)
    if arr.ndim != 2:
        raise ValueError("Unsupported maze_map format")
    uniq = set(np.unique(arr).tolist())
    if uniq.issubset({0, 1}):
        return (arr > 0).astype(np.float32)
    if uniq.issubset({10, 11, 12}):
        # D4RL pointmaze: WALL=10, EMPTY=11, GOAL=12, indexed [x, y].
        return (arr == 10).astype(np.float32).T
    return (arr > 0).astype(np.float32)


def split_episodes(terminals: np.ndarray, timeouts: Optional[np.ndarray] = None
                   ) -> List[Tuple[int, int]]:
    done = terminals.astype(bool)
    if timeouts is not None:
        done = done | timeouts.astype(bool)
    ends = np.where(done)[0]
    episodes, start = [], 0
    for e in ends:
        if e + 1 - start >= 2:
            episodes.append((start, e + 1))
        start = e + 1
    if len(terminals) - start >= 2:
        episodes.append((start, len(terminals)))
    return episodes


def normalize_positions(
    pos: np.ndarray, occ: np.ndarray, flip_y: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """World xy → [0,1] using the wall-grid bounds (maze2d cell size 1,
    cell (i, j) centered at world (x=j, y=i)). Returns (norm_pos, pos_low,
    pos_scale). low=(0,0), scale=(w-1, h-1) matches the framework-wide cell
    convention j = round(x * (w-1)) (eval/metrics.py:_pos_to_cell) and the
    reference's grid-index bounds (dataset.py:505-512)."""
    h, w = occ.shape
    pos_low = np.array([0.0, 0.0], dtype=np.float32)
    pos_scale = np.array([w - 1.0, h - 1.0], dtype=np.float32)
    out = (pos - pos_low) / pos_scale
    if flip_y:
        out = out.copy()
        out[..., 1] = 1.0 - out[..., 1]
    return np.clip(out, 0.0, 1.0), pos_low, pos_scale


def _collision_rate(traj: np.ndarray, occ: np.ndarray) -> float:
    h, w = occ.shape
    j = np.clip(np.round(traj[:, 0] * (w - 1)).astype(int), 0, w - 1)
    i = np.clip(np.round(traj[:, 1] * (h - 1)).astype(int), 0, h - 1)
    return float((occ[i, j] > 0.5).mean())


def _tortuosity(traj: np.ndarray) -> float:
    seg = np.linalg.norm(np.diff(traj, axis=0), axis=1).sum()
    direct = np.linalg.norm(traj[-1] - traj[0])
    return float(seg / max(direct, 1e-6))


def _turn_count(traj: np.ndarray, angle_deg: float) -> int:
    d = np.diff(traj, axis=0)
    d = d[np.linalg.norm(d, axis=1) > 1e-8]
    if len(d) < 2:
        return 0
    ang = np.arctan2(d[:, 1], d[:, 0])
    dd = np.abs(np.diff(np.unwrap(ang)))
    return int((dd > np.deg2rad(angle_deg)).sum())


def window_episodes(
    observations: np.ndarray,     # [N, >=2] (x, y, ...)
    terminals: np.ndarray,
    occ: np.ndarray,
    T: int,
    num_samples: int,
    timeouts: Optional[np.ndarray] = None,
    window_mode: str = "end",     # end | random | episode
    with_velocity: bool = False,
    vel_mode: str = "fd",         # fd (= recompute convention) | obs
    flip_y: bool = False,
    seed: int = 0,
    max_collision_rate: float = 1.0,
    min_goal_dist: Optional[float] = None,
    min_path_len: Optional[float] = None,
    min_tortuosity: Optional[float] = None,
    min_turns: Optional[int] = None,
    turn_angle_deg: float = 30.0,
    max_resample_tries: int = 50,
) -> Dict[str, np.ndarray]:
    """Windowed, normalized, rejection-sampled trajectories → prepared arrays.

    Velocity channels (vel_mode):
      * "fd" (default): finite differences of the WINDOWED normalized
        positions with dt = 1/T — v[t] = (pos[t+1] − pos[t])·T, v[T−1] = 0.
        This is bitwise the convention of ops.keyframes.
        recompute_velocity_channels, so Stage-2 interp corruption with
        --recompute_vel 1 reproduces GT velocities exactly on uncorrupted
        anchors. (Round-2 postmortem: storing obs velocities while the
        corruption recomputes fd×T left the two conventions ~13× apart on the
        synthetic episodes, which blew up Stage-2 targets and the eval MSE.)
      * "obs": raw observation velocities (obs[:, 2:4] — maze2d observations
        are [x, y, vx, vy]) scaled by the position bounds, the reference's
        normalization (dataset.py:537-545). Only consistent with the fd×T
        recompute when the source sim stepped at dt_sim ≈ 1/T.
    """
    episodes = split_episodes(terminals, timeouts)
    if not episodes:
        raise ValueError("no episodes found")
    pos_all, _, pos_scale = normalize_positions(observations[:, :2], occ, flip_y)
    vel_all = None
    if with_velocity and vel_mode == "obs" and observations.shape[1] >= 4:
        vel_all = (observations[:, 2:4] / pos_scale).astype(np.float32)
        if flip_y:
            vel_all = vel_all.copy()
            vel_all[:, 1] = -vel_all[:, 1]
    D = 4 if with_velocity else 2
    x_out = np.zeros((num_samples, T, D), dtype=np.float32)
    sg_out = np.zeros((num_samples, 4), dtype=np.float32)
    kept = 0
    for i in range(num_samples):
        rng = np.random.RandomState(seed + i)
        traj = None
        for _ in range(max_resample_tries):
            lo, hi = episodes[rng.randint(len(episodes))]
            n = hi - lo
            if window_mode == "episode" or n <= T:
                idx = np.linspace(lo, hi - 1, T).round().astype(int)
            elif window_mode == "random":
                s = rng.randint(lo, hi - T + 1)
                idx = np.arange(s, s + T)
            else:  # end
                idx = np.arange(hi - T, hi)
            cand = pos_all[idx]
            if _collision_rate(cand, occ) > max_collision_rate:
                continue
            if min_goal_dist is not None and \
                    np.linalg.norm(cand[-1] - cand[0]) < min_goal_dist:
                continue
            if min_path_len is not None and \
                    np.linalg.norm(np.diff(cand, axis=0), axis=1).sum() < min_path_len:
                continue
            if min_tortuosity is not None and _tortuosity(cand) < min_tortuosity:
                continue
            if min_turns is not None and \
                    _turn_count(cand, turn_angle_deg) < min_turns:
                continue
            traj = cand
            break
        if traj is None:
            continue
        if with_velocity:
            if vel_all is not None:
                v = vel_all[idx]
            else:  # fd: matches recompute_velocity_channels (dt = 1/T)
                v = np.zeros_like(traj)
                v[:-1] = (traj[1:] - traj[:-1]) * float(T)
            x_out[kept] = np.concatenate([traj, v], axis=-1)
        else:
            x_out[kept] = traj
        sg_out[kept] = np.concatenate([traj[0], traj[-1]])
        kept += 1
    if kept == 0:
        raise ValueError("rejection sampling rejected everything")
    occ_out = np.broadcast_to(occ[None, None], (kept, 1, *occ.shape)).copy()
    return {"x": x_out[:kept], "occ": occ_out.astype(np.float32),
            "start_goal": sg_out[:kept]}


def build_unified(paths: List[str], use_sdf: bool = True, shuffle_seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """Merge per-env prepared npz files onto one padded grid.

    Capability parity with reference scripts/datasets/d4rl/
    build_unified_prepared.py (resize_mode=pad, pad_scale_mode=none): each
    env's occupancy is centered in the max (h, w) grid with wall padding, and
    positions are remapped through the same pad offsets, so trajectories stay
    aligned with their cells. Emits per-sample occ (+ sdf) like the reference.
    """
    from .maze import sdf_from_occupancy

    loaded = []
    for p in paths:
        with np.load(p) as f:
            loaded.append({k: f[k] for k in f.files})
    th = max(d["occ"].shape[-2] for d in loaded)
    tw = max(d["occ"].shape[-1] for d in loaded)

    xs, occs, sgs, sdfs = [], [], [], []
    for d in loaded:
        occ = d["occ"][0, 0] if d["occ"].ndim == 4 else d["occ"]
        h, w = occ.shape
        pt, pl = (th - h) // 2, (tw - w) // 2
        occ_p = np.ones((th, tw), dtype=np.float32)
        occ_p[pt:pt + h, pl:pl + w] = occ

        def remap(xy):
            out = xy.copy()
            out[..., 0] = (xy[..., 0] * (w - 1) + pl) / (tw - 1)
            out[..., 1] = (xy[..., 1] * (h - 1) + pt) / (th - 1)
            return out

        x = d["x"].copy()
        x[..., :2] = remap(x[..., :2])
        if x.shape[-1] >= 4:
            x[..., 2] = x[..., 2] * (w - 1) / (tw - 1)
            x[..., 3] = x[..., 3] * (h - 1) / (th - 1)
        sg = d["start_goal"].reshape(-1, 2, 2)
        sg = remap(sg).reshape(-1, 4)
        n = x.shape[0]
        xs.append(x)
        sgs.append(sg)
        occs.append(np.broadcast_to(occ_p[None, None], (n, 1, th, tw)))
        if use_sdf:
            sdf_p = sdf_from_occupancy(occ_p)
            sdfs.append(np.broadcast_to(sdf_p[None, None], (n, 1, th, tw)))

    out = {
        "x": np.concatenate(xs, axis=0).astype(np.float32),
        "occ": np.concatenate(occs, axis=0).astype(np.float32),
        "start_goal": np.concatenate(sgs, axis=0).astype(np.float32),
    }
    if use_sdf:
        out["sdf"] = np.concatenate(sdfs, axis=0).astype(np.float32)
    perm = np.random.RandomState(shuffle_seed).permutation(out["x"].shape[0])
    return {k: v[perm] for k, v in out.items()}


def main_unified(argv=None):
    p = argparse.ArgumentParser("build_unified_prepared")
    p.add_argument("--inputs", type=str, nargs="+", required=True)
    p.add_argument("--out_path", type=str, required=True)
    p.add_argument("--use_sdf", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    data = build_unified(list(args.inputs), bool(args.use_sdf), args.seed)
    np.savez_compressed(args.out_path, **data)
    print(f"wrote {args.out_path}: " +
          ", ".join(f"{k}{v.shape}" for k, v in data.items()))


def main(argv=None):
    """Prepared-npz writer (parity with src/data/prepare_d4rl_dataset.py).

    Input: --episodes npz with `observations` [N, >=2] and `terminals` [N]
    (+ optional `timeouts`), e.g. exported from d4rl's get_dataset() on any
    machine with the gym stack.
    """
    p = argparse.ArgumentParser("prepare_d4rl (gym-free)")
    p.add_argument("--episodes", type=str, required=True)
    p.add_argument("--env_id", type=str, default="maze2d-medium-v1")
    p.add_argument("--out_path", type=str, required=True)
    p.add_argument("--T", type=int, default=64)
    p.add_argument("--num_samples", type=int, default=10000)
    p.add_argument("--window_mode", type=str, default="end",
                   choices=["end", "random", "episode"])
    p.add_argument("--with_velocity", type=int, default=0)
    p.add_argument("--vel_mode", type=str, default="fd", choices=["fd", "obs"],
                   help="fd: finite-diff of windowed positions with dt=1/T "
                        "(the recompute_velocity_channels convention); obs: "
                        "raw observation velocities / pos_scale (reference "
                        "dataset.py:537-545)")
    p.add_argument("--flip_y", type=int, default=0)
    p.add_argument("--max_collision_rate", type=float, default=0.0)
    p.add_argument("--min_goal_dist", type=float, default=None)
    p.add_argument("--min_path_len", type=float, default=None)
    p.add_argument("--min_tortuosity", type=float, default=None)
    p.add_argument("--min_turns", type=int, default=None)
    p.add_argument("--turn_angle_deg", type=float, default=30.0)
    p.add_argument("--use_sdf", type=int, default=0,
                   help="also emit a per-sample signed distance field "
                        "(reference prepare_d4rl_dataset.py --use_sdf)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    with np.load(args.episodes) as f:
        obs = f["observations"]
        terminals = f["terminals"]
        timeouts = f["timeouts"] if "timeouts" in f.files else None
        # prefer the exporter's own maze layout (d4rl_live.py writes the live
        # env's maze_map) — the inline MAZE_SPECS only cover the three
        # standard envs
        maze_map = f["maze_map"] if "maze_map" in f.files else None
    if maze_map is None:
        if args.env_id not in MAZE_SPECS:
            raise ValueError(
                f"episodes npz has no maze_map and {args.env_id!r} is not a "
                f"known spec ({sorted(MAZE_SPECS)}); re-export with "
                "data/d4rl_live.py, which records the live env's maze_map")
        maze_map = MAZE_SPECS[args.env_id]
    occ = maze_map_to_occ(maze_map)
    data = window_episodes(
        obs, terminals, occ, args.T, args.num_samples, timeouts,
        args.window_mode, bool(args.with_velocity), args.vel_mode,
        bool(args.flip_y),
        args.seed, args.max_collision_rate, args.min_goal_dist,
        args.min_path_len, args.min_tortuosity, args.min_turns,
        args.turn_angle_deg,
    )
    if args.use_sdf:
        from .maze import sdf_from_occupancy
        n = data["x"].shape[0]
        sdf = sdf_from_occupancy(occ)
        data["sdf"] = np.broadcast_to(
            sdf[None, None], (n, 1, *occ.shape)).astype(np.float32).copy()
    np.savez_compressed(args.out_path, **data)
    print(f"wrote {args.out_path}: " +
          ", ".join(f"{k}{v.shape}" for k, v in data.items()))


if __name__ == "__main__":
    import sys as _sys

    if len(_sys.argv) > 1 and _sys.argv[1] == "unified":
        main_unified(_sys.argv[2:])
    else:
        main()
