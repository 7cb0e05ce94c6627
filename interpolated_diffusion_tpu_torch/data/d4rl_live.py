"""Live gym/d4rl episode export: the optional adapter onto the gym stack (own
copy of the JAX package's data/d4rl_live.py).

This module is the only one that imports gym / d4rl, lazily, inside `main`;
without them it refuses with the JAX module's message. It exports
`get_dataset()` episodes (and the env's maze map and MuJoCo wall polygons)
into the npz layout that data/d4rl.py (`main`, `build_unified`) reads.
`extract_maze_map` walks the env's attributes (get_maze_map() / maze_arr /
maze_map / maze / str_maze_spec / maze_spec; string specs parsed to the
10/11/12 encoding); `export_episodes` takes observations, terminals (or
dones) and timeouts. Both are plain numpy over whatever env / dataset
objects they are handed.

Run on a machine with gym + d4rl:
  python -m interpolated_diffusion_tpu_torch.data.d4rl_live \
      --env_id maze2d-medium-v1 --out_path ep_medium.npz
then `python -m interpolated_diffusion_tpu_torch.data.d4rl --episodes
ep_medium.npz ...` anywhere.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from .d4rl import parse_maze_spec
from .mujoco_walls import walls_from_env


def extract_maze_map(env) -> Optional[np.ndarray]:
    """Walk the env for its maze layout, normalized to the d4rl int encoding
    (10 = wall, 11 = free, 12 = goal). Mirrors reference dataset.py:58-73."""
    for obj in (env, getattr(env, "unwrapped", env)):
        if obj is None:
            continue
        if hasattr(obj, "get_maze_map"):
            maze_map = obj.get_maze_map()
            if maze_map is not None:
                return np.asarray(maze_map)
        for attr in ("maze_arr", "maze_map", "maze", "str_maze_spec", "maze_spec"):
            if hasattr(obj, attr):
                maze_map = getattr(obj, attr)
                if hasattr(maze_map, "maze_map"):
                    maze_map = maze_map.maze_map
                if isinstance(maze_map, str):
                    return parse_maze_spec(maze_map)
                if maze_map is not None:
                    return np.asarray(maze_map)
    return None


def export_episodes(env, dataset: Optional[dict] = None) -> dict:
    """Pull episodes + env geometry into the prepare-path npz layout.

    `dataset` defaults to env.get_dataset(); terminals falls back to `dones`
    (reference dataset.py:412-416). Returns plain-numpy arrays only."""
    if dataset is None:
        dataset = env.get_dataset()
    obs = np.asarray(dataset["observations"], np.float32)
    terminals = dataset.get("terminals")
    if terminals is None:
        terminals = dataset.get("dones")
    terminals = (np.asarray(terminals, bool) if terminals is not None
                 else np.zeros(len(obs), bool))
    out = {"observations": obs, "terminals": terminals}
    timeouts = dataset.get("timeouts")
    if timeouts is not None:
        out["timeouts"] = np.asarray(timeouts, bool)
    maze_map = extract_maze_map(env)
    if maze_map is not None:
        out["maze_map"] = np.asarray(maze_map)
    walls = walls_from_env(env)
    if walls:
        out["mj_walls"] = np.stack(walls).astype(np.float32)  # [N, 4, 2]
    scaling = None
    for obj in (env, getattr(env, "unwrapped", env)):
        scaling = getattr(obj, "maze_size_scaling",
                          getattr(obj, "maze_size_scale", None))
        if scaling is not None:
            break
    if scaling is not None:
        out["maze_size_scaling"] = np.float32(scaling)
    return out


def main(argv=None):
    p = argparse.ArgumentParser("d4rl_live export (requires gym + d4rl)")
    p.add_argument("--env_id", type=str, default="maze2d-medium-v1")
    p.add_argument("--out_path", type=str, required=True)
    args = p.parse_args(argv)
    try:
        import gym  # noqa: F401
        import d4rl  # noqa: F401  (registers maze2d envs)
    except ImportError as e:
        raise SystemExit(
            f"gym/d4rl unavailable ({e}); run this exporter on a machine with "
            "the D4RL stack, then move the npz here — every downstream stage "
            "(prepare, DP annotation, training) is gym-free"
        )
    env = gym.make(args.env_id)
    out = export_episodes(env)
    np.savez_compressed(args.out_path, **out)
    print(f"wrote {args.out_path}: " +
          ", ".join(f"{k}{np.asarray(v).shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
