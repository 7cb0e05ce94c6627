"""Host-side datasets and the batch loader feeding the train steps (own copy
of the JAX package's data/dataset.py; numpy only): ParticleMazeDataset
(procedural mazes and paths, generated per seeded shard, with an npz shard
cache), PreparedTrajectoryDataset (npz-backed prepared data) and BatchLoader.
Shards come from the C++ generator (data/native.py, the port's copy of
native/maze_gen.cpp) unless `use_native="never"` or SDFs are asked for, as in
the JAX package; either generator gives the JAX package's samples bit for bit
under the same flags.
"""
from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from .maze import generate_maze, sdf_from_occupancy
from .trajectories import path_to_trajectory



def _cell_to_xy(cell, h: int, w: int) -> np.ndarray:
    return np.array([(cell[1] + 0.5) / w, (cell[0] + 0.5) / h], dtype=np.float32)


class ParticleMazeDataset:
    """Procedural maze trajectories with per-shard seeded generation + caching."""

    def __init__(
        self,
        num_samples: int = 100_000,
        h: int = 21,
        w: int = 21,
        T: int = 64,
        p_wall_min: float = 0.15,
        p_wall_max: float = 0.30,
        with_velocity: bool = False,
        use_sdf: bool = False,
        cache_dir: Optional[str] = None,
        shard_size: int = 10_000,
        seed: int = 123,
        use_native: str = "auto",  # auto | always | never
    ):
        self.num_samples = num_samples
        self.h, self.w, self.T = h, w, T
        self.p_wall_min, self.p_wall_max = p_wall_min, p_wall_max
        self.with_velocity = with_velocity
        self.use_sdf = use_sdf
        self.cache_dir = cache_dir
        self.shard_size = shard_size
        self.seed = seed
        self.use_native = use_native
        self.data_dim = 4 if with_velocity else 2
        self._shard_cache: "collections.OrderedDict[int, Dict[str, np.ndarray]]" = (
            collections.OrderedDict()
        )
        self._shard_cache_cap = 4
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)

    def __len__(self) -> int:
        return self.num_samples

    # -- shard machinery -----------------------------------------------------
    def _shard_path(self, shard_idx: int) -> str:
        return os.path.join(self.cache_dir, f"shard_{shard_idx:05d}.npz")

    def _generate_sample(self, rng: np.random.RandomState):
        p_wall = rng.uniform(self.p_wall_min, self.p_wall_max)
        occ, start, goal, path = generate_maze(rng, self.h, self.w, p_wall=p_wall)
        x = path_to_trajectory(path, self.h, self.w, self.T, with_velocity=self.with_velocity)
        sdf = sdf_from_occupancy(occ).astype(np.float32) if self.use_sdf else None
        sg = np.concatenate(
            [_cell_to_xy(start, self.h, self.w), _cell_to_xy(goal, self.h, self.w)]
        ).astype(np.float32)
        return x, occ.astype(np.float32), sdf, sg

    def _build_shard(self, shard_idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + shard_idx)
        lo = shard_idx * self.shard_size
        hi = min(self.num_samples, lo + self.shard_size)
        n = hi - lo
        # C++ hot path (csrc/host/maze_gen.cpp) unless SDFs are needed or it
        # is turned off: "auto" falls back to numpy when the library does not
        # build, "always" raises then
        if self.use_native != "never" and not self.use_sdf:
            try:
                from .native import generate_maze_batch_native

                x, occ, sg = generate_maze_batch_native(
                    self.seed * 1_000_003 + shard_idx * self.shard_size,
                    n, self.h, self.w, self.p_wall_min, self.p_wall_max,
                    self.T, self.with_velocity,
                )
                return {"x": x, "occ": occ, "start_goal": sg}
            except Exception:
                if self.use_native == "always":
                    raise
        x = np.zeros((n, self.T, self.data_dim), dtype=np.float32)
        occ = np.zeros((n, 1, self.h, self.w), dtype=np.float32)
        sdf = np.zeros((n, 1, self.h, self.w), dtype=np.float32) if self.use_sdf else None
        sg = np.zeros((n, 4), dtype=np.float32)
        for i in range(n):
            xi, occi, sdfi, sgi = self._generate_sample(rng)
            x[i], occ[i, 0], sg[i] = xi, occi, sgi
            if sdf is not None:
                sdf[i, 0] = sdfi
        data = {"x": x, "occ": occ, "start_goal": sg}
        if sdf is not None:
            data["sdf"] = sdf
        return data

    def _load_shard(self, shard_idx: int) -> Dict[str, np.ndarray]:
        if shard_idx in self._shard_cache:
            self._shard_cache.move_to_end(shard_idx)
            return self._shard_cache[shard_idx]
        if self.cache_dir is not None:
            path = self._shard_path(shard_idx)
            if os.path.exists(path):
                with np.load(path) as f:
                    data = {k: f[k] for k in f.files}
            else:
                data = self._build_shard(shard_idx)
                np.savez_compressed(path, **data)
        else:
            data = self._build_shard(shard_idx)
        self._shard_cache[shard_idx] = data
        if len(self._shard_cache) > self._shard_cache_cap:
            self._shard_cache.popitem(last=False)
        return data

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        data = self._load_shard(idx // self.shard_size)
        off = idx % self.shard_size
        out = {
            "x": data["x"][off],
            "occ": data["occ"][off],
            "start_goal": data["start_goal"][off],
        }
        if "sdf" in data:
            out["sdf"] = data["sdf"][off]
        return out

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Dense batch gather, grouped by shard (each shard loaded once)."""
        indices = np.asarray(indices)
        shards = indices // self.shard_size
        first = self._load_shard(int(shards[0]))
        n = len(indices)
        batch = {k: np.empty((n, *v.shape[1:]), dtype=v.dtype)
                 for k, v in first.items()}
        for sid in np.unique(shards):
            data = self._load_shard(int(sid))
            rows = np.where(shards == sid)[0]
            offs = indices[rows] % self.shard_size
            for k in batch:
                batch[k][rows] = data[k][offs]
        return batch


class PreparedTrajectoryDataset:
    """npz-backed prepared dataset (x, occ?, sdf?, start_goal, kp_idx?,
    kp_feat?, kp_mask_levels?, difficulty?)."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as f:
            self.arrays = {k: f[k] for k in f.files}
        if "x" not in self.arrays:
            raise ValueError(f"prepared dataset {path} missing 'x'")
        self.num_samples = self.arrays["x"].shape[0]
        self.T = self.arrays["x"].shape[1]
        self.data_dim = self.arrays["x"].shape[2]

    def __len__(self) -> int:
        return self.num_samples

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        indices = np.asarray(indices)
        return {k: v[indices] for k, v in self.arrays.items()}


class BatchLoader:
    """Seeded random-batch iterator with optional background prefetch.

    One host thread assembles dense numpy batches ahead of the train loop,
    so that the next batch is built while the device computes.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        prefetch: int = 2,
        drop_last: bool = True,
        start_batch: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.start_batch = int(start_batch)
        self.batches_drawn = self.start_batch   # checkpointable position

    @property
    def state(self):
        """JSON-able resume marker; pass back as start_batch."""
        return {"batches": self.batches_drawn}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        n = len(self.dataset)
        # fast-forward: replay only the index draws, not the batch builds.
        # Each __iter__ restarts the rng from start_batch, so the position
        # marker must restart with it (a second iter() otherwise desyncs
        # .state from the actual stream position)
        self.batches_drawn = self.start_batch
        for _ in range(self.start_batch):
            rng.randint(0, n, size=self.batch_size)

        def gen():
            while True:
                idx = rng.randint(0, n, size=self.batch_size)
                self.batches_drawn += 1
                yield self.dataset.get_batch(idx)

        if self.prefetch <= 0:
            yield from gen()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            for batch in gen():
                if stop.is_set():
                    return
                q.put(batch)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
