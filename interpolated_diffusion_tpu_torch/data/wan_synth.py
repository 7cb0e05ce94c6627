"""Wan-synth video-latent data pipeline (own copy of the JAX package's
data/wan_synth.py; numpy and tarfile only).

Tar-shard streaming with shard shuffle and per-process shard assignment,
field decode, [C,T,H,W] -> [T,C,H,W] auto-transpose, dict collation, and
key-join streams for precomputed anchors and teacher outputs with the
bounded-buffer ordering guard. Shards are plain .tar files of
`{key}.{field}.npy` members read with the stdlib tarfile; a synthetic
generator provides the same sample contract (latents [T,16,H,W] + text_embed
[L,4096], the Wan2.1 dataset shapes). `split_by_process` takes this
process's rank and the world size from torch.distributed when a process
group is up (one process per GPU under torchrun), as the JAX package takes
jax.process_index(). The native tar reader is not ported.
"""
from __future__ import annotations

import io
import os
import tarfile
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def _maybe_transpose_latents(lat: np.ndarray, T_expect: Optional[int] = None) -> np.ndarray:
    """Fix [C,T,H,W] vs [T,C,H,W] mixups : the time axis is
    the longer of the first two dims unless T_expect says otherwise."""
    if lat.ndim != 4:
        raise ValueError(f"latents must be 4D, got {lat.shape}")
    d0, d1 = lat.shape[:2]
    if T_expect is not None:
        if d0 == T_expect:
            return lat
        if d1 == T_expect:
            return np.swapaxes(lat, 0, 1)
    if d1 > d0:  # [C,T,...] with T > C
        return np.swapaxes(lat, 0, 1)
    return lat


def list_shards(root: str, pattern: str = ".tar") -> List[str]:
    shards = sorted(
        os.path.join(root, f) for f in os.listdir(root) if f.endswith(pattern)
    )
    if not shards:
        raise FileNotFoundError(f"no {pattern} shards under {root}")
    return shards


def split_by_process(shards: Sequence[str], process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> List[str]:
    """Deterministic per-process shard assignment: shard i goes to process
    i % process_count; by default this process's rank among the processes of
    the run (torch.distributed), one process without a process group."""
    if process_index is None or process_count is None:
        from ..parallel.multihost import process_count as count, process_index as index

        process_index, process_count = index(), count()
    return [s for i, s in enumerate(shards) if i % process_count == process_index]


def iter_tar_samples(path: str) -> Iterator[Dict[str, np.ndarray]]:
    """Yield {field: array} dicts grouped by sample key from one tar shard."""
    current_key: Optional[str] = None
    sample: Dict[str, np.ndarray] = {}
    with tarfile.open(path, "r") as tf:
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            parts = base.split(".")
            if len(parts) < 3 or parts[-1] != "npy":
                continue
            key = ".".join(parts[:-2])
            field = parts[-2]
            if current_key is not None and key != current_key:
                if sample:
                    yield {"__key__": current_key, **sample}
                sample = {}
            current_key = key
            buf = tf.extractfile(member).read()
            sample[field] = np.load(io.BytesIO(buf), allow_pickle=False)
        if current_key is not None and sample:
            yield {"__key__": current_key, **sample}


class KeyJoinError(RuntimeError):
    pass


def key_join(
    primary: Iterator[Dict], secondary: Iterator[Dict],
    fields: Sequence[str], prefix: str = "", max_buffer: int = 64,
) -> Iterator[Dict]:
    """Join two keyed streams; raises if keys drift apart beyond max_buffer
    (the ordering-consistency guard)."""
    buf: Dict[str, Dict] = {}
    sec_iter = iter(secondary)
    for item in primary:
        key = item["__key__"]
        while key not in buf:
            try:
                s = next(sec_iter)
            except StopIteration:
                raise KeyJoinError(f"secondary stream ended before key {key!r}")
            buf[s["__key__"]] = s
            if len(buf) > max_buffer:
                raise KeyJoinError(
                    f"key-join buffer overflow (> {max_buffer}); shards misordered"
                )
        s = buf.pop(key)
        out = dict(item)
        for f in fields:
            if f in s:
                out[prefix + f] = s[f]
        yield out


class WanSynthTarDataset:
    """Streaming tar-shard dataset with optional anchor/teacher key-joins."""

    def __init__(
        self,
        root: str,
        T: int = 21,
        shuffle_shards: bool = True,
        shuffle_buffer: int = 64,
        seed: int = 0,
        anchors_root: Optional[str] = None,
        teacher_root: Optional[str] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.shards = split_by_process(list_shards(root), process_index, process_count)
        self.T = T
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.anchors_root = anchors_root
        self.teacher_root = teacher_root

    def _stream(self, shards: Sequence[str]) -> Iterator[Dict]:
        for sh in shards:
            stream = iter_tar_samples(sh)
            if self.anchors_root:
                a_path = os.path.join(self.anchors_root, os.path.basename(sh))
                stream = key_join(
                    stream, iter_tar_samples(a_path),
                    fields=("anchors", "anchor_idx"), prefix="",
                )
            if self.teacher_root:
                t_path = os.path.join(self.teacher_root, os.path.basename(sh))
                stream = key_join(
                    stream, iter_tar_samples(t_path),
                    fields=("teacher_latents",), prefix="",
                )
            yield from stream

    def epoch_iter(self, epoch: int = 0,
                   skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One deterministic epoch: shard order and shuffle-buffer draws are
        fully determined by (seed, epoch) — epochs reshuffle, and a resumed
        run replays the identical emission order. `skip` consumes and
        discards the first `skip` EMITTED samples (exact mid-epoch resume:
        decode-only fast-forward, no model work)."""
        rng = np.random.RandomState(self.seed + epoch)
        shards = list(self.shards)
        if self.shuffle_shards:
            rng.shuffle(shards)

        def emit():
            buf: List[Dict] = []
            for sample in self._stream(shards):
                if "latents" in sample:
                    sample["latents"] = _maybe_transpose_latents(
                        np.asarray(sample["latents"]), self.T
                    )
                if self.shuffle_buffer <= 1:
                    yield sample
                    continue
                buf.append(sample)
                if len(buf) >= self.shuffle_buffer:
                    i = rng.randint(len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        it = emit()
        for _ in range(skip):
            try:
                next(it)
            except StopIteration:
                return
        yield from it

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.epoch_iter(0)

    def batches(self, batch_size: int,
                state: Optional[Dict] = None) -> "_TarBatchIterator":
        """Infinite batch iterator with checkpointable position.

        `iterator.state` is a JSON-able {"epoch", "offset"} marker; passing
        it back as `state` resumes the stream exactly where it left off
        (same emission order — epoch_iter is deterministic). Tail samples
        that don't fill a batch are dropped at each epoch boundary so the
        offset marker always lands on a batch edge."""
        return _TarBatchIterator(self, batch_size, state)


class _TarBatchIterator:
    def __init__(self, ds: "WanSynthTarDataset", batch_size: int,
                 state: Optional[Dict] = None):
        self.ds, self.batch_size = ds, batch_size
        st = state or {}
        self.epoch = int(st.get("epoch", 0))
        self.offset = int(st.get("offset", 0))   # samples consumed in epoch
        self._gen = self._run()

    @property
    def state(self) -> Dict[str, int]:
        """Position of the NEXT batch (safe to store in checkpoint meta)."""
        return {"epoch": self.epoch, "offset": self.offset}

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return next(self._gen)

    def _run(self):
        while True:
            items: List[Dict] = []
            seen = self.offset
            for sample in self.ds.epoch_iter(self.epoch, skip=self.offset):
                seen += 1
                items.append(sample)
                if len(items) == self.batch_size:
                    out = {
                        k: np.stack([it[k] for it in items])
                        for k in items[0]
                        if k != "__key__" and isinstance(items[0][k], np.ndarray)
                        and items[0][k].dtype != object
                    }
                    # plain-list passthrough for sample triage (diagnostics);
                    # consumers copy to the device by explicit array key
                    out["__keys__"] = [str(it.get("__key__", ""))
                                       for it in items]
                    self.offset += self.batch_size
                    yield out
                    items = []
            # epoch exhausted: drop the partial tail, advance deterministically
            if self.offset == 0 and seen < self.batch_size:
                raise ValueError(
                    f"dataset yields only {seen} samples per epoch — smaller "
                    f"than one batch ({self.batch_size}); shrink the batch "
                    "or add shards")
            self.epoch += 1
            self.offset = 0


class SyntheticWanDataset:
    """Seeded synthetic Wan-shaped samples: smooth random latents + text embeds.

    Latents are temporally-smooth (low-rank time interpolation of noise) so
    interpolation-corruption training signals are meaningful in tests.
    """

    def __init__(self, n_samples: int = 1000, T: int = 21, C: int = 16,
                 H: int = 60, W: int = 104, text_len: int = 512,
                 text_dim: int = 4096, seed: int = 0, n_keyframes: int = 5):
        self.n_samples = n_samples
        self.T, self.C, self.H, self.W = T, C, H, W
        self.text_len, self.text_dim = text_len, text_dim
        self.seed = seed
        self.n_keyframes = max(2, n_keyframes)

    def __len__(self):
        return self.n_samples

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + int(idx))
        kf = rng.randn(self.n_keyframes, self.C, self.H, self.W).astype(np.float32)
        ts = np.linspace(0, self.n_keyframes - 1, self.T)
        lo = np.clip(np.floor(ts).astype(int), 0, self.n_keyframes - 2)
        w = (ts - lo)[:, None, None, None].astype(np.float32)
        lat = kf[lo] * (1 - w) + kf[lo + 1] * w
        text = rng.randn(self.text_len, self.text_dim).astype(np.float32) * 0.02
        return {"latents": lat, "text_embed": text}

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        rows = [self.get(int(i)) for i in np.asarray(indices)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def write_tar_shard(path: str, samples: Sequence[Dict[str, np.ndarray]]) -> None:
    """Write samples as `{key}.{field}.npy` tar members (prep-tool output)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i, sample in enumerate(samples):
            key = sample.get("__key__", f"{i:08d}")
            for field, arr in sample.items():
                if field == "__key__":
                    continue
                buf = io.BytesIO()
                np.save(buf, np.asarray(arr))
                data = buf.getvalue()
                info = tarfile.TarInfo(name=f"{key}.{field}.npy")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
