"""DiDeMo / LSMDC caption + clip datasets and their precomputed caches (port
of data/didemo.py, a copy: numpy on the host, no accelerator).

DiDeMo JSON annotation parsing with the most common annotator window
(5-second segments), LSMDC tab-separated annotations with HH.MM.SS.mmm
timecodes, clip-window strategies (center, random), `RawClipDataset` whose
decode failures move on to the next annotation, and the latent + text
caches the trainers read: `write_clip_cache` writes npz shards and an
index.json that `CachedClipDataset` serves.

Raw video decode is host-side and optional: OpenCV when importable, else
imageio with pyav, else ImportError (use a precomputed cache).
"""
from __future__ import annotations

import csv
import json
import os
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# annotation parsing
# ---------------------------------------------------------------------------

def mode_time_pair(times: List[List[int]]) -> Tuple[int, int]:
    """Most-common (start, end) annotation pair (DiDeMo mode-of-annotators)."""
    pairs = [tuple(t) for t in times]
    if not pairs:
        return 0, 0
    (start, end), _ = Counter(pairs).most_common(1)[0]
    return int(start), int(end)


def parse_timecode(ts: str) -> float:
    """LSMDC 'HH.MM.SS.mmm' → seconds."""
    parts = ts.strip().split(".")
    if len(parts) != 4:
        raise ValueError(f"Invalid timecode: {ts}")
    h, m, s, ms = (int(p) for p in parts)
    return h * 3600 + m * 60 + s + ms / 1000.0


def clip_window(
    start_sec: float, end_sec: float, clip_seconds: Optional[float],
    rng: np.random.RandomState, strategy: str = "center",
) -> Tuple[float, float]:
    if clip_seconds is None:
        return start_sec, end_sec
    seg = max(0.0, end_sec - start_sec)
    if clip_seconds >= seg or seg == 0.0:
        return start_sec, end_sec
    off = (rng.uniform(0.0, seg - clip_seconds) if strategy == "random"
           else 0.5 * (seg - clip_seconds))
    return start_sec + off, start_sec + off + clip_seconds


def load_didemo_annotations(
    data_dir: str, split: str, single_segment_only: bool = True
) -> List[Dict]:
    """DiDeMo {split}_data.json → [{video, caption, start_sec, end_sec}].

    DiDeMo times index 5-second segments; mode-of-annotators picks the window.
    """
    path = os.path.join(data_dir, f"{split}_data.json")
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    out = []
    for item in raw:
        times = item.get("times", [])
        start_seg, end_seg = mode_time_pair(times)
        if single_segment_only and end_seg != start_seg:
            continue
        out.append({
            "video": item["video"],
            "caption": item.get("description", ""),
            "start_sec": 5.0 * start_seg,
            "end_sec": 5.0 * (end_seg + 1),
        })
    return out


def load_lsmdc_annotations(csv_path: str) -> List[Dict]:
    """LSMDC tab-separated annotation file → [{video, caption, start, end}]."""
    out = []
    with open(csv_path, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) < 6:
                continue
            clip_id = row[0]
            try:
                start = parse_timecode(row[2])
                end = parse_timecode(row[3])
            except ValueError:
                continue
            out.append({"video": clip_id, "caption": row[5],
                        "start_sec": start, "end_sec": end})
    return out


# ---------------------------------------------------------------------------
# precomputed latent caches (the training path)
# ---------------------------------------------------------------------------

class CachedClipDataset:
    """Shard-cached clips: {cache_dir}/{split}/index.json + npz shards with
    `latents` [n, T, ...] and `text_embed` [n, L, D] arrays (one shard
    held in memory at a time)."""

    def __init__(self, cache_dir: str, split: str = "train"):
        self.cache_dir = cache_dir
        self.split = split
        index_path = os.path.join(cache_dir, split, "index.json")
        with open(index_path, encoding="utf-8") as f:
            index = json.load(f)
        self.shards = index["shards"]
        self.total = int(index["total"])
        self._cum = np.cumsum([int(s["count"]) for s in self.shards])
        self._cached_id: Optional[int] = None
        self._cached: Optional[Dict[str, np.ndarray]] = None

    def __len__(self) -> int:
        return self.total

    def _shard_for(self, idx: int) -> Tuple[int, int]:
        sid = int(np.searchsorted(self._cum, idx, side="right"))
        prev = 0 if sid == 0 else int(self._cum[sid - 1])
        return sid, idx - prev

    def _load(self, sid: int) -> Dict[str, np.ndarray]:
        if self._cached_id == sid:
            return self._cached
        path = self.shards[sid]["path"]
        if not os.path.isabs(path):
            path = os.path.join(self.cache_dir, self.split, path)
        with np.load(path) as f:
            self._cached = {k: f[k] for k in f.files}
        self._cached_id = sid
        return self._cached

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        sid, off = self._shard_for(int(idx))
        data = self._load(sid)
        return {k: v[off] for k, v in data.items()}

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        rows = [self.get(i) for i in np.asarray(indices)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def write_clip_cache(
    cache_dir: str, split: str, samples: List[Dict[str, np.ndarray]],
    shard_size: int = 256,
) -> None:
    """Write npz shards + index.json in the CachedClipDataset layout."""
    out_dir = os.path.join(cache_dir, split)
    os.makedirs(out_dir, exist_ok=True)
    shards = []
    for sid in range(0, len(samples), shard_size):
        chunk = samples[sid:sid + shard_size]
        name = f"shard_{sid // shard_size:05d}.npz"
        arrays = {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
        np.savez_compressed(os.path.join(out_dir, name), **arrays)
        shards.append({"path": name, "count": len(chunk)})
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({"shards": shards, "total": len(samples)}, f, indent=2)


class RawClipDataset:
    """Annotation-driven raw-clip reader with decode-failure retry: a
    missing file or a decode error moves on to the next annotation
    (wrapping) up to `max_retries` times instead of ending a long prep run,
    since video corpora always hold some corrupt or missing clips. Host-side
    only (cache building; training reads CachedClipDataset)."""

    def __init__(self, annotations: List[Dict], video_dir: str, T: int,
                 frame_size: int = 64, clip_seconds: Optional[float] = None,
                 clip_strategy: str = "center", max_retries: int = 10,
                 seed: int = 0):
        if not annotations:
            raise ValueError("RawClipDataset needs at least one annotation")
        self.items = annotations
        self.video_dir = video_dir
        self.T = T
        self.frame_size = frame_size
        self.clip_seconds = clip_seconds
        self.clip_strategy = clip_strategy
        self.max_retries = max_retries
        self.seed = seed

    def __len__(self) -> int:
        return len(self.items)

    def _resolve(self, video: str) -> Optional[str]:
        cands = [video, f"{video}.mp4", f"{video}.avi", f"{video}.mkv",
                 f"{video}.webm", f"{video}.mov"]
        for c in cands:
            path = os.path.join(self.video_dir, c)
            if os.path.isfile(path):
                return path
        return None

    def get(self, idx: int) -> Dict:
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            item = self.items[(idx + attempt) % len(self.items)]
            path = self._resolve(str(item["video"]))
            if path is None:
                continue
            rng = np.random.RandomState(self.seed + idx + attempt)
            start, end = clip_window(float(item["start_sec"]),
                                     float(item["end_sec"]),
                                     self.clip_seconds, rng,
                                     self.clip_strategy)
            try:
                frames = read_video_clip(path, start, end, self.T,
                                         self.frame_size)
            except ImportError:
                raise   # no decoder at all — retrying can't help
            except Exception as e:   # corrupt clip: try the next item
                last_err = e
                continue
            return {"frames": frames, "text": str(item.get("caption", "")),
                    "video": str(item["video"]),
                    "start_sec": start, "end_sec": end}
        raise RuntimeError(
            f"no decodable clip within {self.max_retries} attempts starting "
            f"at annotation {idx}" + (f" (last error: {last_err})"
                                      if last_err else "")
        )


# ---------------------------------------------------------------------------
# raw video decode (host-side, optional)
# ---------------------------------------------------------------------------

def _crop_resize(clip: np.ndarray, frame_size: int) -> np.ndarray:
    """[T,H,W,3] float frames → center-crop square → [T,3,S,S]."""
    h, w = clip.shape[1:3]
    side = min(h, w)
    y0, x0 = (h - side) // 2, (w - side) // 2
    clip = clip[:, y0:y0 + side, x0:x0 + side]
    from .toy_video import bilinear_resize

    chw = np.transpose(clip, (0, 3, 1, 2))
    return bilinear_resize(chw, frame_size, frame_size).astype(np.float32)


def _read_clip_cv2(path: str, start_sec: float, end_sec: float, T: int,
                   frame_size: int) -> np.ndarray:
    """OpenCV VideoCapture decode: one seek to the window start, then a
    sequential read keeping the T selected frames (frame-accurate, unlike
    repeated random seeks)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        cap.release()
        raise IOError(f"cv2 cannot open {path}")
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 25.0
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n <= 0:
            raise IOError(f"cv2 reports no frames for {path}")
        lo = min(max(int(start_sec * fps), 0), n - 1)
        hi = min(max(int(end_sec * fps), lo + 1), n)
        sel = np.linspace(lo, hi - 1, T).round().astype(int)
        sel_set = set(sel.tolist())
        wanted = {}
        cap.set(cv2.CAP_PROP_POS_FRAMES, lo)
        for fi in range(lo, hi):
            ok, frame = cap.read()
            if not ok:
                break
            if fi in sel_set:
                wanted[fi] = frame[:, :, ::-1]  # BGR → RGB
        if not wanted:
            raise IOError(f"decoded no frames in [{lo}, {hi}) from {path}")
        keys = sorted(wanted)
        frames = [wanted[fi] if fi in wanted
                  else wanted[min(keys, key=lambda k: abs(k - fi))]
                  for fi in sel]
    finally:
        cap.release()
    clip = np.stack(frames).astype(np.float32) / 255.0
    return _crop_resize(clip, frame_size)


def read_video_clip(
    path: str, start_sec: float, end_sec: float, T: int, frame_size: int,
) -> np.ndarray:
    """Decode T center-cropped frames [T, 3, S, S] in [0, 1] from [start,
    end] seconds: OpenCV's decoder, else imageio (+pyav), else ImportError.
    Raw decode happens at cache-building time, never on the training path."""
    cv2_err = None
    try:
        return _read_clip_cv2(path, start_sec, end_sec, T, frame_size)
    except Exception as e:  # not just ImportError: a container cv2's build
        cv2_err = e          # can't open may still decode via imageio+pyav
    try:
        import imageio.v3 as iio
    except ImportError:
        raise (cv2_err if not isinstance(cv2_err, ImportError) else
               ImportError("raw video decode needs cv2 or imageio; "
                           "use precomputed caches"))
    frames = iio.imread(path, plugin="pyav")  # [N,H,W,3]
    n = frames.shape[0]
    # assume constant fps over the container metadata window
    meta = iio.immeta(path, plugin="pyav")
    fps = float(meta.get("fps", 25.0))
    lo = min(max(int(start_sec * fps), 0), n - 1)
    hi = min(max(int(end_sec * fps), lo + 1), n)
    sel = np.linspace(lo, hi - 1, T).round().astype(int)
    clip = frames[sel].astype(np.float32) / 255.0
    return _crop_resize(clip, frame_size)
