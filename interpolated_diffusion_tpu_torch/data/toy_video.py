"""Procedural toy video dataset: moving squares and circles -> tiny RGB latents
(port of data/toy_video.py, a copy: the two datasets are equal bit for bit
at the same seed).

Seeded per-index simulation, align_corners=False bilinear downsample to
latent_size x latent_size x 3 flattened latents, start/goal = the first and
last frame. Pure numpy on the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=False bilinear resize; img [..., H, W]."""
    H, W = img.shape[-2:]
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    top = img[..., y0, :][..., :, x0] * (1 - wx) + img[..., y0, :][..., :, x1] * wx
    bot = img[..., y1, :][..., :, x0] * (1 - wx) + img[..., y1, :][..., :, x1] * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


class MovingShapesVideoDataset:
    """Bouncing squares/circles rendered and downsampled to flat latents."""

    def __init__(
        self,
        T: int = 16,
        H: int = 64,
        W: int | None = None,
        n_samples: int = 100_000,
        seed: int = 0,
        n_objects_range: Tuple[int, int] = (1, 3),
        latent_size: int = 16,
    ):
        self.T = T
        self.H = H
        self.W = W if W is not None else H
        self.n_samples = n_samples
        self.seed = seed
        self.n_objects_range = n_objects_range
        self.latent_size = latent_size
        self.data_dim = 3 * latent_size * latent_size

    def __len__(self) -> int:
        return self.n_samples

    def _render(self, objs, H, W) -> np.ndarray:
        frame = np.zeros((H, W, 3), dtype=np.float32)
        for o in objs:
            x, y, size = o["x"], o["y"], o["size"]
            x0, x1 = max(0, x - size), min(W - 1, x + size)
            y0, y1 = max(0, y - size), min(H - 1, y + size)
            if o["shape"] == "square":
                frame[y0:y1 + 1, x0:x1 + 1] = o["color"]
            else:
                yy, xx = np.ogrid[y0:y1 + 1, x0:x1 + 1]
                m = (xx - x) ** 2 + (yy - y) ** 2 <= size ** 2
                frame[y0:y1 + 1, x0:x1 + 1][m] = o["color"]
        return frame

    def _simulate(self, rng: np.random.RandomState) -> np.ndarray:
        H, W = self.H, self.W
        n_obj = int(rng.randint(self.n_objects_range[0], self.n_objects_range[1] + 1))
        speeds = [s for s in range(-2, 3) if s != 0]
        objs = []
        for _ in range(n_obj):
            size = int(rng.randint(3, 9))
            objs.append({
                "shape": "square" if rng.rand() < 0.5 else "circle",
                "size": size,
                "x": int(rng.randint(size, W - size)),
                "y": int(rng.randint(size, H - size)),
                "vx": int(rng.choice(speeds)),
                "vy": int(rng.choice(speeds)),
                "color": rng.uniform(0.2, 1.0, size=(3,)).astype(np.float32),
            })
        frames = []
        for _ in range(self.T):
            frames.append(self._render(objs, H, W))
            for o in objs:
                x, y = o["x"] + o["vx"], o["y"] + o["vy"]
                if x < o["size"] or x > W - 1 - o["size"]:
                    o["vx"] *= -1
                    x = o["x"] + o["vx"]
                if y < o["size"] or y > H - 1 - o["size"]:
                    o["vy"] *= -1
                    y = o["y"] + o["vy"]
                o["x"], o["y"] = int(x), int(y)
        return np.stack(frames)  # [T,H,W,3]

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + int(idx))
        frames = self._simulate(rng)                        # [T,H,W,3]
        chw = np.transpose(frames, (0, 3, 1, 2))            # [T,3,H,W]
        z = bilinear_resize(chw, self.latent_size, self.latent_size)
        z_flat = z.reshape(self.T, -1).astype(np.float32)
        return {
            "x": z_flat,
            "start_goal": np.concatenate([z_flat[0], z_flat[-1]]).astype(np.float32),
        }

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        rows = [self.get(int(i)) for i in np.asarray(indices)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def infer_latent_size(D: int) -> int:
    size = int(round((D / 3) ** 0.5))
    if 3 * size * size != D:
        raise ValueError(f"Cannot infer latent size from D={D}")
    return size


def decode_latents(z_flat: np.ndarray, out_size: int = 64) -> np.ndarray:
    """Flattened latents back to RGB frames for visualization."""
    single = z_flat.ndim == 2
    if single:
        z_flat = z_flat[None]
    B, T, D = z_flat.shape
    size = infer_latent_size(D)
    z = z_flat.reshape(B * T, 3, size, size)
    x = bilinear_resize(z, out_size, out_size).reshape(B, T, 3, out_size, out_size)
    return x[0] if single else x
