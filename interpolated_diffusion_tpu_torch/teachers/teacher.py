"""Teachers for interpolator distillation (port of teachers/teacher.py).

A teacher produces mid-frame targets that the interpolator students distil
from; it runs at preparation time only, and its outputs are written into
teacher tar shards (`{key}.teacher_latents`) that
data/wan_synth.WanSynthTarDataset(teacher_root=...) joins back by key.

`LerpTeacher` is the trivial teacher (the pipeline's smoke baseline);
`ModelTeacher` a trained flow_interpolator or sinkhorn_interp checkpoint of
either package; `PrecomputedTeacher` streams written shards back.
`precompute_teacher_shards` writes them, shard for shard under the source
shards' basenames (the join depends on it).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class LerpTeacher:
    """Trivial teacher: the mid-frame is the lerp of the endpoint latents."""

    def interpolate(self, z0: np.ndarray, z1: np.ndarray, alpha: float = 0.5) -> np.ndarray:
        return (1.0 - alpha) * z0 + alpha * z1


class ModelTeacher:
    """A trained interpolator checkpoint as the teacher (meta["stage"]
    flow_interpolator or sinkhorn_interp), with LerpTeacher's
    `interpolate(z0, z1, alpha)`. A Sinkhorn checkpoint interpolates pairwise
    on an (alpha_steps + 1)-frame grid: anchors at 0 and alpha_steps, the
    output the frame at round(alpha * alpha_steps). f32, on `device`."""

    def __init__(self, ckpt: str, alpha_steps: int = 2, device="cuda"):
        from ..models.loading import load_flow_interpolator, load_sinkhorn_interp, resolve_ckpt
        from ..utils.checkpoint import read_meta

        self.device = torch.device(device)
        self._alpha_steps = int(alpha_steps)
        path = resolve_ckpt(ckpt)
        stage = read_meta(path)[1].get("stage")
        if stage == "flow_interpolator":
            self.model, meta = load_flow_interpolator(path, device=self.device)
        elif stage == "sinkhorn_interp":
            self.model, meta = load_sinkhorn_interp(path, device=self.device)
        else:
            raise ValueError(f"checkpoint stage {stage!r} is not an interpolator "
                             "(expected flow_interpolator or sinkhorn_interp)")
        self.stage, self.in_channels = stage, int(meta["in_channels"])

    @torch.no_grad()
    def _pair(self, z0: torch.Tensor, z1: torch.Tensor, alpha: torch.Tensor,
              gap: torch.Tensor) -> torch.Tensor:
        if self.stage == "flow_interpolator":
            z, _ = self.model.interpolate_pair(z0, z1, alpha,
                                               gap=gap if self.model.gap_cond else None)
            return z
        n, B = self._alpha_steps, z0.shape[0]
        lat = torch.zeros((B, n + 1, *z0.shape[1:]), dtype=z0.dtype, device=z0.device)
        lat[:, 0], lat[:, n] = z0, z1
        idx = torch.tensor([0, n], device=z0.device).expand(B, 2)
        out, _ = self.model(lat, idx)
        return out[:, int(torch.round(alpha[0] * n).clamp(0, n))]

    def interpolate(self, z0: np.ndarray, z1: np.ndarray, alpha: float = 0.5,
                    gap: float = 2.0) -> np.ndarray:
        """[C, H, W] or [B, C, H, W] endpoint latents -> the frame at alpha."""
        z0a, z1a = np.asarray(z0, np.float32), np.asarray(z1, np.float32)
        squeeze = z0a.ndim == 3
        if squeeze:
            z0a, z1a = z0a[None], z1a[None]
        B = z0a.shape[0]
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        full = lambda v: torch.full((B,), v, dtype=torch.float32, device=self.device)
        out = self._pair(put(z0a), put(z1a), full(alpha), full(gap)).float().cpu().numpy()
        return out[0] if squeeze else out


class PrecomputedTeacher:
    """Streams the teacher mid-frame latents joined to the data by key."""

    def __init__(self, teacher_root: str):
        self.teacher_root = teacher_root

    def stream(self, data_root: str, T: int) -> Iterator[Dict[str, np.ndarray]]:
        from ..data.wan_synth import WanSynthTarDataset

        yield from WanSynthTarDataset(data_root, T=T, shuffle_shards=False, shuffle_buffer=1,
                                      teacher_root=self.teacher_root)


def precompute_teacher_shards(data_root: str, out_root: str, T: int,
                              teacher: Optional[object] = None, shard_size: int = 64) -> int:
    """Write `{key}.teacher_latents` ([ceil((T-1)/2), C, H, W] f32: the
    teacher's mid-frames between frames t and min(t + 2, T - 1), t = 0, 2,
    ...) for every clip, under the source shards' basenames; returns the
    clip count. `shard_size` is implied by the source sharding (kept for the
    JAX signature). A clip's pairs go to the teacher in one call."""
    from ..data.wan_synth import (_maybe_transpose_latents, iter_tar_samples, list_shards,
                                  write_tar_shard)

    teacher = teacher or LerpTeacher()
    n = 0
    for sh in list_shards(data_root):
        out = []
        for sample in iter_tar_samples(sh):
            # raw shards may be [C, T, H, W]: time first, as the loader reads them
            lat = _maybe_transpose_latents(np.asarray(sample["latents"]), T)
            starts = np.arange(0, lat.shape[0] - 1, 2)
            ends = np.minimum(starts + 2, lat.shape[0] - 1)
            mids = teacher.interpolate(lat[starts], lat[ends])
            out.append({"__key__": sample["__key__"],
                        "teacher_latents": np.asarray(mids, np.float32)})
            n += 1
        if out:
            write_tar_shard(os.path.join(out_root, os.path.basename(sh)), out)
    return n
