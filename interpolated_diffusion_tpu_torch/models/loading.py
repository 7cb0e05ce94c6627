"""Checkpoint -> model loaders shared by the samplers and the trainers (port
of models/loading.py: the two maze denoisers).

Reads the port's own checkpoint format (utils/checkpoint.py): the meta dict
rebuilds the model, `ema.pt` (by default) or `params.pt` fills it. Models
come back with f32 parameters on `device` (the card unless the caller asks
for the CPU), computing in bf16 under `bf16=True`, in eval mode. The selector and segment-cost loaders and the JAX
package's msgpack / reference-PyTorch checkpoints are not ported.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from ..utils.checkpoint import latest_checkpoint, load_checkpoint, read_meta
from .denoisers import InterpLevelDenoiser, KeypointDenoiser
from .transformer import set_compute_dtype


def resolve_ckpt(path: str) -> str:
    """`path` if it is a checkpoint, else the newest `ckpt_<step>` under it."""
    if os.path.exists(os.path.join(path, "meta.json")):
        return path
    found = latest_checkpoint(path)
    if not found:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    return found


def _maze_ch(meta) -> Tuple[int, ...]:
    return tuple(int(c) for c in str(meta["maze_channels"]).split(","))


def _check_meta(meta: Dict, path: str, stage: str) -> None:
    if meta.get("stage") != stage:
        raise ValueError(f"{path} is not a {stage} checkpoint (stage {meta.get('stage')!r})")
    if meta.get("causal"):
        raise NotImplementedError("causal Stage-2 checkpoints: the causal transformer is not "
                                  "ported yet")
    if meta.get("use_kp_feat"):
        raise NotImplementedError("checkpoints trained with --use_kp_feat: ops/selection.py is "
                                  "not ported yet")


def _fill(model, path: str, bf16: bool, use_ema: bool, device):
    _, payload = load_checkpoint(path, map_location=device, with_opt_state=False)
    weights = payload["ema"] if (use_ema and "ema" in payload) else payload["params"]
    model.load_state_dict(weights)
    set_compute_dtype(model, torch.bfloat16 if bf16 else None)
    return model.to(device).eval().requires_grad_(False)


def load_keypoint_model(path: str, bf16: bool = True, use_ema: bool = True, device="cuda"):
    """(model, meta) of a Stage-1 checkpoint (or the newest under a run dir)."""
    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, "keypoints")
    model = KeypointDenoiser(
        d_model=meta["d_model"], n_layers=meta["n_layers"], n_heads=meta["n_heads"],
        d_ff=meta["d_ff"], d_cond=meta["d_cond"], use_sdf=bool(meta["use_sdf"]),
        use_start_goal=bool(meta["cond_start_goal"]), data_dim=int(meta["data_dim"]),
        kp_feat_dim=0, maze_channels=_maze_ch(meta))
    return _fill(model, path, bf16, use_ema, device), meta


def load_interp_model(path: str, bf16: bool = True, use_ema: bool = True, device="cuda"):
    """(model, meta) of a Stage-2 checkpoint (or the newest under a run dir)."""
    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, "interp_levels")
    model = InterpLevelDenoiser(
        d_model=meta["d_model"], n_layers=meta["n_layers"], n_heads=meta["n_heads"],
        d_ff=meta["d_ff"], d_cond=meta["d_cond"], use_sdf=bool(meta["use_sdf"]),
        use_start_goal=bool(meta["cond_start_goal"]), data_dim=int(meta["data_dim"]),
        max_levels=max(8, int(meta["levels"])), mask_channels=int(meta["mask_channels"]),
        maze_channels=_maze_ch(meta))
    return _fill(model, path, bf16, use_ema, device), meta
