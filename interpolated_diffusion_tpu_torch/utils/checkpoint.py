"""Checkpoint save / load with a meta-dict config channel (port of
utils/checkpoint.py).

A checkpoint is a directory with `meta.json` (step, meta, has_opt_state,
has_ema: the JAX package's keys, plus "format": "torch") and `params.pt`,
optionally `opt_state.pt` and `ema.pt`: torch.save of (nested) dicts of
tensors under the port's state_dict names. `meta` is the config channel:
samplers and downstream trainers rebuild models from it.

`load_checkpoint` and `read_meta` also read a checkpoint the JAX package
wrote (`params.msgpack` beside its `meta.json`, which has no "format" key):
utils/jax_checkpoint.py decodes its trees and models/jax_import converts
them to the port's state_dicts. Only params and EMA cross over; the optax
optimizer state does not. The port's sharded checkpoints ("format":
"torch_sharded", utils/checkpoint_sharded.py) load through the same call.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from .jax_checkpoint import is_jax_checkpoint, load_jax_checkpoint


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str, params: Any, opt_state: Optional[Any] = None, step: int = 0,
                    ema_params: Optional[Any] = None, meta: Optional[Dict] = None) -> None:
    """Write a checkpoint directory at `path` (created if needed).

    Atomic against a process crash or a racing reader (no fsync, so not
    against power loss): everything is staged in a sibling temp directory
    (whose name never matches the `ckpt_` prefix that `latest_checkpoint`
    scans) and renamed into place. Overwriting an existing `path` takes two
    renames (path -> .prev-<name>, stage -> path); a kill between them leaves
    the last complete checkpoint as `.prev-<name>`, which the next
    `save_checkpoint` or `latest_checkpoint` restores. Stale `.tmp-*` /
    `.prev-*` siblings of this name are swept first. meta.json is written
    last inside the stage, so its presence implies the arrays are complete.
    """
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    _recover_interrupted(parent)
    base = os.path.basename(path)
    for name in os.listdir(parent):
        if name.startswith(f".tmp-{base}-") or name == f".prev-{base}":
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
    stage = os.path.join(parent, f".tmp-{base}-{os.getpid()}")
    os.makedirs(stage)
    torch.save(_to_host(params), os.path.join(stage, "params.pt"))
    if opt_state is not None:
        torch.save(_to_host(opt_state), os.path.join(stage, "opt_state.pt"))
    if ema_params is not None:
        torch.save(_to_host(ema_params), os.path.join(stage, "ema.pt"))
    with open(os.path.join(stage, "meta.json"), "w") as f:
        json.dump({"step": int(step), "meta": meta or {}, "format": "torch",
                   "has_opt_state": opt_state is not None,
                   "has_ema": ema_params is not None}, f, indent=2)
    if os.path.isdir(path):
        old = os.path.join(parent, f".prev-{base}")
        os.replace(path, old)
        os.replace(stage, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(stage, path)


def _recover_interrupted(parent: str) -> None:
    """Restore checkpoints stranded by a kill between save_checkpoint's two
    overwrite renames: `.prev-<name>` without `<name>` is the last complete
    checkpoint and is renamed back; a `.prev-` whose target exists is an
    unswept backup and is removed."""
    try:
        names = os.listdir(parent)
    except OSError:
        return
    for name in names:
        if not name.startswith(".prev-"):
            continue
        src = os.path.join(parent, name)
        target = os.path.join(parent, name[len(".prev-"):])
        if not os.path.exists(target):
            os.replace(src, target)
        else:
            shutil.rmtree(src, ignore_errors=True)


def load_checkpoint(path: str, map_location="cpu", with_opt_state: bool = True
                    ) -> Tuple[int, Dict[str, Any]]:
    """(step, payload) from a checkpoint directory; payload has `meta`,
    `params`, and `opt_state` / `ema` when they were saved. A JAX checkpoint
    (utils/jax_checkpoint.py) gives its params and EMA as the port's
    state_dicts; asked `with_opt_state` (a resume) it raises
    NotImplementedError, since its optax optimizer state does not cross over."""
    if is_jax_checkpoint(path):
        return load_jax_checkpoint(path, map_location, with_opt_state)
    with open(os.path.join(path, "meta.json")) as f:
        header = json.load(f)
    if header.get("format") == "orbax":
        raise NotImplementedError(
            f"{path}: sharded (orbax) JAX checkpoints are not read (that needs orbax); the "
            "port's own sharded format is utils/checkpoint_sharded.py")
    if header.get("format") == "torch_sharded":
        from .checkpoint_sharded import load_checkpoint_sharded

        return load_checkpoint_sharded(path, map_location, with_opt_state)
    if header.get("format", "torch") != "torch":
        raise NotImplementedError(
            f"checkpoint format {header.get('format')!r} is not read here; convert the JAX "
            "package's parameter trees with models/jax_import")
    load = lambda name: torch.load(os.path.join(path, name), map_location=map_location,
                                   weights_only=True)
    payload: Dict[str, Any] = {"meta": header["meta"], "params": load("params.pt")}
    if header.get("has_opt_state") and with_opt_state:
        payload["opt_state"] = load("opt_state.pt")
    if header.get("has_ema"):
        payload["ema"] = load("ema.pt")
    return int(header["step"]), payload


def read_meta(path: str) -> Tuple[int, Dict]:
    """Just (step, meta), without reading the tensors (either package's
    checkpoint: both write the same meta.json keys)."""
    with open(os.path.join(path, "meta.json")) as f:
        header = json.load(f)
    return int(header["step"]), header["meta"]


def latest_checkpoint(ckpt_root: str, prefix: str = "ckpt_") -> Optional[str]:
    """The highest-step `ckpt_<step>` directory under ckpt_root, or None."""
    if not os.path.isdir(ckpt_root):
        return None
    _recover_interrupted(ckpt_root)
    best, best_step = None, -1
    for name in os.listdir(ckpt_root):
        if not name.startswith(prefix):
            continue
        try:
            step = int(name[len(prefix):])
        except ValueError:
            continue
        if step > best_step and os.path.exists(os.path.join(ckpt_root, name, "meta.json")):
            best, best_step = os.path.join(ckpt_root, name), step
    return best
