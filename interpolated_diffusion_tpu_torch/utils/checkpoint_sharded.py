"""Sharded checkpoints, optionally written on a background thread (port of
utils/checkpoint_sharded.py).

The JAX package writes these with orbax; the port has its own format with
the same directory-per-step layout and meta.json contract, so
`read_meta` / `latest_checkpoint` / `load_checkpoint` (utils/checkpoint.py)
read both kinds of checkpoint:

    <path>/shard_<rank>.pt   what rank <rank> writes
    <path>/meta.json         step, meta, "format": "torch_sharded",
                             "n_shards", has_opt_state, has_ema

Every process of the run calls `save_checkpoint_sharded` with the same
trees. The tensor leaves of params and EMA are dealt round-robin over the
ranks (leaf i, in sorted key order, to rank i % world), so each rank writes
1/world of the bytes; rank 0 also writes the optimizer state, whole. Each
shard is staged under a temporary name and renamed into place; rank 0 writes
meta.json only after every shard file has landed (it watches the directory:
no collective runs off the main thread), so a reader never sees a step
whose tensors are still in flight. With async_save the device-to-host
copies happen on the caller's thread and the file IO on a background
thread; a later save or `wait_for_async_saves()` joins it.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.multihost import process_count, process_index

FORMAT = "torch_sharded"
SHARD_WAIT_S = 3600.0   # rank 0's wait for the other ranks' shards before it gives up
_THREAD: Optional[threading.Thread] = None
_ERROR: list = []


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _host_copy(x):
    """A host copy of every tensor of a tree of dicts / lists."""
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(v) for v in x)
    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x


def _my_leaves(tree: Any, rank: int, world: int) -> Dict[str, Any]:
    flat = _flatten(tree)
    return {k: _host_copy(flat[k]) for i, k in enumerate(sorted(flat)) if i % world == rank}


def _shard_name(rank: int) -> str:
    return f"shard_{rank}.pt"


def _write(path: str, payload: Dict, rank: int, world: int, header: Dict) -> None:
    tmp = os.path.join(path, f".tmp-{_shard_name(rank)}")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _shard_name(rank)))
    if rank != 0:
        return
    deadline = time.time() + SHARD_WAIT_S
    while not all(os.path.exists(os.path.join(path, _shard_name(r))) for r in range(world)):
        if time.time() > deadline:
            raise TimeoutError(f"{path}: not every shard landed within {SHARD_WAIT_S} s")
        time.sleep(0.05)
    tmp = os.path.join(path, ".tmp-meta.json")
    with open(tmp, "w") as f:
        json.dump(header, f, indent=2)
    os.replace(tmp, os.path.join(path, "meta.json"))


def save_checkpoint_sharded(path: str, params: Any, opt_state: Optional[Any] = None,
                            step: int = 0, ema_params: Optional[Any] = None,
                            meta: Optional[Dict] = None, async_save: bool = False) -> None:
    """Write this rank's shard of a checkpoint at `path` (every rank calls
    it); rank 0 adds meta.json once all shards are there. async_save: the
    file IO on a background thread (joined by the next save or
    `wait_for_async_saves`)."""
    global _THREAD
    wait_for_async_saves()                     # one save in flight at a time
    rank, world = process_index(), process_count()
    os.makedirs(path, exist_ok=True)
    # an overwrite is incomplete until done: drop this rank's old shard (rank
    # 0 also the meta) and wait for every rank to have done so
    for name in [_shard_name(rank)] + (["meta.json"] if rank == 0 else []):
        if os.path.exists(os.path.join(path, name)):
            os.remove(os.path.join(path, name))
    if world > 1:
        dist.barrier()
    payload = {"params": _my_leaves(params, rank, world)}
    if ema_params is not None:
        payload["ema"] = _my_leaves(ema_params, rank, world)
    if opt_state is not None and rank == 0:
        payload["opt_state"] = _host_copy(opt_state)
    header = {"step": int(step), "meta": meta or {}, "format": FORMAT, "n_shards": world,
              "has_opt_state": opt_state is not None, "has_ema": ema_params is not None}
    if not async_save:
        _write(path, payload, rank, world, header)
        return

    def run():
        try:
            _write(path, payload, rank, world, header)
        except BaseException as e:  # surfaced by wait_for_async_saves
            _ERROR.append(e)

    _THREAD = threading.Thread(target=run, name="checkpoint-writer", daemon=True)
    _THREAD.start()


def wait_for_async_saves() -> None:
    """Block until the in-flight asynchronous save (and its meta.json) has
    landed; re-raise what went wrong in it. Call before the process exits."""
    global _THREAD
    if _THREAD is not None:
        _THREAD.join()
        _THREAD = None
    if _ERROR:
        raise RuntimeError("asynchronous checkpoint save failed") from _ERROR.pop()


def load_checkpoint_sharded(path: str, map_location="cpu", with_opt_state: bool = True
                            ) -> Tuple[int, Dict[str, Any]]:
    """(step, payload) with every shard merged back: `meta`, `params`, and
    `opt_state` / `ema` when they were saved (the trees save_checkpoint_sharded
    was given, whatever the number of ranks that reads them)."""
    with open(os.path.join(path, "meta.json")) as f:
        header = json.load(f)
    merged: Dict[str, Any] = {"params": {}, "ema": {}}
    for r in range(int(header["n_shards"])):
        shard = torch.load(os.path.join(path, _shard_name(r)), map_location=map_location,
                           weights_only=True)
        merged["params"].update(shard["params"])
        merged["ema"].update(shard.get("ema", {}))
        if "opt_state" in shard:
            merged["opt_state"] = shard["opt_state"]
    payload: Dict[str, Any] = {"meta": header["meta"], "params": _unflatten(merged["params"])}
    if header.get("has_ema"):
        payload["ema"] = _unflatten(merged["ema"])
    if header.get("has_opt_state") and with_opt_state:
        payload["opt_state"] = merged["opt_state"]
    return int(header["step"]), payload
