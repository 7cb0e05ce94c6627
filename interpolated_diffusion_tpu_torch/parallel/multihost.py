"""Multi-process runtime helpers (port of parallel/multihost.py).

The JAX package runs one SPMD program over every local device and, on a pod,
wires hosts together with jax.distributed. The port runs one process per
GPU, launched by `torchrun --nproc_per_node N`, each on `cuda:LOCAL_RANK`:
this module brings up `torch.distributed` for such a run and holds the few
host-aware helpers the trainers need.

  * `maybe_initialize_distributed()`: idempotent; explicit arguments win,
    else torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT; a no-op
    returning False in a plain single process. The backend follows the
    device: NCCL for CUDA, gloo for the CPU (named, never switched on
    failure).
  * `local_device(name)`: "cuda" is this rank's card, cuda:LOCAL_RANK.
  * `global_batch_from_local(...)`: torch has no global array, so each rank
    keeps its own rows on its own device.
  * `assert_same_across_processes(...)`: an all-gather of a float64 that
    fails fast when a seed or config differs between ranks.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device_type: str = "cuda") -> bool:
    """Initialise the default process group once, if a multi-process run is
    asked for; returns True when more than one process takes part.

    Explicit arguments win; otherwise torchrun's environment (WORLD_SIZE,
    RANK, MASTER_ADDR, MASTER_PORT) is read. Without either there is nothing
    to do. `backend` defaults to nccl for device_type "cuda" and gloo
    otherwise. A CUDA run also binds the process to cuda:LOCAL_RANK."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and not ("MASTER_ADDR" in env and "WORLD_SIZE" in env):
        return False      # single process: nothing to do
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size > 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 writes checkpoints, run_config.json and logs."""
    return process_index() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index() if is_initialized() else 0))


def local_device(name: str) -> torch.device:
    """The device a rank computes on: a bare "cuda" is cuda:LOCAL_RANK."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def global_batch_from_local(local_batch: Any, device: torch.device) -> Any:
    """This rank's rows of the global batch onto its device (each process
    passes its own slice, global_batch_size / process_count rows). Numpy
    arrays and tensors in a (nested) dict or alone; scalars pass through."""
    if isinstance(local_batch, dict):
        return {k: global_batch_from_local(v, device) for k, v in local_batch.items()}
    if isinstance(local_batch, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(local_batch).to(device, non_blocking=True)
    return local_batch


def assert_same_across_processes(value: float, what: str = "config") -> None:
    """Fail fast if a scalar (seed, config hash, ...) differs across ranks;
    the all-gather doubles as a liveness check of the process group.
    Trivially true in a single process."""
    if process_count() == 1:
        return
    local = torch.tensor([float(value)], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        local = local.cuda()
    gathered = [torch.zeros_like(local) for _ in range(process_count())]
    dist.all_gather(gathered, local)
    values = [float(g) for g in gathered]
    if any(v != float(value) for v in values):
        raise ValueError(f"{what} differs across processes: local={float(value)} "
                         f"gathered={values}")


def process_local_slice(n: int) -> slice:
    """Row range of a length-n global batch owned by this process."""
    per = n // process_count()
    i = process_index()
    return slice(i * per, (i + 1) * per)
