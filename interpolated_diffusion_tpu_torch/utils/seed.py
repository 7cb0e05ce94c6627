"""Seeding and determinism (port of utils/seed.py).

`set_seed` pins every host RNG surface as the JAX package's does
(PYTHONHASHSEED, `random`, numpy's global generator) and also seeds torch's
CPU and CUDA generators. `deterministic=True` turns on torch's deterministic
algorithms (and cuBLAS's fixed workspace), where the JAX package sets an XLA
flag: bit-reproducible reductions, slower, for debugging. The port's own
random draws come from explicit `torch.Generator`s seeded from `--seed`;
this covers the global generators that library code may reach.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int, deterministic: bool = False) -> None:
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)          # the CPU generator and every CUDA device's
    if deterministic:
        # cuBLAS needs a fixed workspace for deterministic GEMMs
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def get_seed_from_env(default: int = 0) -> int:
    return int(os.environ.get("SEED", default))
