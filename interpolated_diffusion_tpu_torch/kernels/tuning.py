"""Opt-in tuned kernel block sizes and the small-attention policy (port of
kernels/tuning.py).

Setting

    ID_TPU_ATTN_TUNE=/path/to/attn_autotune.json

makes the port read the same registry file, with the same schema, as the JAX
package. Two of its choices reach a port path: the default small-attention
policy of the maze and toy-video CLIs (`small_attn_policy`, through
`add_attn_policy_arg`), and the SLA block of WanAttention (`sla_blocks`).
`flash_blocks` and `fused_group_b` are kept as the registry's functions, the
same as the JAX package's, but no port path consults them: the CUDA kernels
tile and pack by their own design, and the packing factor moves no number.
Without the variable the module is inert and every default stays as it was:
runs are reproducible from flags alone.

The registry in docs/attn_autotune.json was measured on a TPU
(`"backend": "tpu"`); the port reads it to make the same choices as the JAX
package, not as a tuning for the GPU. An SLA block sets the top-k block
map's granularity, so it changes the attended blocks on both paths, and a
block the CUDA kernels refuse raises their ValueError. The TPU packing
policies "full", "group" and "none" compute plain attention in numbers: the
port runs them as "dense".
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Optional, Tuple

_ENV = "ID_TPU_ATTN_TUNE"
# the registry's small-attention policies -> the port's attn_policy
PORT_POLICIES = {"fused": "fused", "block": "block", "full": "dense", "group": "dense",
                 "none": "dense", "dense": "dense"}
REGISTRY = "registry"   # --attn_policy's default: the registry's choice, else "fused"


@lru_cache(maxsize=1)
def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _best(kernel: str, prefer: str) -> Optional[Tuple[int, int]]:
    path = os.environ.get(_ENV)
    if not path:
        return None
    cfg = _load(path).get(kernel, {})
    # No cross-fallback: a best_fwd winner may have no compilable backward
    # (the sweep retries forward-only on a failed gradient), so a
    # prefer="best_grad" lookup falls back to the built-in defaults, never to
    # the forward winner.
    tag = cfg.get(prefer)
    if not tag:
        return None
    try:
        m, n = (int(t) for t in tag.split("x"))
        return m, n
    except ValueError:
        return None


def flash_blocks(default_m: int = 512, default_n: int = 1024,
                 prefer: str = "best_grad") -> Tuple[int, int]:
    """(block_m, block_n) of the JAX package's dense flash attention: the
    registry's `prefer` winner, else the defaults."""
    return _best("flash", prefer) or (default_m, default_n)


def small_attn_policy(default: str = "fused") -> str:
    """The small-L attention policy, in the registry's names ('fused' |
    'block' | 'full' | 'group' | 'none'): the registry's "small_attn" winner,
    then the ID_TPU_SMALL_ATTN override, then `default`."""
    path = os.environ.get(_ENV)
    if path:
        best = _load(path).get("small_attn", {}).get("best")
        if best in ("fused", "full", "group", "none", "block"):
            return best
    return os.environ.get("ID_TPU_SMALL_ATTN", default)


def attn_policy_arg(value: str) -> str:
    """argparse `type` of the CLIs' --attn_policy: its default "registry"
    becomes small_attn_policy() in the port's names ("fused" without the
    registry or ID_TPU_SMALL_ATTN); an explicit flag is taken as it is."""
    if value != REGISTRY:
        return value
    policy = small_attn_policy()
    if policy not in PORT_POLICIES:
        raise ValueError(f"small-attention policy {policy!r} (ID_TPU_ATTN_TUNE / "
                         f"ID_TPU_SMALL_ATTN) not in {sorted(PORT_POLICIES)}")
    return PORT_POLICIES[policy]


def add_attn_policy_arg(p, routes: str = "every block") -> None:
    """Add the CLIs' --attn_policy to argparse parser `p`: default the
    registry's policy (attn_policy_arg), an explicit flag wins."""
    p.add_argument("--attn_policy", type=attn_policy_arg, default=REGISTRY,
                   choices=["fused", "block", "dense"],
                   help=f"small-L attention route of {routes} (models/transformer.py); default: "
                        "the ID_TPU_ATTN_TUNE registry's policy, else fused (kernels/tuning.py)")


def fused_group_b(L: int, default_rows: int = 512) -> int:
    """The JAX kernels' batch-pack group size G (G * L rows): the
    registry's small_attn.fused_rows, then ID_TPU_FUSED_ROWS, then
    `default_rows`; G is clamped to [1, 64]."""
    rows = default_rows
    path = os.environ.get(_ENV)
    got = _load(path).get("small_attn", {}).get("fused_rows") if path else None
    if isinstance(got, int) and got > 0:
        rows = got
    else:
        env = os.environ.get("ID_TPU_FUSED_ROWS")
        if env and env.isdigit():
            rows = int(env)
    return max(1, min(64, rows // max(1, L)))


def sla_blocks(default: int = 256, quant: str = "none",
               prefer: str = "best_grad", L: Optional[int] = None) -> int:
    """Square (block_q = block_k) SLA block: the registry's 'sla' (bf16) or
    'sage_sla' (int8) winner, else `default`. The block sets the top-k block
    map's granularity, so the tuned value applies only where the sequence
    keeps at least 8 key blocks a row at that size (L >= 8 * block, the
    regime the sweep measured); shorter sequences keep `default`."""
    kern = "sage_sla" if quant == "int8" else "sla"
    got = _best(kern, prefer)
    if not got:
        return default
    blk = got[0]
    if L is not None and L < 8 * blk:
        return default
    return blk
