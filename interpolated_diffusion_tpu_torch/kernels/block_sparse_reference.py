"""Gather formulation of block-sparse attention (port of
kernels/block_sparse_reference.py): the plain twin of the SLA kernel.

Each query block attends to the key blocks its LUT row names: the blocks are
gathered, the logits taken in f32, and the softmax runs over the union of
those blocks only. The LSE is returned in base 2, matching the kernels' exp2.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

LOG2E = 1.4426950408889634
CHUNK_ELEMS = 1 << 27  # f32 elements of one [.., Lq, keys] intermediate per chunk


def bh_chunks(BH: int, per_bh: int, budget: int = CHUNK_ELEMS) -> Iterator[slice]:
    """Slices of the BH axis whose [.., Lq, keys] intermediates stay under
    `budget` elements (the twins' peak memory at Wan scale); the math per
    (batch, head) is independent, so chunking changes no number."""
    step = max(1, budget // max(1, per_bh))
    for s in range(0, BH, step):
        yield slice(s, min(BH, s + step))


def gather_blocks(x: torch.Tensor, lut: torch.Tensor, block: int, n_blocks: int) -> torch.Tensor:
    """[BH, L, D] zero-padded to n_blocks * block rows -> the LUT-named blocks
    [BH, M, topk, block, D]."""
    BH, L, D = x.shape
    xb = F.pad(x, (0, 0, 0, n_blocks * block - L)).reshape(BH, n_blocks, block, D)
    return xb[torch.arange(BH, device=x.device)[:, None, None], lut.long()]


def block_sparse_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lut: torch.Tensor,
    block_m: int, block_n: int, scale: Optional[float] = None,
    kv_len: Optional[int] = None, kv_pad_blocks: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [BH, Lq, D], k/v [BH, Lkv, D], lut [BH, ceil(Lq/block_m), topk] ->
    (o [BH, Lq, D] in q's dtype, lse [BH, Lq] f32, base 2).

    kv_len / kv_pad_blocks: the sentinel contract of block_sparse_attention_lse.
    LUT id ceil(kv_len / block_n) addresses an appended zero block whose keys
    all mask out; a row of sentinels only gives o = 0 and lse = log2(1e-30)
    instead of NaN.
    """
    BH, L, D = q.shape
    Lkv = k.shape[1] if kv_len is None else kv_len
    M, topk = lut.shape[1], lut.shape[2]
    scale = D ** -0.5 if scale is None else scale
    n_blocks = -(-Lkv // block_n) + kv_pad_blocks
    qb = F.pad(q, (0, 0, 0, M * block_m - L)).reshape(BH, M, block_m, D)
    o = torch.empty((BH, M * block_m, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, M * block_m), dtype=torch.float32, device=q.device)
    for c in bh_chunks(BH, M * block_m * topk * block_n):
        lut_c = lut[c]
        kg = gather_blocks(k[c], lut_c, block_n, n_blocks).float()
        vg = gather_blocks(v[c], lut_c, block_n, n_blocks).float()
        logits = torch.einsum("bmqd,bmjnd->bmqjn", qb[c].float(), kg) * scale
        key_pos = lut_c.long()[..., None] * block_n + torch.arange(block_n, device=q.device)
        logits = logits.masked_fill(~(key_pos[:, :, None] < Lkv), float("-inf"))
        flat = logits.reshape(logits.shape[0], M, block_m, topk * block_n)
        mx = flat.amax(dim=-1, keepdim=True)
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))  # all-sentinel rows
        p = torch.exp(flat - mx)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        oc = torch.einsum("bmqjn,bmjnd->bmqd",
                          (p / l).reshape(-1, M, block_m, topk, block_n), vg)
        o[c] = oc.reshape(-1, M * block_m, D).to(q.dtype)
        lse[c] = ((mx + torch.log(l))[..., 0] * LOG2E).reshape(-1, M * block_m)
    return o[:, :L], lse[:, :L]
