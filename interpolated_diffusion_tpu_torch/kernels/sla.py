"""Sparse-Linear Attention (port of kernels/sla.py).

The block map (mean-pooled Q/K descriptors with smooth-k, pooled scores,
per-row top-k LUT) and the linear-attention branch are plain PyTorch, as
they are plain jnp in the JAX package. The sparse branch goes through the
block-sparse kernels: kernels/block_sparse_attention (bf16) or
kernels/int8_attention (quant="int8"). Gradients flow through the sparse
branch (the backward kernels), the linear branch and `proj_l`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import backward_span, span
from .block_sparse_attention import block_sparse_attention
from .int8_attention import int8_block_sparse_attention

SLA, BLOCK_MAP, SPARSE, LINEAR, SLA_BWD = ("idt.wan.sla", "idt.wan.sla.block_map",
                                           "idt.wan.sla.sparse", "idt.wan.sla.linear",
                                           "idt.wan.sla.bwd")


def mean_pool_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """[..., L, D] -> [..., ceil(L/block), D] block means; the zero-padded
    tail is divided by its true count. Summed in f32, then rounded to x's
    dtype (in bf16 an unrounded mean flips marginal top-k choices)."""
    *lead, L, D = x.shape
    n_blocks = -(-L // block)
    xb = F.pad(x, (0, 0, 0, n_blocks * block - L)).reshape(*lead, n_blocks, block, D)
    counts = torch.clamp(torch.minimum(L - torch.arange(n_blocks, device=x.device) * block,
                                       torch.tensor(block, device=x.device)), 1, block).float()
    return (xb.float().sum(dim=-2) / counts[:, None]).to(x.dtype)


def get_block_map(q: torch.Tensor, k: torch.Tensor, topk_ratio: float,
                  block_q: int = 256, block_k: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """q/k [BH, L, D] -> (sparse_map [BH, M, N] int8, lut [BH, M, topk] int32, topk).

    topk = max(1, min(N, int(ratio * N))); the LUT lists each query block's
    highest-scoring key blocks, best first, and the lower block index first
    among equal scores, as jax.lax.top_k does (a stable descending sort, on
    any device). Equal scores are real: padding blocks and constant latents
    pool to the same value.
    """
    arg_k = k - k.mean(dim=-2, keepdim=True)  # smooth-k
    pq = mean_pool_blocks(q, block_q)
    pk = mean_pool_blocks(arg_k, block_k)
    score = pq.float() @ pk.float().transpose(-1, -2)
    n_blocks = score.shape[-1]
    topk = max(1, min(n_blocks, int(topk_ratio * n_blocks)))
    lut = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :topk]
    sparse_map = F.one_hot(lut, n_blocks).sum(dim=-2).to(torch.int8)
    return sparse_map, lut.to(torch.int32), topk


def _linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      feature_map: str) -> torch.Tensor:
    """Global low-rank branch phi(q)(phi(k)^T v) / (phi(q) . sum phi(k)), in
    the inputs' dtype with f32 contractions; returns f32."""
    if feature_map == "softmax":
        fq, fk = torch.softmax(q, dim=-1), torch.softmax(k, dim=-1)
    elif feature_map == "elu":
        fq, fk = F.elu(q) + 1, F.elu(k) + 1
    elif feature_map == "relu":
        fq, fk = F.relu(q), F.relu(k)
    else:
        raise NotImplementedError(f"feature map {feature_map}")
    kv = (fk.float().transpose(-1, -2) @ v.float()).to(q.dtype)      # [BH, D, D]
    ksum = fk.sum(dim=-2)                                            # [BH, D]
    num = fq.float() @ kv.float()
    den = (fq.float() @ ksum.float()[..., None]) + 1e-5
    return num / den


class SparseLinearAttention(nn.Module):
    """o = BlockSparse(q, k, v) + ZeroInitProj(LinearAttn(phi(q), phi(k), v)).

    q/k/v [B, H, L, D]. The sparse branch always runs on bf16 q/k/v (the
    kernels' contract, also in an f32 model); the linear branch runs in the
    inputs' dtype and its projection `proj_l` (zero-initialised) in f32.
    """

    def __init__(self, head_dim: int, topk: float = 0.1, feature_map: str = "softmax",
                 block_q: int = 256, block_k: int = 256, quant: str = "none"):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"quant {quant!r} not in ('none', 'int8')")
        self.topk, self.feature_map, self.quant = topk, feature_map, quant
        self.block_q, self.block_k = block_q, block_k
        self.proj_l = nn.Linear(head_dim, head_dim)
        self.proj_l.zero_init = True

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                block: Optional[int] = None) -> torch.Tensor:
        """`block`: a square block for this call in place of (block_q,
        block_k) (WanAttention's tuned SLA block, kernels/tuning.sla_blocks)."""
        with span(SLA):
            return backward_span(SLA_BWD, self._attend, q, k, v, block)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                block: Optional[int]) -> torch.Tensor:
        B, H, L, D = q.shape
        bq, bk = (block, block) if block else (self.block_q, self.block_k)
        qf, kf, vf = (t.reshape(B * H, L, D) for t in (q, k, v))
        with span(BLOCK_MAP), torch.no_grad():   # the top-k indices carry no gradient
            _, lut, _ = get_block_map(qf, kf, self.topk, bq, bk)
        bf = torch.bfloat16
        attend = int8_block_sparse_attention if self.quant == "int8" else block_sparse_attention
        with span(SPARSE):
            o_s = attend(qf.to(bf).contiguous(), kf.to(bf).contiguous(),
                         vf.to(bf).contiguous(), lut, bq, bk)
        with span(LINEAR):
            o_l = _linear_attention(qf, kf, vf, self.feature_map)
            proj = F.linear(o_l, self.proj_l.weight.float(), self.proj_l.bias.float())
        return (o_s.float() + proj).to(q.dtype).reshape(B, H, L, D)
