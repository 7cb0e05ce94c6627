"""Ring-SLA: the block-sparse SLA kernel under sequence sharding (port of
parallel/ring_sla.py).

  1. Global block map without gathering K: each rank mean-pools its K shard
     into block descriptors and `all_gather`s only those (with the smooth-k
     mean a `pmean` over the group); pooled QK^T top-k then gives a LUT of
     GLOBAL key-block ids, as kernels/sla.get_block_map does on one device.
  2. Sentinel-masked hops: K/V shards travel the ring (`ppermute`, rotate
     then use, n - 1 hops). At each hop the LUT entries that live on the
     resident shard are rebased to local block ids and every other entry
     becomes the sentinel block (id L_loc / block_n), which
     kernels/block_sparse_attention.block_sparse_attention_lse masks to zero
     probability: the hand-written sm_90a SLA forward on CUDA tensors, its
     plain twin on CPU tensors, with the LUT's full width every hop.
  3. Base-2 log-space merge of each hop's (o, lse). A hop whose row names
     no resident block returns o = 0 and an lse far below any real one
     (the twin's log2(1e-30), about -99.7; the kernel's is lower), so its
     weight exp2(lse - m) vanishes once a real hop lands.
  4. The linear branch is exact under sharding: phi(k)^T v and sum phi(k)
     are `psum`s over the group.

Forward-only, as in the JAX package: ring-SLA serves long-context sampling.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.block_sparse_attention import block_sparse_attention_lse
from ..kernels.sla import mean_pool_blocks
from .collectives import Group, all_gather, axis_index, axis_size, pmean, ppermute, psum, ring_perm

_NEG_INF = -1e30


@torch.no_grad()
def ring_sla_block_map(q: torch.Tensor, k: torch.Tensor, group: Group, topk_ratio: float,
                       block_q: int, block_k: int) -> torch.Tensor:
    """Global block LUT [BH, m_loc, topk] int32 of GLOBAL key-block ids for
    this rank's q / k shards [BH, L_loc, D]; ties go to the lower block id,
    as jax.lax.top_k."""
    L_loc = k.shape[-2]
    if L_loc % block_k:
        raise ValueError(f"local L={L_loc} must divide block_k={block_k} "
                         "(the global block grid must align with the shards)")
    k_mean = pmean(k.mean(dim=-2, keepdim=True), group)
    pk = all_gather(mean_pool_blocks(k - k_mean, block_k), group, dim=1)   # [BH, n_blocks, D]
    pq = mean_pool_blocks(q, block_q)
    score = pq.float() @ pk.float().transpose(-1, -2)
    n_blocks = score.shape[-1]
    topk = max(1, min(n_blocks, int(topk_ratio * n_blocks)))
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :topk].to(
        torch.int32)


@torch.no_grad()
def ring_block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lut_global: torch.Tensor, group: Group, block_m: int = 128,
                                block_n: int = 128, scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Block-sparse attention restricted to the global LUT's key blocks with
    K/V sharded over `group`: one block_sparse_attention_lse per hop (n in
    all), merged in base 2. q/k/v [BH, L_loc, D]."""
    n, me = axis_size(group), axis_index(group)
    BH, L_loc, D = q.shape
    if L_loc % block_n:
        raise ValueError(f"local L={L_loc} must divide block_n={block_n}")
    n_loc = L_loc // block_n
    scale = D ** -0.5 if scale is None else scale

    def use_shard(o, m, l, k_blk, v_blk, s):
        lo = ((me + s) % n) * n_loc
        in_shard = (lut_global >= lo) & (lut_global < lo + n_loc)
        lut_s = torch.where(in_shard, lut_global - lo, n_loc).to(torch.int32).contiguous()
        o_s, lse_s = block_sparse_attention_lse(q, k_blk, v_blk, lut_s, block_m, block_n, scale)
        m_new = torch.maximum(m, lse_s)
        alpha, w = torch.exp2(m - m_new), torch.exp2(lse_s - m_new)
        return o * alpha[..., None] + o_s.float() * w[..., None], m_new, l * alpha + w

    o = torch.zeros((BH, L_loc, D), dtype=torch.float32, device=q.device)
    m = torch.full((BH, L_loc), _NEG_INF, device=q.device)
    l = torch.zeros((BH, L_loc), device=q.device)
    o, m, l = use_shard(o, m, l, k, v, 0)           # the local shard, no communication
    perm = ring_perm(n)
    for s in range(1, n):
        k, v = ppermute(k, group, perm), ppermute(v, group, perm)
        o, m, l = use_shard(o, m, l, k, v, s)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Group,
                          feature_map: str = "softmax") -> torch.Tensor:
    """SLA's low-rank branch with L sharded: the K-side reductions psum'd,
    the Q side local (kernels/sla._linear_attention's numerics otherwise)."""
    if feature_map == "softmax":
        fq, fk = torch.softmax(q, dim=-1), torch.softmax(k, dim=-1)
    elif feature_map == "elu":
        fq, fk = torch.nn.functional.elu(q) + 1, torch.nn.functional.elu(k) + 1
    elif feature_map == "relu":
        fq, fk = torch.relu(q), torch.relu(k)
    else:
        raise NotImplementedError(f"feature map {feature_map}")
    kv = psum(fk.float().transpose(-1, -2) @ v.float(), group).to(q.dtype)     # [BH, D, D]
    ksum = psum(fk.float().sum(dim=-2), group).to(q.dtype)                    # [BH, D]
    num = fq.float() @ kv.float()
    den = fq.float() @ ksum.float()[..., None] + 1e-5
    return (num / den).to(q.dtype)


def ring_sla_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Group,
                            topk_ratio: float = 0.1, block_m: int = 128, block_n: int = 128,
                            scale: Optional[float] = None, feature_map: str = "softmax"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block-sparse output, linear-branch output) of this rank's shard; the
    caller owns the zero-initialised projection of the linear branch."""
    lut = ring_sla_block_map(q, k, group, topk_ratio, block_q=block_m, block_k=block_n)
    o_s = ring_block_sparse_attention(q, k, v, lut, group, block_m, block_n, scale)
    return o_s, ring_linear_attention(q, k, v, group, feature_map)


def ring_sla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Group = None,
                       topk_ratio: float = 0.1, block_m: int = 128, block_n: int = 128
                       ) -> torch.Tensor:
    """Host-level entry: every rank passes the global q, k, v [BH, L, D] and
    gets the global sparse-branch output (the module's output at init, its
    linear projection being zero). The local length L / n must divide both
    block sizes."""
    n, me = axis_size(group), axis_index(group)
    L = q.shape[1]
    if L % n:
        raise ValueError(f"L={L} not divisible by the sequence group's {n} ranks")
    c = L // n
    if c % block_n or c % block_m:
        raise ValueError(f"local L={c} must divide block sizes ({block_m}, {block_n})")
    local = lambda x: x[:, me * c:(me + 1) * c].contiguous()
    o_s, _ = ring_sla_self_attention(local(q), local(k), local(v), group, topk_ratio,
                                     block_m, block_n)
    return all_gather(o_s, group, dim=1)
