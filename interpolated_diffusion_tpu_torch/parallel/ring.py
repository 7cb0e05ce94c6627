"""Ring attention: exact attention with the sequence sharded over a process
group (port of parallel/ring.py).

Each rank holds one contiguous chunk of the sequence (chunk c on rank c of
the group). K/V shards travel the ring by `collectives.ppermute`, one hop a
step, and the partial results merge by the online-softmax (log-sum-exp)
update the flash kernels use, so no rank ever holds the full K/V or the
[L, L] scores. Rotate-then-use: the local shard is consumed first, then
exactly n - 1 hops are made. The per-hop math is plain torch (JAX's is
einsum, outside any Pallas kernel), with true -inf masking and the same
guards for fully masked blocks; the whole loop is differentiable through
the ppermute's backward (the inverse hop).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .collectives import Group, all_gather, axis_index, axis_size, ppermute, ring_perm


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Group = None,
                        causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the sequence sharded on `group`: q [B, H, Lq, D]
    and k, v [B, H, Lk, D] are this rank's chunks; returns [B, H, Lq, D] in
    q's dtype. `causal` masks by global position (query chunk c, key chunk
    s of the group)."""
    n, me = axis_size(group), axis_index(group)
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    scale = Dh ** -0.5 if scale is None else scale
    qf = q.float() * scale
    q_pos = me * Lq + torch.arange(Lq, device=q.device)

    def accumulate(o, m, l, k_blk, v_blk, s):
        """Merge the key shard that originated on rank (me + s) % n."""
        src = (me + s) % n
        scores = qf @ k_blk.float().transpose(-1, -2)
        if causal:
            k_pos = src * Lk + torch.arange(Lk, device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            scores = scores.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # guard fully masked rows (m_new = -inf): no exp of nan
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + p @ v_blk.float()
        return o, m_new, l

    o = torch.zeros((B, H, Lq, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Lq), device=q.device)
    o, m, l = accumulate(o, m, l, k, v, 0)          # the local shard, no communication
    perm = ring_perm(n)                              # shard i -> rank i - 1
    for s in range(1, n):
        k, v = ppermute(k, group, perm), ppermute(v, group, perm)
        o, m, l = accumulate(o, m, l, k, v, s)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Group = None,
                   causal: bool = False) -> torch.Tensor:
    """Host-level entry: every rank passes the global q, k, v [B, H, L, D]
    and gets the global output; the sequence is cut into one contiguous
    chunk per rank of `group` and runs the ring. L must divide by the group
    size (pad upstream)."""
    n, me = axis_size(group), axis_index(group)
    L = q.shape[2]
    if L % n:
        raise ValueError(f"L={L} not divisible by the sequence group's {n} ranks")
    c = L // n
    local = lambda x: x[:, :, me * c:(me + 1) * c].contiguous()
    o = ring_self_attention(local(q), local(k), local(v), group, causal)
    return all_gather(o, group, dim=2)


def make_seq_mesh(n_seq: Optional[int] = None) -> Group:
    """The sequence group: the first n_seq ranks of the run (default: every
    rank). Every rank must call it (creating a group is collective); the
    run must have at least n_seq processes, else the error names torchrun."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_seq or world
    if n > world:
        raise ValueError(f"a sequence group of {n} needs {n} processes, this run has {world}: "
                         f"launch with torchrun --nproc_per_node {n}")
    if n == world:
        return dist.group.WORLD if dist.is_initialized() else None
    return dist.new_group(list(range(n)))
