"""Pre-norm FiLM transformer encoder (port of models/transformer.py).

Each block dispatches its attention the way the JAX block does, under an
explicit `attn_policy` instead of the JAX package's environment/registry
lookup:

  block  whole block through kernels/fused_block.fused_film_block when
         L <= 256 and H*L <= 8192 (JAX _use_fused_block_policy);
  fused  the JAX default: attention through kernels/small_mha.small_mha_packed
         when 256 < H*L and L <= 256 (JAX _use_fused_packed), plain otherwise;
  dense  plain PyTorch attention everywhere.

A single `TransformerBlock(use_small_mha=True)` routes non-causal attention
with H*L <= 1024 through kernels/small_mha.small_mha before the packed
window is tried, as the JAX block does (an opt-in of the block alone: neither
encoder passes it on).

`causal=True` masks each query's later keys (a `tril` mask, -1e30 on the f32
logits, as JAX's dense_attention). No kernel takes that mask, so a causal
block runs plain attention under every policy, as the JAX block keeps causal
off its block and packed kernels; JAX's block-diagonal packing of heads
under causal (kron(eye(G), tril)) is per-head causal attention, which is
what runs here.

Sequence sharding (`set_attn_impl`, JAX's attn_impl field): "ring" runs
attention as ring attention over a process group (parallel/ring.py, causal
or not), "ring_sla" as ring-SLA's block-sparse branch (parallel/ring_sla.py,
non-causal; its linear branch is left out, as JAX leaves it out: its
zero-initialised projection adds nothing for checkpoints trained dense).
The block then sees this rank's chunk of the sequence and the caller passes
global positions (the denoisers' pos_frac); the parameters are unchanged.

Parameters and compute dtype are separate, as in the JAX package
(`dtype=bfloat16` over f32 parameters): `set_compute_dtype(model,
torch.bfloat16)` makes every layer cast its f32 master parameters per call,
so that the optimizer updates f32 masters and their gradients arrive in f32.
With no compute dtype set a layer computes in its parameters' dtype.

The JAX package's XLA packings (full / group / none) compute the same
numbers as plain attention, so here they are plain attention. Parameter
names follow the original PyTorch reference (norm1, attn.in_proj_weight,
attn.out_proj, ff.0, ff.2, film1, film2).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.fused_block import fused_film_block
from ..kernels.small_mha import SMALL_MHA_MAX_ROWS, small_mha, small_mha_packed

ATTN_POLICIES = ("fused", "block", "dense")
FUSED_ROWS = 512  # batch-pack row target of the JAX kernels (group_b = 512 // L)


def fused_group_b(L: int) -> int:
    """The JAX kernels' batch-pack group size G (kept for parity)."""
    return max(1, min(64, FUSED_ROWS // max(1, L)))


def _use_fused_block_policy(policy: str, H: int, L: int, causal: bool) -> bool:
    return policy == "block" and not causal and L <= 256 and H * L <= 8192


def _use_fused_packed(policy: str, H: int, L: int, causal: bool) -> bool:
    return policy == "fused" and not causal and 256 < H * L and L <= 256


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Make every layer under `module` that has a `compute_dtype` compute in
    `dtype` whatever its parameters' dtype (None: in the parameters' dtype).
    Parameters are cast per call, never stored."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


class Linear(nn.Linear):
    """nn.Linear that casts its input and parameters to `compute_dtype`."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that casts its input and parameters to `compute_dtype`."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embedding(nn.Embedding):
    """nn.Embedding whose rows come out in `compute_dtype`."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return super().forward(idx).to(self.compute_dtype or self.weight.dtype)


class LayerNorm(nn.Module):
    """flax LayerNorm: f32 statistics, var = E[x^2] - mu^2 (clipped at 0),
    eps 1e-6; output in the input dtype. torch.nn.LayerNorm differs (eps
    1e-5, two-pass variance). affine=False is flax's use_scale=False,
    use_bias=False (no parameters)."""

    def __init__(self, d: int, eps: float = 1e-6, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d)) if affine else None
        self.bias = nn.Parameter(torch.zeros(d)) if affine else None

    def init_seeded(self, uniform_) -> None:
        if self.weight is not None:
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        if self.weight is None:
            return ((xf - mu) * torch.rsqrt(var + self.eps)).to(x.dtype)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight.float()) + self.bias.float()
        return y.to(x.dtype)


class SelfAttentionParams(nn.Module):
    """The parameters of torch's nn.MultiheadAttention (fused [q; k; v]
    in-projection + out_proj), without its forward."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def init_seeded(self, uniform_) -> None:
        bound = self.in_proj_weight.shape[1] ** -0.5
        uniform_(self.in_proj_weight, bound)
        uniform_(self.in_proj_bias, bound)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_heads: int, causal: bool = False) -> torch.Tensor:
    """Plain multi-head attention on the packed [B, L, H*Dh] layout, f32
    softmax; k/v may have another length than q (cross-attention). `causal`
    keeps query i to keys 0..i: -1e30 on the f32 logits above the diagonal
    (self-attention only, Lk == Lq)."""
    B, L, D = q.shape
    dh = D // n_heads
    heads = lambda t: t.reshape(B, t.shape[1], n_heads, dh).transpose(1, 2)
    logits = (heads(q) @ heads(k).transpose(-1, -2)).float() * dh ** -0.5
    if causal:
        keep = torch.ones((L, k.shape[1]), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -1e30)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return (p @ heads(v)).transpose(1, 2).reshape(B, L, D)


def _film(h: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    gamma, beta = gb.chunk(2, dim=-1)
    return h * (1.0 + gamma[:, None, :]) + beta[:, None, :]


ATTN_IMPLS = ("dense", "ring", "ring_sla")


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
                               causal: bool, impl: str, group) -> torch.Tensor:
    """Attention of this rank's sequence chunk [B, L_loc, H*Dh] (packed) over
    the whole sequence sharded on `group`: ring or ring-SLA (JAX's
    TransformerBlock attn_impl branch)."""
    from ..parallel.ring import ring_self_attention
    from ..parallel.ring_sla import ring_sla_self_attention

    B, L, D = q.shape
    dh = D // n_heads
    heads = lambda t: t.reshape(B, L, n_heads, dh).transpose(1, 2)
    if impl == "ring":
        attn = ring_self_attention(heads(q), heads(k), heads(v), group, causal)
    else:
        if causal:
            raise ValueError("ring_sla attention has no causal mask")
        flat = lambda t: heads(t).reshape(B * n_heads, L, dh)
        o_s, _ = ring_sla_self_attention(flat(q), flat(k), flat(v), group)
        attn = o_s.reshape(B, n_heads, L, dh)
    return attn.transpose(1, 2).reshape(B, L, D)


class TransformerBlock(nn.Module):
    compute_dtype: Optional[torch.dtype] = None
    attn_impl: str = "dense"     # "ring" / "ring_sla": see the module docstring
    seq_group = None             # the process group the sequence is sharded over

    def __init__(self, d_model: int, n_heads: int, d_ff: int, d_cond: int = 128,
                 use_film: bool = True, attn_policy: str = "fused",
                 use_small_mha: bool = False, causal: bool = False):
        super().__init__()
        if attn_policy not in ATTN_POLICIES:
            raise ValueError(f"attn_policy {attn_policy!r} not in {ATTN_POLICIES}")
        self.d_model, self.n_heads, self.use_film = d_model, n_heads, use_film
        self.attn_policy, self.use_small_mha, self.causal = attn_policy, use_small_mha, causal
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.attn = SelfAttentionParams(d_model)
        self.ff = nn.Sequential(Linear(d_model, d_ff), nn.SiLU(), Linear(d_ff, d_model))
        if use_film:
            self.film1 = Linear(d_cond, 2 * d_model)
            self.film2 = Linear(d_cond, 2 * d_model)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, D = x.shape
        H = self.n_heads
        film_on = self.use_film and cond is not None
        dt = self.compute_dtype or self.attn.in_proj_weight.dtype
        x = x.to(dt)
        if self.attn_impl == "dense" and _use_fused_block_policy(self.attn_policy, H, L,
                                                                 self.causal):
            # FiLM gamma/beta projections stay outside the kernel, as in JAX
            if film_on:
                gb1, gb2 = self.film1(cond), self.film2(cond)
            else:
                gb1 = gb2 = x.new_zeros((B, 2 * D))
            return fused_film_block(
                x, gb1, gb2, self.norm1.weight, self.norm1.bias,
                self.norm2.weight, self.norm2.bias,
                self.attn.in_proj_weight, self.attn.in_proj_bias,
                self.attn.out_proj.weight, self.attn.out_proj.bias,
                self.ff[0].weight, self.ff[0].bias, self.ff[2].weight, self.ff[2].bias,
                n_heads=H, group_b=fused_group_b(L), use_film=film_on)

        h = self.norm1(x)
        if film_on:
            h = _film(h, self.film1(cond))
        q, k, v = F.linear(h, self.attn.in_proj_weight.to(dt),
                           self.attn.in_proj_bias.to(dt)).split(D, dim=-1)
        if self.attn_impl != "dense":
            attn = sequence_sharded_attention(q, k, v, H, self.causal, self.attn_impl,
                                              self.seq_group)
        elif self.use_small_mha and not self.causal and H * L <= SMALL_MHA_MAX_ROWS:
            attn = small_mha(q, k, v, H)
        elif _use_fused_packed(self.attn_policy, H, L, self.causal):
            attn = small_mha_packed(q, k, v, H, fused_group_b(L))
        else:
            attn = dense_attention(q, k, v, H, self.causal)
        x = x + self.attn.out_proj(attn)
        h = self.norm2(x)
        if film_on:
            h = _film(h, self.film2(cond))
        return x + self.ff(h)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 256, n_layers: int = 8, n_heads: int = 8,
                 d_ff: int = 1024, d_cond: int = 128, use_film: bool = True,
                 attn_policy: str = "fused", causal: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerBlock(d_model, n_heads, d_ff, d_cond, use_film, attn_policy,
                             causal=causal)
            for _ in range(n_layers)])

    def set_attn_policy(self, policy: str) -> None:
        if policy not in ATTN_POLICIES:
            raise ValueError(f"attn_policy {policy!r} not in {ATTN_POLICIES}")
        for layer in self.layers:
            layer.attn_policy = policy

    def set_attn_impl(self, impl: str, group=None) -> None:
        """dense, or attention over the sequence sharded on `group`."""
        if impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {impl!r} not in {ATTN_IMPLS}")
        for layer in self.layers:
            layer.attn_impl, layer.seq_group = impl, group

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, cond)
        return x
