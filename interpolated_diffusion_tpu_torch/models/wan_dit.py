"""Wan2.1-style video DiT (port of models/wan_dit.py).

Patch embed (1, 2, 2), adaLN-zero blocks with per-block scale-shift tables,
RMS-normed q/k, 3D RoPE with the Wan t/h/w head-dim split (absolute-time
frame indices as a forward argument), cross-attention to text (plus optional
extra context tokens), runtime-form LoRA, and a head modulated by the time
embedding. `ffn_mode="moe"` makes every block's FFN the Switch-MoE FFN
(models/moe.py; `n_experts`, `capacity_factor`), whose aux loss the block
keeps in `moe_aux`. The compute dtype is the parameters' dtype unless
`set_compute_dtype` names another, and every module honours it: the trainer
keeps its trainable leaves (the LoRA and frame-conditioning leaves, or with
lora_rank 0 every weight) as f32 masters and computes in bf16, casting them
per call, so that their gradients arrive in f32.

Attention dispatch is the JAX package's: attn_mode "sla" / "sage_sla" route
self-attention through SparseLinearAttention (bf16 or int8 sparse kernel);
any other attention with L >= 2048 queries goes through the flash kernel;
the rest is plain dense attention. The q / k RMSNorm and RoPE go through
kernels/qk_norm_rope (one kernel each way on CUDA tensors, its plain twin on
the CPU), except under tensor parallelism, which keeps RMSNorm and apply_rope.
Each block's three LayerNorms with their modulation (norm1 and norm3 adaLN,
the affine norm2) and the head's go through kernels/ln_modulate likewise.

Module names follow the diffusers WanTransformer3DModel state dict
(models/wan_convert.py lists the map) so that a Wan2.1 checkpoint maps
straight on. Leaves diffusers does not have sit under names of their own:
`*.lora_A` / `*.lora_B` beside each adapted Linear, `attn1.sla.proj_l`, and
`condition_embedder.extra_embedder` (the JAX package's extra_fc1/extra_fc2).
LoRA runs in either of the JAX package's forms on the same leaves: "runtime"
adds (a/r)(x A^T) B^T to the activations, "merged" adds ((B A)(a/r)) rounded
to the weight's dtype to the weight, the rounding point of its
models/lora.apply_lora. One Python loop of blocks, under one activation
checkpoint per `remat_group` blocks with use_remat; the JAX package's scan
layout is a parameter layout only (models/jax_import reads it). FORA block
caching for sampling: `return_delta` also returns the block stack's total
residual, `blocks_delta` skips the stack and adds a cached one.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.block_sparse_attention import flash_attention
from ..kernels.ln_modulate import ln_modulate
from ..kernels.qk_norm_rope import apply_rope, qk_norm_rope, rms_norm
from ..kernels.sla import SparseLinearAttention
from ..kernels.tuning import sla_blocks
from .denoisers import timestep_embedding
from .moe import SwitchFFN
from .transformer import LayerNorm, dense_attention, set_compute_dtype  # noqa: F401

ATTN_MODES = ("dense", "flash", "sla", "sage_sla")
FLASH_MIN_L = 2048  # queries from which attention goes through the flash kernel
FLASH_BLOCKS = (512, 1024)  # the JAX flash tiles (kernels/tuning.flash_blocks defaults)


# ---------------------------------------------------------------------------
# 3D rotary embeddings (Wan head-dim split: h = w = 2 * (d // 6), t = rest)
# ---------------------------------------------------------------------------

def wan_rope_tables(max_seq_len: int, head_dim: int, theta: float = 10000.0,
                    device=None, dims: Optional[Tuple[int, int, int]] = None
                    ) -> Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                               Tuple[int, int, int]]:
    """Per-axis (t, h, w) cos/sin tables, each [max_seq_len, axis_dim / 2] f32;
    the axis widths are `dims`, or Wan's split of head_dim."""
    h_dim = 2 * (head_dim // 6)
    w_dim = h_dim
    t_dim = head_dim - h_dim - w_dim
    if dims is not None:
        t_dim, h_dim, w_dim = dims
    tables = {}
    for name, dim in (("t", t_dim), ("h", h_dim), ("w", w_dim)):
        freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                              device=device) / dim))
        angles = torch.arange(max_seq_len, dtype=torch.float32, device=device)[:, None] * freqs
        tables[name] = (torch.cos(angles), torch.sin(angles))
    return tables, (t_dim, h_dim, w_dim)


def build_rope_freqs(tables, dims: Tuple[int, int, int], ppf: int, pph: int, ppw: int,
                     frame_indices: Optional[torch.Tensor] = None):
    """Per-token (cos, sin), each [B or 1, ppf*pph*ppw, head_dim / 2].

    frame_indices [B, ppf] gives absolute-time RoPE: short K-frame inputs keep
    the positions of the frames they were taken from.
    """
    t_dim, h_dim, w_dim = dims
    out = []
    for part in (0, 1):  # cos, sin
        tt, ht, wt = tables["t"][part], tables["h"][part], tables["w"][part]
        tsel = tt[frame_indices.long()] if frame_indices is not None else tt[:ppf][None]
        B = tsel.shape[0]
        shape = (B, ppf, pph, ppw)
        pieces = [tsel[:, :, None, None, :].expand(*shape, t_dim // 2),
                  ht[:pph][None, None, :, None, :].expand(*shape, h_dim // 2),
                  wt[:ppw][None, None, None, :, :].expand(*shape, w_dim // 2)]
        out.append(torch.cat(pieces, dim=-1).reshape(B, ppf * pph * ppw, -1))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


class LoRALinear(nn.Linear):
    """Linear with low-rank adaptation, A [r, in] and B [out, r] (torch's
    layout; the JAX package stores their transposes), B zero-initialised.

    form "runtime": y = x W^T + b + (a/r)(x A^T) B^T, the delta applied to the
    activations (A, B and x cast to the compute dtype), so the base weight is
    never duplicated. form "merged": y = x W'^T + b with W' = W +
    ((B A)(a/r)).to(W.dtype), the product in f32 and the sum in the weight's
    dtype, as the JAX package's models/lora.apply_lora merges its adapter tree.
    """

    zero_init_params = ("lora_B",)
    compute_dtype: Optional[torch.dtype] = None
    tp_mode: Optional[str] = None   # "column" / "row" under parallel/tp.apply_tp
    tp_group = None

    def __init__(self, in_features: int, out_features: int, rank: int = 0,
                 alpha: float = 16.0, form: str = "runtime"):
        super().__init__(in_features, out_features)
        if form not in ("runtime", "merged"):
            raise ValueError(f"LoRA form {form!r} not in ('runtime', 'merged')")
        self.rank, self.alpha, self.form = rank, alpha, form
        if rank > 0:
            self.lora_A = nn.Parameter(torch.empty(rank, in_features))
            self.lora_B = nn.Parameter(torch.empty(out_features, rank))

    def init_seeded(self, uniform_) -> None:
        bound = self.in_features ** -0.5
        uniform_(self.weight, bound)
        uniform_(self.bias, bound)
        if self.rank > 0:
            uniform_(self.lora_A, math.sqrt(3.0) / self.rank)  # std 1/r, as the JAX init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.weight.dtype
        x = x.to(dtype)   # keep the residual stream in the compute dtype
        if self.tp_mode is not None:
            return self._tp_forward(x, dtype)
        if self.rank > 0 and self.form == "merged":
            delta = (self.lora_B.float() @ self.lora_A.float()) * (self.alpha / float(self.rank))
            weight = self.weight + delta.to(self.weight.dtype)
            return F.linear(x, weight.to(dtype), self.bias.to(dtype))
        y = _linear(self, x, dtype)
        if self.rank <= 0:
            return y
        delta = (x @ self.lora_A.to(dtype).t()) @ self.lora_B.to(dtype).t()
        return y + delta * (self.alpha / float(self.rank))

    def _tp_forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Megatron's split (parallel/tp.py): "column" holds a slice of the
        output features (weight rows, bias, lora_B rows) and takes the whole
        input; "row" holds a slice of the input features (weight columns,
        lora_A columns), sums the partial outputs over the group and adds the
        whole bias once. Runtime LoRA only."""
        from ..parallel.collectives import copy_to, reduce_from

        g = self.tp_group
        a = self.alpha / float(max(self.rank, 1))
        if self.tp_mode == "column":
            y = _linear(self, copy_to(x, g), dtype)
            if self.rank > 0:
                z = copy_to(x @ self.lora_A.to(dtype).t(), g)
                y = y + (z @ self.lora_B.to(dtype).t()) * a
            return y
        y = reduce_from(F.linear(x, self.weight.to(dtype)), g)
        if self.rank > 0:
            z = reduce_from(x @ self.lora_A.to(dtype).t(), g)
            y = y + (z @ self.lora_B.to(dtype).t()) * a
        return y + self.bias.to(dtype)


class RMSNorm(nn.Module):
    """f32 mean square, x * rsqrt(ms + eps) rounded to the compute dtype,
    then times the scale cast to it (eps 1e-6)."""

    compute_dtype: Optional[torch.dtype] = None
    tp_group = None       # features split over this group (parallel/tp.py)

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps, self.dim = eps, dim
        self.weight = nn.Parameter(torch.ones(dim))

    def init_seeded(self, uniform_) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = None
        if self.tp_group is not None:   # the mean square over every member's features
            from ..parallel.collectives import psum

            var = psum(x.float().square().sum(dim=-1, keepdim=True), self.tp_group) / self.dim
        return rms_norm(x, self.weight, self.eps, self.compute_dtype or self.weight.dtype, var)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu(approximate=True)


class WanAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, attn_mode: str = "dense",
                 sla_topk: float = 0.1, sla_block: int = 128, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_form: str = "runtime"):
        super().__init__()
        if attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode {attn_mode!r} not in {ATTN_MODES}")
        self.dim, self.n_heads = dim, n_heads
        lora = (lora_rank, lora_alpha, lora_form)
        self.to_q = LoRALinear(dim, dim, *lora)
        self.to_k = LoRALinear(dim, dim, *lora)
        self.to_v = LoRALinear(dim, dim, *lora)
        self.to_out = nn.ModuleList([LoRALinear(dim, dim, *lora)])
        self.norm_q = RMSNorm(dim)
        self.norm_k = RMSNorm(dim)
        self.sla, self.sla_block = None, sla_block
        if attn_mode in ("sla", "sage_sla"):
            self.sla = SparseLinearAttention(dim // n_heads, topk=sla_topk, block_q=sla_block,
                                             block_k=sla_block)
        self.set_attn_mode(attn_mode)

    def set_attn_mode(self, mode: str) -> None:
        """Switch the attention path; the weights are the same for every mode
        (the sparse modes need the SLA projection this module was built with)."""
        if mode not in ATTN_MODES:
            raise ValueError(f"attn_mode {mode!r} not in {ATTN_MODES}")
        if mode in ("sla", "sage_sla"):
            if self.sla is None:
                raise ValueError(f"attn_mode {mode!r} needs a module built in sla or sage_sla mode")
            self.sla.quant = "int8" if mode == "sage_sla" else "none"
        self.attn_mode = mode

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                rope=None) -> torch.Tensor:
        B, L, _ = x.shape
        H, Dh = self.n_heads, self.dim // self.n_heads
        kv_src = x if context is None else context
        Lk = kv_src.shape[1]
        q, k = self.to_q(x), self.to_k(kv_src)
        if self.norm_q.tp_group is None:
            # one kernel a norm on the card (kernels/qk_norm_rope; its twin on
            # the CPU), in q's dtype, the norms' compute dtype; with RoPE q / k
            # come out head-major. Tensor parallelism keeps the chain: its mean
            # square is summed over the group.
            cs = rope if rope is not None else (None, None)
            q = qk_norm_rope(q, self.norm_q.weight, *cs, n_heads=H, eps=self.norm_q.eps)
            k = qk_norm_rope(k, self.norm_k.weight, *cs, n_heads=H, eps=self.norm_k.eps)
            if rope is None:
                q = q.reshape(B, L, H, Dh).transpose(1, 2)
                k = k.reshape(B, Lk, H, Dh).transpose(1, 2)
        else:
            q = self.norm_q(q).reshape(B, L, H, Dh).transpose(1, 2)
            k = self.norm_k(k).reshape(B, Lk, H, Dh).transpose(1, 2)
            if rope is not None:
                q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        v = self.to_v(kv_src).reshape(B, Lk, H, Dh).transpose(1, 2)
        if self.attn_mode in ("sla", "sage_sla") and context is None:
            # the registry's block where it applies at this L (kernels/tuning.py)
            blk = sla_blocks(default=self.sla_block, quant=self.sla.quant, L=L)
            out = self.sla(q, k, v, block=blk).transpose(1, 2).reshape(B, L, self.dim)
        elif L >= FLASH_MIN_L:
            # the JAX package's default tiles (key tile cut to Lk): they set
            # where the twin rounds P, not what the kernel does
            bm, bn = FLASH_BLOCKS
            bn = bn if Lk >= bn else max(128, -(-Lk // 128) * 128)
            # at B = 1 the head split is a strided view: the kernel takes contiguous rows
            heads = lambda t, n: t.reshape(B * H, n, Dh).to(torch.bfloat16).contiguous()
            out = flash_attention(heads(q, L), heads(k, Lk), heads(v, Lk), bm, bn)
            out = out.reshape(B, H, L, Dh).to(q.dtype).transpose(1, 2).reshape(B, L, self.dim)
        else:
            packed = lambda t: t.transpose(1, 2).reshape(B, t.shape[2], self.dim)
            out = dense_attention(packed(q), packed(k), packed(v), H)
        return self.to_out[0](out)


class _GeluProj(nn.Module):
    def __init__(self, d_in: int, d_out: int, rank: int, alpha: float, form: str):
        super().__init__()
        self.proj = LoRALinear(d_in, d_out, rank, alpha, form)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gelu(self.proj(x))


class FeedForward(nn.Module):
    """diffusers' FeedForward layout: net.0.proj, (net.1 dropout), net.2."""

    def __init__(self, dim: int, ffn_dim: int, rank: int = 0, alpha: float = 16.0,
                 form: str = "runtime"):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(dim, ffn_dim, rank, alpha, form), nn.Identity(),
                                  LoRALinear(ffn_dim, dim, rank, alpha, form)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class WanBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, ffn_dim: int, attn_mode: str = "dense",
                 sla_topk: float = 0.1, sla_block: int = 256, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_targets: str = "attn,ffn",
                 ffn_mode: str = "dense", lora_form: str = "runtime", n_experts: int = 8,
                 capacity_factor: float = 1.25):
        super().__init__()
        if ffn_mode not in ("dense", "moe"):
            raise ValueError(f"ffn_mode {ffn_mode!r} not in ('dense', 'moe')")
        targets = {t.strip() for t in lora_targets.split(",")}
        r_attn = lora_rank if "attn" in targets else 0
        r_ffn = lora_rank if "ffn" in targets else 0
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, dim))
        self.attn1 = WanAttention(dim, n_heads, attn_mode, sla_topk, sla_block, r_attn,
                                  lora_alpha, lora_form)
        self.norm2 = LayerNorm(dim)
        self.attn2 = WanAttention(dim, n_heads, "dense", lora_rank=r_attn, lora_alpha=lora_alpha,
                                  lora_form=lora_form)
        if ffn_mode == "moe":   # Switch top-1 experts (no LoRA on them, as in JAX)
            self.moe_ffn = SwitchFFN(dim, ffn_dim, n_experts, capacity_factor)
            self.moe_aux: Optional[torch.Tensor] = None   # the JAX block's sown aux loss
        else:
            self.ffn = FeedForward(dim, ffn_dim, r_ffn, lora_alpha, lora_form)

    def init_seeded(self, uniform_) -> None:
        uniform_(self.scale_shift_table, 0.02 * math.sqrt(3.0))  # std 0.02, as the JAX init

    def forward(self, x, context, t_mod, rope):
        dtype = x.dtype
        # rows of mod: shift1, scale1, gate1, shift2, scale2, gate2
        mod = self.scale_shift_table.float() + t_mod.float()
        gate1, gate2 = (mod[:, i][:, None, :].to(dtype) for i in (2, 5))
        h = ln_modulate(x, mod[:, 1], mod[:, 0], form="adaln")
        x = x + gate1 * self.attn1(h, rope=rope)
        n2 = self.norm2
        x = x + self.attn2(ln_modulate(x, n2.weight, n2.bias, form="affine", eps=n2.eps),
                           context=context)
        h = ln_modulate(x, mod[:, 4], mod[:, 3], form="adaln")
        if hasattr(self, "moe_ffn"):
            h, aux = self.moe_ffn(h)
            self.moe_aux = aux.detach()
            return x + gate2 * h
        return x + gate2 * self.ffn(h)


class _MLP(nn.Module):
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, d_in: int, d_out: int, act):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d_out)
        self.linear_2 = nn.Linear(d_out, d_out)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.linear_1.weight.dtype
        return _linear(self.linear_2, self.act(_linear(self.linear_1, x.to(dtype), dtype)), dtype)


class WanConditionEmbedder(nn.Module):
    """Time MLP (+ the 6-way projection to the block modulations) and text
    MLP, under diffusers' names; `extra_embedder` maps extra context tokens
    (frame conditioning) into the same space."""

    def __init__(self, dim: int, freq_dim: int, text_dim: int, extra_context: bool):
        super().__init__()
        self.freq_dim = freq_dim
        self.time_embedder = _MLP(freq_dim, dim, F.silu)
        self.time_proj = nn.Linear(dim, 6 * dim)
        self.text_embedder = _MLP(text_dim, dim, _gelu)
        self.extra_embedder = _MLP(text_dim, dim, _gelu) if extra_context else None


class FrameCondProjector(nn.Module):
    """Per-frame features [B, T, F] -> extra cross-attention tokens
    [B, T, text_dim]; the output layer is zero-initialised so that an
    untrained projector leaves the cross-attention undisturbed."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, feat_dim: int, text_dim: int, hidden_dim: int = 256, n_layers: int = 2):
        super().__init__()
        self.n_hidden = max(0, n_layers - 1)
        for i in range(self.n_hidden):
            setattr(self, f"fc_{i}", nn.Linear(feat_dim if i == 0 else hidden_dim, hidden_dim))
        self.out = nn.Linear(hidden_dim if self.n_hidden else feat_dim, text_dim)
        self.out.zero_init = True

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.out.weight.dtype
        h = feat.to(dtype)
        for i in range(self.n_hidden):
            h = _gelu(_linear(getattr(self, f"fc_{i}"), h, dtype))
        return _linear(self.out, h, dtype)


class WanDiT(nn.Module):
    """Video diffusion transformer over [B, C, T, H, W] latents.

    Defaults are the Wan2.1-T2V-1.3B family (dim 1536, 30 blocks, 12 heads,
    ffn 8960, text dim 4096, patch (1, 2, 2), head dim 128). extra_context
    creates the extra-token MLP that FrameCondProjector's output goes through.
    use_remat recomputes the blocks' forward in the backward pass (one
    non-reentrant activation checkpoint per `remat_group` consecutive blocks),
    so that a training step keeps one [B, L, dim] tensor per group instead of
    every intermediate. lora_form "runtime" or "merged" (LoRALinear).
    """

    compute_dtype: Optional[torch.dtype] = None
    # (x, ctx, t_mod, rope) -> x in place of the block stack (models/wan_pp.py)
    blocks_fn = None

    def __init__(self, dim: int = 1536, n_layers: int = 30, n_heads: int = 12,
                 ffn_dim: int = 8960, in_channels: int = 16, out_channels: int = 16,
                 text_dim: int = 4096, patch_size: Tuple[int, int, int] = (1, 2, 2),
                 max_seq_len: int = 1024, freq_dim: int = 256, attn_mode: str = "dense",
                 sla_topk: float = 0.1, sla_block: int = 256, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_targets: str = "attn,ffn",
                 ffn_mode: str = "dense", extra_context: bool = False,
                 use_remat: bool = False, remat_group: int = 1, lora_form: str = "runtime",
                 n_experts: int = 8, capacity_factor: float = 1.25):
        super().__init__()
        self.dim, self.n_heads, self.out_channels = dim, n_heads, out_channels
        self.use_remat, self.remat_group = use_remat, max(1, int(remat_group))
        self.patch_size, self.max_seq_len = tuple(patch_size), max_seq_len
        # a Conv3d-shaped weight [dim, C, pt, ph, pw]; stride == kernel, so it
        # runs as reshape + linear (no convolution)
        self.patch_embedding = nn.Conv3d(in_channels, dim, self.patch_size,
                                         stride=self.patch_size)
        self.condition_embedder = WanConditionEmbedder(dim, freq_dim, text_dim, extra_context)
        self.blocks = nn.ModuleList([
            WanBlock(dim, n_heads, ffn_dim, attn_mode, sla_topk, sla_block, lora_rank,
                     lora_alpha, lora_targets, ffn_mode, lora_form, n_experts, capacity_factor)
            for _ in range(n_layers)])
        self.scale_shift_table = nn.Parameter(torch.empty(1, 2, dim))
        self.proj_out = nn.Linear(dim, out_channels * math.prod(self.patch_size))

    def init_seeded(self, uniform_) -> None:
        uniform_(self.scale_shift_table, 0.02 * math.sqrt(3.0))

    def set_attn_mode(self, mode: str) -> None:
        """Self-attention path of every block (the precompute CLI's
        --attn_mode override: attention weights do not depend on the mode)."""
        for block in self.blocks:
            block.attn1.set_attn_mode(mode)

    def set_sla_topk(self, topk: float) -> None:
        """The SLA top-k ratio of every block (the precompute CLI's per-phase
        --sla_topk_schedule: the weights do not depend on it)."""
        for block in self.blocks:
            if block.attn1.sla is None:
                raise ValueError("set_sla_topk needs a model built in sla or sage_sla mode")
            block.attn1.sla.topk = topk

    def _run_blocks(self, x, ctx, t_mod, rope):
        blocks = list(self.blocks)
        if not (self.use_remat and torch.is_grad_enabled()):
            for block in blocks:
                x = block(x, ctx, t_mod, rope)
            return x

        def group(x, ctx, t_mod, rope, members):
            for block in members:
                x = block(x, ctx, t_mod, rope)
            return x

        for i in range(0, len(blocks), self.remat_group):
            # non-reentrant: with only LoRA leaves training, the tokens
            # entering the first block require no gradient
            x = checkpoint(group, x, ctx, t_mod, rope, blocks[i:i + self.remat_group],
                           use_reentrant=False, preserve_rng_state=False)
        return x

    def forward(self, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                frame_indices: Optional[torch.Tensor] = None,
                extra_context: Optional[torch.Tensor] = None,
                blocks_delta: Optional[torch.Tensor] = None, return_delta: bool = False):
        """latents [B, C, T, H, W], t [B], context [B, L_text, text_dim],
        frame_indices [B, T] (absolute-time RoPE), extra_context
        [B, L_extra, text_dim] -> [B, C_out, T, H, W] float32.

        FORA-style block caching for sampling: `return_delta` also returns
        the block stack's residual x_blocks - x_embed [B, L, dim] (compute
        dtype); `blocks_delta` skips every block and adds that residual to the
        fresh token embedding, while the conditioning and the time-modulated
        head still run. Training never uses it."""
        dtype = self.compute_dtype or self.proj_out.weight.dtype
        B, C, T, H, W = latents.shape
        pt, ph, pw = self.patch_size
        ppf, pph, ppw = T // pt, H // ph, W // pw
        ce = self.condition_embedder

        z = latents.reshape(B, C, ppf, pt, pph, ph, ppw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        z = z.reshape(B, ppf * pph * ppw, C * pt * ph * pw)
        x = F.linear(z.to(dtype), self.patch_embedding.weight.flatten(1).to(dtype),
                     self.patch_embedding.bias.to(dtype))

        t_emb = ce.time_embedder(timestep_embedding(t, ce.freq_dim).to(dtype))
        t_mod = _linear(ce.time_proj, F.silu(t_emb), dtype).reshape(B, 6, self.dim)
        ctx = ce.text_embedder(context)
        if extra_context is not None:
            if ce.extra_embedder is None:
                raise ValueError("extra_context given to a WanDiT built without extra_context")
            ctx = torch.cat([ctx, ce.extra_embedder(extra_context)], dim=1)

        if frame_indices is not None and pt != 1:
            frame_indices = frame_indices // pt
        tables, dims = wan_rope_tables(self.max_seq_len, self.dim // self.n_heads,
                                       device=latents.device)
        rope = build_rope_freqs(tables, dims, ppf, pph, ppw, frame_indices)

        x_embed = x
        if blocks_delta is not None:
            x = x_embed + blocks_delta.to(x.dtype)
        elif self.blocks_fn is not None:
            x = self.blocks_fn(x, ctx, t_mod, rope)
        else:
            x = self._run_blocks(x, ctx, t_mod, rope)
        delta = x - x_embed if return_delta else None

        # head: modulated by the time embedding itself (diffusers Wan semantics)
        mod = self.scale_shift_table.float() + t_emb[:, None].float()   # shift, scale
        h = ln_modulate(x, mod[:, 1], mod[:, 0], form="adaln")
        x = _linear(self.proj_out, h, dtype)
        x = x.reshape(B, ppf, pph, ppw, self.out_channels, pt, ph, pw)
        x = x.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(B, self.out_channels, T, H, W)
        return (x.float(), delta) if return_delta else x.float()
