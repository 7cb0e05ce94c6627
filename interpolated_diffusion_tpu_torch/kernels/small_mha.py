"""Small-L multi-head attention (port of kernels/small_mha.py).

`small_mha` replaces the TPU kernel
interpolated_diffusion_tpu/kernels/small_mha.py::_kernel (public small_mha),
`small_mha_packed` replaces ::_kernel_packed (public small_mha_packed). On
CUDA tensors each launches the hand-written sm_90a kernels of
csrc/small_mha.cu; on CPU tensors each runs the plain twin `_torch_attention`
(the same math in PyTorch). There is no fallback between the two: a CUDA
input the kernels do not take raises.

Both entries are `torch.autograd.Function`s with the JAX package's split:
the forward is the kernel, the backward recomputes the plain twin on the
saved q, k, v and differentiates that (the JAX custom_vjp does the same with
its XLA formulation; there is no backward kernel for these shapes). The
`*_twin` entries run the twin forward as well, on any device, for comparisons.

What bounds the kernels on the H100, and what their design does about it, is
in the header of csrc/small_mha.cu.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_L = 256                  # small_mha_packed and fused_film_block: L <= 256
SMALL_MHA_MAX_ROWS = 1024    # small_mha: H * L <= 1024


def _torch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int) -> torch.Tensor:
    """Plain twin on the packed [B, L, H*Dh] layout.

    Products are taken in f32 (exact for bf16 inputs), the row softmax in
    f32, P is rounded to the input dtype, and P.V accumulates in f32 before
    the output is rounded — the TPU kernel's rounding points.
    """
    B, L, HD = q.shape
    dh = HD // n_heads
    heads = lambda t: t.reshape(B, L, n_heads, dh).transpose(1, 2).float()
    logits = heads(q) @ heads(k).transpose(-1, -2) * dh ** -0.5
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = (p.float() @ heads(v)).to(q.dtype)
    return o.transpose(1, 2).reshape(B, L, HD)


def twin_backward(fn, inputs, needs, grad_out):
    """Gradients of the plain twin `fn(*inputs)`: recompute it under autograd
    on detached copies and differentiate (the JAX package's custom_vjp
    backward). `needs[i]` says whether input i wants a gradient; returns one
    entry per input, None where none is wanted."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) if n else t for t, n in zip(inputs, needs)]
        out = fn(*leaves)
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, needs) if n], grad_out,
                                         allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


def _rows(t: torch.Tensor, name: str) -> int:
    """Row stride (elements) of a [B, L, C] view whose rows are evenly spaced
    and whose last dim is contiguous (e.g. a slice of a fused qkv tensor)."""
    if t.stride(-1) != 1 or t.stride(0) != t.shape[1] * t.stride(1):
        raise ValueError(f"{name}: q/k/v rows must be evenly strided with a contiguous last dim")
    return t.stride(1)


def _launch(name: str, entry: str, q, k, v, n_heads: int) -> torch.Tensor:
    """Checks shared by both entries, then one launch of the C entry `entry`."""
    B, L, HD = q.shape
    dh = HD // n_heads
    if k.shape != q.shape or v.shape != q.shape or HD != n_heads * dh:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape}")
    if any(t.dtype != torch.bfloat16 or t.device != q.device for t in (q, k, v)):
        raise ValueError(f"{name}: the CUDA kernel takes bf16 q/k/v on one device")
    if dh not in (32, 64):
        raise ValueError(f"{name}: the CUDA kernel needs head dim 32 or 64 "
                         f"(got q {tuple(q.shape)}, H={n_heads}, Dh={dh})")
    o = torch.empty((B, L, HD), dtype=q.dtype, device=q.device)
    lds = [_rows(t, name) for t in (q, k, v)]
    if any(ld % 8 for ld in lds) or any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError(f"{name}: the CUDA kernel needs 16-byte aligned rows")
    fn = _build.function(entry, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                         + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             B, L, n_heads, dh, *lds, HD,
             dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    return o


def _forward(q, k, v, n_heads: int, packed: bool, twin: bool) -> torch.Tensor:
    name = "small_mha_packed" if packed else "small_mha"
    if twin or q.device.type == "cpu":
        return _torch_attention(q, k, v, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    L = q.shape[1]
    if packed:
        if L > MAX_L:
            raise ValueError(f"small_mha_packed: CUDA kernel needs L <= {MAX_L} "
                             f"(got q {tuple(q.shape)})")
        o = _launch(name, "id_small_mha_packed", q, k, v, n_heads)
        small_mha_packed.launches += 1
    else:
        if n_heads * L > SMALL_MHA_MAX_ROWS:
            raise ValueError(f"small_mha: CUDA kernel needs H*L <= {SMALL_MHA_MAX_ROWS} "
                             f"(got q {tuple(q.shape)}, H={n_heads})")
        o = _launch(name, "id_small_mha", q, k, v, n_heads)
        small_mha.launches += 1
    return o


class _SmallMHA(torch.autograd.Function):
    """Forward: the kernel (or the twin). Backward: the twin, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, packed, twin):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads = n_heads
        return _forward(q, k, v, n_heads, packed, twin)

    @staticmethod
    def backward(ctx, do):
        n_heads = ctx.n_heads
        dq, dk, dv = twin_backward(lambda q, k, v: backward_twin(q, k, v, n_heads),
                                   ctx.saved_tensors, ctx.needs_input_grad[:3], do)
        return dq, dk, dv, None, None, None


def backward_twin(q, k, v, n_heads: int) -> torch.Tensor:
    """The twin as the backward recomputes it (a name of its own, so that a
    run can tell a recompute in backward from a twin call in forward)."""
    return _torch_attention(q, k, v, n_heads)


def small_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Multi-head attention, no mask: q/k/v [B, L, H*Dh] -> [B, L, H*Dh].

    The TPU kernel's window is H*L <= 1024; the CUDA kernels take it whole for
    head dims 32 and 64 (L <= 256 in one block per head, longer sequences
    tiled over queries and keys with an online softmax, which rounds
    P = exp(s - running max) to bf16 before the sum divides) and raise on
    other head dims.
    """
    return _SmallMHA.apply(q, k, v, n_heads, False, False)


def small_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int) -> torch.Tensor:
    """Batch-packed multi-head attention: q/k/v [B, L, H*Dh] -> [B, L, H*Dh].

    The TPU kernel's packing factor `group_b` has no counterpart: attention
    per (sample, head) gives exactly its result.
    """
    return _SmallMHA.apply(q, k, v, n_heads, True, False)


def small_mha_twin(q, k, v, n_heads: int) -> torch.Tensor:
    """`small_mha` with the plain twin as forward, on any device."""
    return _SmallMHA.apply(q, k, v, n_heads, False, True)


def small_mha_packed_twin(q, k, v, n_heads: int) -> torch.Tensor:
    """`small_mha_packed` with the plain twin as forward, on any device."""
    return _SmallMHA.apply(q, k, v, n_heads, True, True)


small_mha.launches = 0          # launches through small_mha
small_mha_packed.launches = 0   # launches through small_mha_packed
