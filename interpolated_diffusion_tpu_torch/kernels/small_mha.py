"""Packed small-L multi-head attention (port of kernels/small_mha.py).

`small_mha_packed` replaces the TPU kernel
interpolated_diffusion_tpu/kernels/small_mha.py::_kernel_packed (public
small_mha_packed). On CUDA tensors it launches the hand-written sm_90a kernel
in csrc/small_mha.cu; on CPU tensors it runs the plain twin `_torch_attention`
(the same math in PyTorch). There is no fallback between the two: a CUDA
input the kernel does not take raises.

What bounds the kernel on the H100, and what its design does about it, is in
the header of csrc/small_mha.cu. Forward only: gradients come with training.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_L = 256


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


def _rows(t: torch.Tensor) -> int:
    """Row stride (elements) of a [B, L, C] view whose rows are evenly spaced
    and whose last dim is contiguous (e.g. a slice of a fused qkv tensor)."""
    if t.stride(-1) != 1 or t.stride(0) != t.shape[1] * t.stride(1):
        raise ValueError("small_mha_packed: q/k/v rows must be evenly strided "
                         "with a contiguous last dim")
    return t.stride(1)


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only; run under "
                           "torch.no_grad()/inference_mode() (backward comes "
                           "with training)")


def small_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int, group_b: int = 8) -> torch.Tensor:
    """Batch-packed multi-head attention: q/k/v [B, L, H*Dh] -> [B, L, H*Dh].

    `group_b` is the TPU kernel's packing factor, kept for parity; attention
    per (sample, head) gives exactly its result, so the CUDA kernel ignores it.
    """
    if q.device.type == "cpu":
        return _torch_attention(q, k, v, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"small_mha_packed: unsupported device {q.device}")
    check_no_grad("small_mha_packed", q, k, v)
    B, L, HD = q.shape
    dh = HD // n_heads
    if k.shape != q.shape or v.shape != q.shape or HD != n_heads * dh:
        raise ValueError(f"small_mha_packed: bad shapes {q.shape} {k.shape} {v.shape}")
    if any(t.dtype != torch.bfloat16 or t.device != q.device for t in (q, k, v)):
        raise ValueError("small_mha_packed: the CUDA kernel takes bf16 q/k/v on one device")
    if L > MAX_L or dh not in (32, 64):
        raise ValueError(f"small_mha_packed: CUDA kernel needs L <= {MAX_L} and "
                         f"head dim 32 or 64 (got L={L}, Dh={dh})")
    o = torch.empty((B, L, HD), dtype=q.dtype, device=q.device)
    lds = [_rows(q), _rows(k), _rows(v)]
    if any(ld % 8 for ld in lds) or any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("small_mha_packed: the CUDA kernel needs 16-byte aligned rows")
    fn = _build.function("id_small_mha_packed", [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                         + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             B, L, n_heads, dh, *lds, HD,
             dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "small_mha_packed")
    small_mha_packed.launches += 1
    return o


small_mha_packed.launches = 0
