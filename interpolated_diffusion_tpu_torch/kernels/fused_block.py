"""Fused FiLM pre-norm transformer block (port of kernels/fused_block.py).

`fused_film_block` replaces the TPU kernel
interpolated_diffusion_tpu/kernels/fused_block.py::_kernel (public
fused_film_block). On CUDA tensors it launches the chain of hand-written
sm_90a kernels in csrc/fused_block.cu (LN+FiLM, a bf16 GEMM with bias /
SiLU / residual epilogues, and the attention kernel of csrc/small_mha.cu); on
CPU tensors it runs the plain twin `_torch_block`. There is no fallback
between the two: a CUDA input the kernels do not take raises.

Weights are in the torch Linear layout [out, in] (the JAX function takes the
flax [in, out] kernels). On CUDA every tensor is bf16, as the port's bf16
models hold them; the kernels read biases and LN parameters into f32, which
is exact, as the plain twin does. What bounds the kernels on the H100, and
what the design does about it, is in the header of csrc/fused_block.cu.
Forward only: gradients come with training.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .small_mha import MAX_L, check_no_grad

LN_EPS = 1e-6


def _ln_film(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             gb: Optional[torch.Tensor], eps: float = LN_EPS) -> torch.Tensor:
    """f32 LayerNorm (E[x^2] - mu^2) over the last axis + per-sample FiLM.
    x [B, L, D], gb [B, 2D] (gamma|beta) or None. Returns f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    h = (xf - mu) * torch.rsqrt(var + eps)
    h = h * scale.float() + bias.float()
    if gb is not None:
        D = x.shape[-1]
        h = h * (1.0 + gb[:, None, :D].float()) + gb[:, None, D:].float()
    return h


def _torch_block(x, gb1, gb2, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wout, bout,
                 wff1, bff1, wff2, bff2, n_heads: int, use_film: bool) -> torch.Tensor:
    """Plain twin of the kernel chain (same math and rounding points).

    Products run in f32 on operands rounded to x.dtype, so with bf16 inputs
    they equal bf16 products with f32 accumulation. h, qkv, p, o and the SiLU
    output are rounded to x.dtype; the residual stream x2 stays f32.
    """
    B, L, D = x.shape
    cdt = x.dtype
    lin = lambda a, w, b: a.float() @ w.to(cdt).float().t() + b.float()
    h = _ln_film(x, ln1s, ln1b, gb1 if use_film else None).to(cdt)
    qkv = lin(h, wqkv, bqkv).to(cdt)
    dh = D // n_heads
    heads = lambda t: t.reshape(B, L, n_heads, dh).transpose(1, 2).float()
    logits = heads(qkv[..., :D]) @ heads(qkv[..., D:2 * D]).transpose(-1, -2) * dh ** -0.5
    p = torch.softmax(logits, dim=-1).to(cdt)
    o = (p.float() @ heads(qkv[..., 2 * D:])).transpose(1, 2).reshape(B, L, D).to(cdt)
    x2 = x.float() + lin(o, wout, bout)
    h2 = _ln_film(x2, ln2s, ln2b, gb2 if use_film else None).to(cdt)
    f = lin(h2, wff1, bff1)
    f = (f * torch.sigmoid(f)).to(cdt)
    return (x2 + lin(f, wff2, bff2)).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def fused_film_block(x, gb1, gb2, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wout, bout,
                     wff1, bff1, wff2, bff2, n_heads: int, group_b: int = 8,
                     use_film: bool = True) -> torch.Tensor:
    """One FiLM pre-norm block: x [B, L, D] -> [B, L, D].

    gb1/gb2 are the per-sample FiLM (gamma|beta) rows [B, 2D] (zeros with
    use_film=False). wqkv [3D, D], wout [D, D], wff1 [F, D], wff2 [D, F] in
    the torch Linear layout. `group_b` is the TPU kernel's batch-packing
    factor, kept for parity; per-sample attention gives exactly its result,
    so the CUDA path ignores it.
    """
    args = (gb1, gb2, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wout, bout,
            wff1, bff1, wff2, bff2)
    if x.device.type == "cpu":
        return _torch_block(x, *args, n_heads=n_heads, use_film=use_film)
    if x.device.type != "cuda":
        raise ValueError(f"fused_film_block: unsupported device {x.device}")
    check_no_grad("fused_film_block", x, *args)
    B, L, D = x.shape
    F = wff1.shape[0]
    dh = D // n_heads
    if D % 64 or F % 64 or D != n_heads * dh or dh not in (32, 64) or L > MAX_L:
        raise ValueError(f"fused_film_block: CUDA kernels need D and F multiples of 64, "
                         f"head dim 32 or 64 and L <= {MAX_L} (got D={D}, F={F}, "
                         f"H={n_heads}, L={L})")
    if -(-B * L // 128) > 65535:
        raise ValueError("fused_film_block: B*L too large for one launch")
    shapes = {"x": (B, L, D), "gb1": (B, 2 * D), "gb2": (B, 2 * D), "ln1s": (D,),
              "ln1b": (D,), "ln2s": (D,), "ln2b": (D,), "wqkv": (3 * D, D), "bqkv": (3 * D,),
              "wout": (D, D), "bout": (D,), "wff1": (F, D), "bff1": (F,), "wff2": (D, F),
              "bff2": (D,)}
    for (name, shape), t in zip(shapes.items(), (x, *args)):
        if tuple(t.shape) != shape or t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"fused_film_block: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; the CUDA kernels take bf16 {shape} on {x.device}")
    ins = [t.contiguous() for t in (x, *args)]
    M = B * L
    empty = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, dtype=dtype,
                                                             device=x.device)
    h, qkv, o = empty(M, D), empty(M, 3 * D), empty(M, D)
    x2, f, y = empty(M, D, dtype=torch.float32), empty(M, F), empty(B, L, D)
    bufs = [h, qkv, o, x2, f, y]
    if any(t.data_ptr() % 16 for t in ins + bufs):
        raise ValueError("fused_film_block: CUDA kernels need 16-byte aligned tensors")
    fn = _build.function("id_fused_film_block", _ARGTYPES)
    err = fn(*[t.data_ptr() for t in ins + bufs], B, L, D, n_heads, F,
             int(bool(use_film)), dh ** -0.5,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_film_block")
    fused_film_block.launches += 1
    return y


fused_film_block.launches = 0
