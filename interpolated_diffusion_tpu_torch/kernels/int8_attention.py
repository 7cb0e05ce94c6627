"""Int8-quantized block-sparse attention (port of kernels/int8_attention.py):
the SageSLA analogue, with its straight-through backward.

`quantize_rows` gives per-row symmetric int8 (absmax / 127, round half to
even, clip to +-127). `int8_block_sparse_attention` quantizes Q, and K after
subtracting its per-channel mean (smooth-k, softmax-invariant), in plain
PyTorch as the JAX package does, then runs the kernel: int32 Q K^T rescaled
by the outer product of the row scales, bf16 P.V over the same LUT.

On CUDA tensors the kernel is the hand-written sm_90a `sla_fwd_kernel<D,
true>` of csrc/sla_fwd_sm90.cu (s8 wgmma for Q K^T; replacing the TPU kernel
_fwd_kernel_int8, :48); on CPU tensors its plain twin
`_torch_int8_attention`. A CUDA input the kernel does not take raises.

The backward is straight-through (the JAX package's bwd_recompute=True): it
re-runs the bf16 SLA forward for a consistent (o, lse) and then the SLA
backward kernels on the unquantized q, k, v (the quantized forward's lse
would rescale every recomputed softmax row by exp2(lse_int8 - lse_bf16)).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .block_sparse_attention import (_check_lut, _stream, block_sparse_attention_bwd,
                                     block_sparse_attention_fwd, check_cuda_inputs)
from .block_sparse_reference import LOG2E, block_sparse_attention_reference


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (x_i8 [..., L, D], scales [..., L] f32)."""
    xf = x.float()
    scales = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    x_i8 = torch.clamp(torch.round(xf / scales[..., None]), -127, 127).to(torch.int8)
    return x_i8, scales


def _torch_int8_attention(q_i8, k_i8, v, q_scale, k_scale, lut, block_m: int, block_n: int,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the int8 kernel, in the TPU kernel's order and rounding.

    For each LUT entry j in turn (vectorised over heads and query blocks):
    logits = (Q_i8 K_i8^T, exact in f32 while |sum| < 2^24 and TF32 is off)
    * (sq sk^T) * scale * log2(e); keys >= L masked; online softmax in exp2
    with f32 max / sum, P rounded to v's dtype for P.V with f32 accumulation.
    Returns (o in v's dtype, lse f32 base 2).
    """
    BH, L, D = q_i8.shape
    Lk = k_i8.shape[1]
    M, topk = lut.shape[1], lut.shape[2]
    nb = -(-Lk // block_n)
    pad_q, pad_k = M * block_m - L, nb * block_n - Lk
    qb = F.pad(q_i8.float(), (0, 0, 0, pad_q)).reshape(BH, M, block_m, D)
    kb = F.pad(k_i8.float(), (0, 0, 0, pad_k)).reshape(BH, nb, block_n, D)
    vb = F.pad(v, (0, 0, 0, pad_k)).reshape(BH, nb, block_n, D)
    qs = F.pad(q_scale.float(), (0, pad_q)).reshape(BH, M, block_m, 1)
    ks = F.pad(k_scale.float(), (0, pad_k)).reshape(BH, nb, 1, block_n)
    rows = torch.arange(BH, device=q_i8.device)[:, None]
    m = torch.full((BH, M, block_m, 1), float("-inf"), device=q_i8.device)
    l = torch.zeros((BH, M, block_m, 1), device=q_i8.device)
    acc = torch.zeros((BH, M, block_m, D), device=q_i8.device)
    for j in range(topk):
        ids = lut[:, :, j].long()                                         # [BH, M]
        s = (qb @ kb[rows, ids].transpose(-1, -2)) * (qs * ks[rows, ids]) * (scale * LOG2E)
        key_pos = ids[..., None] * block_n + torch.arange(block_n, device=q_i8.device)
        s = s.masked_fill(key_pos[:, :, None, :] >= Lk, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        p = torch.exp2(s - base)
        alpha = torch.exp2(m - base)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vb[rows, ids].float()
        m = m_new
    l = torch.clamp(l, min=1e-30)
    o = (acc / l).reshape(BH, M * block_m, D)[:, :L].to(v.dtype)
    lse = (torch.where(m == float("-inf"), torch.zeros_like(m), m) + torch.log2(l))
    return o, lse.reshape(BH, M * block_m)[:, :L]


def int8_attention_fwd(q_i8: torch.Tensor, k_i8: torch.Tensor, v: torch.Tensor,
                       q_scale: torch.Tensor, k_scale: torch.Tensor, lut: torch.Tensor,
                       block_m: int, block_n: int, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) on quantized inputs: the kernel on CUDA, the twin on CPU."""
    if q_i8.device.type == "cpu":
        return _torch_int8_attention(q_i8, k_i8, v, q_scale, k_scale, lut, block_m,
                                     block_n, scale)
    if q_i8.device.type != "cuda":
        raise ValueError(f"int8_block_sparse_attention: unsupported device {q_i8.device}")
    BH, Lq, D = q_i8.shape
    Lk = k_i8.shape[1]
    if (k_i8.shape != (BH, Lk, D) or v.shape != k_i8.shape or q_scale.shape != (BH, Lq)
            or k_scale.shape != (BH, Lk)):
        raise ValueError("int8_block_sparse_attention: bad shapes "
                         f"{q_i8.shape} {k_i8.shape} {v.shape} {q_scale.shape} {k_scale.shape}")
    name = "int8_block_sparse_attention"
    check_cuda_inputs(name, (q_i8, k_i8, v, q_scale, k_scale, lut),
                      (torch.int8, torch.int8, torch.bfloat16, torch.float32, torch.float32,
                       torch.int32), D)
    _check_lut(name, lut, BH, Lq, block_m, block_n)
    o = torch.empty((BH, Lq, D), dtype=torch.bfloat16, device=v.device)
    lse = torch.empty((BH, Lq), dtype=torch.float32, device=v.device)
    fn = _build.function("id_sla_int8_fwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q_i8.data_ptr(), k_i8.data_ptr(), v.data_ptr(), q_scale.data_ptr(),
             k_scale.data_ptr(), lut.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, Lq, Lk, D,
             Lk, lut.shape[2], block_m, block_n, scale * LOG2E, _stream(v))
    _build.check(err, name)
    int8_block_sparse_attention.launches += 1
    return o, lse


def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """(q_i8, k_i8, q_scale, k_scale): per-row int8 of q, and of k after the
    smooth-k mean subtraction (in k's dtype, as the JAX package does)."""
    q_i8, q_s = quantize_rows(q)
    k_i8, k_s = quantize_rows(k - k.mean(dim=-2, keepdim=True))
    return q_i8, k_i8, q_s, k_s


class _Int8BlockSparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lut, block_m, block_n, scale, twin):
        q_i8, k_i8, q_s, k_s = quantize_qk(q, k)
        fwd = _torch_int8_attention if twin else int8_attention_fwd
        o, _ = fwd(q_i8, k_i8, v.to(torch.bfloat16), q_s, k_s, lut, block_m, block_n, scale)
        ctx.save_for_backward(q, k, v, lut)
        ctx.cfg = (block_m, block_n, scale, twin)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lut = ctx.saved_tensors
        block_m, block_n, scale, twin = ctx.cfg
        bf = torch.bfloat16
        qb, kb, vb = q.to(bf), k.to(bf), v.to(bf)
        fwd = block_sparse_attention_reference if twin else block_sparse_attention_fwd
        o, lse = fwd(qb, kb, vb, lut, block_m, block_n, scale)
        if twin or q.device.type == "cpu":   # the twin takes the unquantized inputs as they are
            qb, kb, vb = q, k, v
        dq, dk, dv = block_sparse_attention_bwd(qb, kb, vb, lut, o, lse, do.to(o.dtype),
                                                block_m, block_n, scale, twin)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def int8_block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lut: torch.Tensor, block_m: int = 256, block_n: int = 256,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Quantized block-sparse attention: int8 Q/K (per-row scales), bf16 V.
    Same contract as block_sparse_attention; quantization happens inside.
    Returns bf16 [BH, L, D]; differentiable in q, k, v (straight-through)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _Int8BlockSparseAttention.apply(q, k, v, lut, block_m, block_n, scale, False)


int8_block_sparse_attention.launches = 0


def int8_block_sparse_attention_twin(q, k, v, lut, block_m: int = 256, block_n: int = 256,
                                     scale: Optional[float] = None) -> torch.Tensor:
    """int8_block_sparse_attention through the plain twins, forward and
    backward, on any device: what the kernel path is compared with."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _Int8BlockSparseAttention.apply(q, k, v, lut, block_m, block_n, scale, True)
