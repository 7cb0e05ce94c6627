"""Block-sparse (SLA) and dense flash attention, forward (port of
kernels/block_sparse_attention.py).

  block_sparse_attention      o; replaces the TPU kernel _fwd_kernel (:46)
  block_sparse_attention_lse  (o, lse) with the kv_len / sentinel contract
                              of ring SLA; the same kernel
  flash_attention             exact dense attention over rectangular Lq x Lk;
                              replaces _fwd_kernel_dense (:174)

On CUDA tensors each launches its hand-written sm_90a kernel in
csrc/block_attention.cu; on CPU tensors it runs its plain twin
(block_sparse_attention_reference, `_torch_flash`). There is no fallback
between the two: a CUDA input the kernel does not take raises. What bounds
the kernels on the H100, and what their design does about it, is in the
header of csrc/block_attention.cu. Forward only: the backward kernels come
with training.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .block_sparse_reference import LOG2E, bh_chunks, block_sparse_attention_reference
from .small_mha import check_no_grad

HEAD_DIMS = (64, 128)  # head dims the CUDA kernels take
TILE = 64              # the kernels' row tile: SLA block sizes must be multiples
MAX_LUT_TILES = 1024   # topk * block_n / TILE per query block (csrc kMaxTiles)


def check_cuda_inputs(name: str, tensors, dtypes, D: int) -> None:
    """Device, dtype, layout and alignment checks shared by the CUDA wrappers."""
    dev = tensors[0].device
    check_no_grad(name, *tensors)
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev} (got {t.device})")
        if t.dtype != dt:
            raise ValueError(f"{name}: the CUDA kernel takes {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel needs contiguous, 16-byte aligned inputs")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head dim in {HEAD_DIMS}, got {D}")


def _check_lut(name: str, lut: torch.Tensor, BH: int, Lq: int, block_m: int, block_n: int):
    if block_m % TILE or block_n % TILE or block_m <= 0 or block_n <= 0:
        raise ValueError(f"{name}: the CUDA kernel takes block sizes that are multiples "
                         f"of {TILE}, got {block_m}, {block_n}")
    M = -(-Lq // block_m)
    if lut.ndim != 3 or lut.shape[0] != BH or lut.shape[1] != M:
        raise ValueError(f"{name}: lut must be [{BH}, {M}, topk], got {tuple(lut.shape)}")
    if lut.shape[2] * (block_n // TILE) > MAX_LUT_TILES:
        raise ValueError(f"{name}: topk * block_n / {TILE} must be <= {MAX_LUT_TILES}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def block_sparse_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lut: torch.Tensor,
    block_m: int, block_n: int, scale: Optional[float] = None,
    kv_len: Optional[int] = None, kv_pad_blocks: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of block-sparse attention: the kernel on CUDA, the twin on CPU.

    kv_pad_blocks > 0 makes LUT id ceil(kv_len / block_n) (and up) a sentinel
    that contributes nothing; the kernel skips any key tile at or past kv_len,
    so it needs no padded copy of k / v.
    """
    BH, Lq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return block_sparse_attention_reference(q, k, v, lut, block_m, block_n, scale,
                                                 kv_len=kv_len, kv_pad_blocks=kv_pad_blocks)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_attention: unsupported device {q.device}")
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    if k.shape != (BH, Lk, D) or v.shape != k.shape or not 0 <= kv_len <= Lk:
        raise ValueError(f"block_sparse_attention: bad shapes {q.shape} {k.shape} {v.shape}")
    check_cuda_inputs("block_sparse_attention", (q, k, v, lut),
                      (torch.bfloat16,) * 3 + (torch.int32,), D)
    _check_lut("block_sparse_attention", lut, BH, Lq, block_m, block_n)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Lq), dtype=torch.float32, device=q.device)
    fn = _build.function("id_sla_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lut.data_ptr(), o.data_ptr(),
             lse.data_ptr(), BH, Lq, Lk, D, kv_len, lut.shape[2], block_m, block_n,
             scale * LOG2E, _stream(q))
    _build.check(err, "block_sparse_attention")
    block_sparse_attention.launches += 1
    return o, lse


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lut: torch.Tensor, block_m: int = 128, block_n: int = 128,
                           scale: Optional[float] = None) -> torch.Tensor:
    """o[i] = softmax(q_i . K_LUT(i)) V_LUT(i); q/k/v [BH, L, D], lut
    [BH, ceil(L / block_m), topk] int32 key-block ids -> [BH, L, D]."""
    return block_sparse_attention_fwd(q, k, v, lut, block_m, block_n, scale)[0]


block_sparse_attention.launches = 0  # SLA kernel launches (either public entry)


def block_sparse_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lut: torch.Tensor, block_m: int = 128, block_n: int = 128,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse base 2) with sentinel support: a LUT entry equal to
    ceil(Lkv / block_n) selects a fully masked block (the ring-SLA hop
    primitive); rows of sentinels only give o = 0 and a very negative lse."""
    return block_sparse_attention_fwd(q, k, v, lut, block_m, block_n, scale,
                                      kv_len=k.shape[1], kv_pad_blocks=1)


def _torch_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                 block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the flash kernel, in the TPU kernel's order and rounding:
    keys in tiles of block_n, online softmax in exp2 with f32 max / sum, P
    rounded to v's dtype for P.V with f32 accumulation; o in q's dtype, lse
    f32 base 2. Chunked over BH to bound the [Lq, block_n] intermediates."""
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((BH, Lq), dtype=torch.float32, device=q.device)
    for c in bh_chunks(BH, Lq * min(block_n, Lk)):
        qc = q[c].float()
        m = torch.full((qc.shape[0], Lq, 1), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((qc.shape[0], Lq, D), device=q.device)
        for j in range(0, Lk, block_n):
            s = (qc @ k[c, j:j + block_n].float().transpose(-1, -2)) * (scale * LOG2E)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ v[c, j:j + block_n].float()
            m = m_new
        o[c] = (acc / l).to(q.dtype)
        lse[c] = (m + torch.log2(l))[..., 0]
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, block_n: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of exact attention: the kernel on CUDA, the twin on CPU
    (block_n sets the twin's key tile, hence where it rounds P)."""
    BH, Lq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return _torch_flash(q, k, v, scale, block_n)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    Lk = k.shape[1]
    if k.shape != (BH, Lk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes {q.shape} {k.shape} {v.shape}")
    check_cuda_inputs("flash_attention", (q, k, v), (torch.bfloat16,) * 3, D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Lq), dtype=torch.float32, device=q.device)
    fn = _build.function("id_flash_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             BH, Lq, Lk, D, scale * LOG2E, _stream(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_m: int = 512, block_n: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention, q [BH, Lq, D], k/v [BH, Lk, D] -> [BH, Lq, D].

    block_m / block_n are the TPU kernel's tiles. The math is exact for any
    tiling; the tiles only move where a bf16 P is rounded. The twin walks
    keys in tiles of block_n as the TPU kernel does; the CUDA kernel uses its
    own 64-row tiles.
    """
    return flash_attention_fwd(q, k, v, scale, block_n)[0]


flash_attention.launches = 0
