"""Block-sparse (SLA) and dense flash attention, forward and backward (port
of kernels/block_sparse_attention.py).

  block_sparse_attention      o, differentiable in q, k, v; forward replaces
                              the TPU kernel _fwd_kernel (:46), backward
                              _dq_kernel (:438) and _dkdv_kernel (:473)
  block_sparse_attention_lse  (o, lse) with the kv_len / sentinel contract
                              of ring SLA; the forward kernel, no gradient
  flash_attention             exact dense attention over rectangular Lq x Lk,
                              differentiable; replaces _fwd_kernel_dense
                              (:174), _dq_kernel_dense (:214) and
                              _dkdv_kernel_dense (:248). `kv_lens` (int32
                              [BH]) ends each row's keys early: a padding
                              mask over a joint sequence whose padded keys
                              come last (models/hunyuan_video.py)

On CUDA tensors each launches its hand-written sm_90a kernels, all on wgmma
and TMA (csrc/sla_fwd_sm90.cu and csrc/sla_bwd_sm90.cu the SLA forward and
backward, csrc/flash_fwd_sm90.cu and csrc/flash_bwd_sm90.cu the flash
forward and backward); on CPU
tensors it runs its plain twins (block_sparse_attention_reference,
`_torch_flash`, `_torch_sla_bwd`, `_torch_flash_bwd`). There is no fallback
between the two: a CUDA input the kernels do not take raises. The `*_twin`
entries run the twins on any device, for comparisons. What bounds the
kernels on the H100, and what their design does about it, is in the headers
of the sources.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .block_sparse_reference import (LOG2E, bh_chunks, block_sparse_attention_reference,
                                     gather_blocks)

HEAD_DIMS = (64, 128)  # head dims the CUDA kernels take
TILE = 64              # SLA block sizes must be multiples of this
MAX_LUT_TILES = 1024   # topk * block_n / TILE per query block (the kernels' bound)


def check_cuda_inputs(name: str, tensors, dtypes, D: int) -> None:
    """Device, dtype, layout and alignment checks shared by the CUDA wrappers."""
    dev = tensors[0].device
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


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta[i] = sum_d o[i, d] * do[i, d] in f32: plain PyTorch, as it is
    plain jnp outside the TPU kernels."""
    return (o.float() * do.float()).sum(dim=-1)


def _lut_weights(lut: torch.Tensor) -> torch.Tensor:
    """[BH, M, topk] f32: how often entry j's id occurs in its LUT row, at
    the id's first occurrence, 0 at repeats. The TPU dK/dV kernel visits each
    (query block, key block) pair once and weights it by that count."""
    same = lut[..., :, None] == lut[..., None, :]                    # [BH, M, j, j']
    first = ~torch.tril(same, diagonal=-1).any(dim=-1)
    return same.sum(dim=-1).float() * first.float()


def _torch_sla_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lut: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, block_m: int,
                   block_n: int, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the SLA backward kernels, with the TPU kernels' rounding:
    s = q k^T * scale * log2(e) in f32, masked past L; p = exp2(s - lse);
    dp = do v^T; ds = p (dp - delta) scale; ds and p rounded to the inputs'
    dtype before ds k, ds^T q and p^T do, sums in f32. For dk / dv, p is
    multiplied by the id's count in the LUT row first (`_lut_weights`).
    One LUT entry at a time, vectorised over heads and query blocks, chunked
    over heads. Returns (dq, dk, dv) in the inputs' dtypes."""
    BH, L, D = q.shape
    Lk = k.shape[1]
    M, topk = lut.shape[1], lut.shape[2]
    nb = -(-Lk // block_n)
    pad_q = M * block_m - L
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    pos = torch.arange(block_n, device=q.device)
    for c in bh_chunks(BH, M * block_m * block_n):
        n = c.stop - c.start
        blocks = lambda x, pad: F.pad(x[c], (0, 0, 0, pad)).reshape(n, M, block_m, D)
        qb, dob = blocks(q, pad_q), blocks(do, pad_q)
        rows = lambda x: F.pad(x.float(), (0, pad_q)).reshape(n, M, block_m, 1)
        lse_b, delta_b = rows(lse[c]), rows(attention_delta(o[c], do[c]))
        lut_c = lut[c].long()
        w = _lut_weights(lut_c)
        dq_acc = torch.zeros((n, M, block_m, D), device=q.device)
        dk_acc = torch.zeros((n * nb, block_n, D), device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        flat_ids = torch.arange(n, device=q.device)[:, None, None] * nb + lut_c
        for j in range(topk):
            ids = lut_c[:, :, j:j + 1]
            kb = gather_blocks(k[c], ids, block_n, nb)[:, :, 0]          # [n, M, bn, D]
            vb = gather_blocks(v[c], ids, block_n, nb)[:, :, 0]
            s = (qb.float() @ kb.float().transpose(-1, -2)) * (scale * LOG2E)
            key_pos = ids * block_n + pos                                 # [n, M, bn]
            s = s.masked_fill(key_pos[:, :, None, :] >= Lk, float("-inf"))
            p = torch.exp2(s - lse_b)
            dp = dob.float() @ vb.float().transpose(-1, -2)
            ds = p * (dp - delta_b) * scale
            dq_acc += ds.to(k.dtype).float() @ kb.float()
            wj = w[:, :, j, None, None]
            pw = p * wj
            dsw = pw * (dp - delta_b) * scale
            idx = flat_ids[:, :, j].reshape(-1)
            dv_acc.index_add_(0, idx, (pw.to(do.dtype).float().transpose(-1, -2)
                                       @ dob.float()).reshape(-1, block_n, D))
            dk_acc.index_add_(0, idx, (dsw.to(q.dtype).float().transpose(-1, -2)
                                       @ qb.float()).reshape(-1, block_n, D))
        dq[c] = dq_acc.reshape(n, M * block_m, D)[:, :L].to(q.dtype)
        dk[c] = dk_acc.reshape(n, nb * block_n, D)[:, :Lk].to(k.dtype)
        dv[c] = dv_acc.reshape(n, nb * block_n, D)[:, :Lk].to(v.dtype)
    return dq, dk, dv


def _bwd_args(name, q, k, v, do, lse, delta, D):
    BH, Lq, _ = q.shape
    Lk = k.shape[1]
    if (k.shape != (BH, Lk, D) or v.shape != k.shape or do.shape != q.shape
            or lse.shape != (BH, Lq) or delta.shape != (BH, Lq)):
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape} {do.shape} "
                         f"{lse.shape} {delta.shape}")
    check_cuda_inputs(name, (q, k, v, do, lse, delta),
                      (torch.bfloat16,) * 4 + (torch.float32,) * 2, D)


_SLA_BWD_ARGS = [ctypes.c_void_p] * 7


def sla_bwd_dq(q, k, v, lut, do, lse, delta, block_m: int, block_n: int, scale: float
               ) -> torch.Tensor:
    """dQ of block-sparse attention on CUDA tensors (csrc/sla_bwd_sm90.cu,
    the sm_90a kernel that replaces the TPU _dq_kernel: each 128-row work
    item walks its LUT row's key tiles): bf16 q/k/v/do, f32 lse (base 2) /
    delta."""
    BH, Lq, D = q.shape
    _bwd_args("sla_bwd_dq", q, k, v, do, lse, delta, D)
    check_cuda_inputs("sla_bwd_dq", (lut,), (torch.int32,), D)
    _check_lut("sla_bwd_dq", lut, BH, Lq, block_m, block_n)
    dq = torch.empty_like(q)
    fn = _build.function("id_sla_bwd_dq", _SLA_BWD_ARGS + [ctypes.c_void_p] + [ctypes.c_int] * 8
                         + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), lut.data_ptr(), dq.data_ptr(), BH, Lq, k.shape[1], D, k.shape[1],
             lut.shape[2], block_m, block_n, scale * LOG2E, scale, _stream(q))
    _build.check(err, "sla_bwd_dq")
    sla_bwd_dq.launches += 1
    return dq


sla_bwd_dq.launches = 0


def sla_bwd_dkdv(q, k, v, lut, do, lse, delta, block_m: int, block_n: int, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of block-sparse attention on CUDA tensors (csrc/sla_bwd_sm90.cu,
    the sm_90a kernel that replaces the TPU _dkdv_kernel: each 128-key work
    item walks the query tiles whose LUT row names its key block, weighted by
    how often)."""
    BH, Lq, D = q.shape
    _bwd_args("sla_bwd_dkdv", q, k, v, do, lse, delta, D)
    check_cuda_inputs("sla_bwd_dkdv", (lut,), (torch.int32,), D)
    _check_lut("sla_bwd_dkdv", lut, BH, Lq, block_m, block_n)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("id_sla_bwd_dkdv", _SLA_BWD_ARGS + [ctypes.c_void_p] * 2
                         + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), lut.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Lq, k.shape[1],
             D, k.shape[1], lut.shape[2], block_m, block_n, scale * LOG2E, scale, _stream(q))
    _build.check(err, "sla_bwd_dkdv")
    sla_bwd_dkdv.launches += 1
    return dk, dv


sla_bwd_dkdv.launches = 0


def block_sparse_attention_bwd(q, k, v, lut, o, lse, do, block_m: int, block_n: int,
                               scale: Optional[float] = None, twin: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's (o, lse): the two kernels on CUDA
    tensors, the twin on CPU tensors (or anywhere with twin=True)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if twin or q.device.type == "cpu":
        return _torch_sla_bwd(q, k, v, lut, o, lse, do, block_m, block_n, scale)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_attention: unsupported device {q.device}")
    do = do.contiguous()
    delta = attention_delta(o, do)
    dq = sla_bwd_dq(q, k, v, lut, do, lse, delta, block_m, block_n, scale)
    dk, dv = sla_bwd_dkdv(q, k, v, lut, do, lse, delta, block_m, block_n, scale)
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """o = SLA(q, k, v; lut); the backward goes through the backward kernels
    (or the twin), never through autograd of the forward's arithmetic."""

    @staticmethod
    def forward(ctx, q, k, v, lut, block_m, block_n, scale, twin):
        if twin:
            o, lse = block_sparse_attention_reference(q, k, v, lut, block_m, block_n, scale)
        else:
            o, lse = block_sparse_attention_fwd(q, k, v, lut, block_m, block_n, scale)
        ctx.save_for_backward(q, k, v, lut, o, lse)
        ctx.cfg = (block_m, block_n, scale, twin)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lut, o, lse = ctx.saved_tensors
        block_m, block_n, scale, twin = ctx.cfg
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, lut, o, lse, do.to(o.dtype), block_m,
                                                block_n, scale, twin)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lut: torch.Tensor, block_m: int = 128, block_n: int = 128,
                           scale: Optional[float] = None) -> torch.Tensor:
    """o[i] = softmax(q_i . K_LUT(i)) V_LUT(i); q/k/v [BH, L, D], lut
    [BH, ceil(L / block_m), topk] int32 key-block ids -> [BH, L, D].
    Differentiable in q, k, v (the LUT gets no gradient)."""
    return _BlockSparseAttention.apply(q, k, v, lut, block_m, block_n, scale, False)


block_sparse_attention.launches = 0  # SLA forward kernel launches (any entry)


def block_sparse_attention_twin(q, k, v, lut, block_m: int = 128, block_n: int = 128,
                                scale: Optional[float] = None) -> torch.Tensor:
    """block_sparse_attention through the plain twins, forward and backward,
    on any device: what the kernel path is compared with."""
    return _BlockSparseAttention.apply(q, k, v, lut, block_m, block_n, scale, True)


def block_sparse_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lut: torch.Tensor, block_m: int = 128, block_n: int = 128,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse base 2) with sentinel support: a LUT entry equal to
    ceil(Lkv / block_n) selects a fully masked block (the ring-SLA hop
    primitive); rows of sentinels only give o = 0 and a very negative lse."""
    return block_sparse_attention_fwd(q, k, v, lut, block_m, block_n, scale,
                                      kv_len=k.shape[1], kv_pad_blocks=1)


def _key_mask(kv_lens: Optional[torch.Tensor], c: slice, j: int, n: int, device
              ) -> Optional[torch.Tensor]:
    """[rows of c, 1, n] True where key j + i lies at or past its row's
    length (None without kv_lens)."""
    if kv_lens is None:
        return None
    pos = torch.arange(j, j + n, device=device)
    return (pos[None, None, :] >= kv_lens[c].to(device).long()[:, None, None])


def _torch_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                 block_n: int = 1024, kv_lens: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the flash kernel, in the TPU kernel's order and rounding:
    keys in tiles of block_n, online softmax in exp2 with f32 max / sum, P
    rounded to v's dtype for P.V with f32 accumulation; o in q's dtype, lse
    f32 base 2. Keys at or past kv_lens[bh] (when given) get -inf logits, so a
    tile wholly past a row's length adds nothing, as the kernel never loads
    it. Chunked over BH to bound the [Lq, block_n] intermediates."""
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
            masked = _key_mask(kv_lens, c, j, s.shape[-1], q.device)
            if masked is not None:
                s = s.masked_fill(masked, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ v[c, j:j + block_n].float()
            m = m_new
        o[c] = (acc / l).to(q.dtype)
        lse[c] = (m + torch.log2(l))[..., 0]
    return o, lse


def check_kv_lens(name: str, kv_lens: Optional[torch.Tensor], BH: int, device) -> None:
    """kv_lens, when given, is int32 [BH] on the inputs' device (the kernels
    clamp each length to 1 .. Lk; the caller keeps them there)."""
    if kv_lens is None:
        return
    if kv_lens.shape != (BH,) or kv_lens.dtype != torch.int32 or kv_lens.device != device:
        raise ValueError(f"{name}: kv_lens must be int32 [{BH}] on {device}, got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)} on {kv_lens.device}")
    if not kv_lens.is_contiguous():
        raise ValueError(f"{name}: kv_lens must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, block_n: int = 1024,
                        kv_lens: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of exact attention: the kernel on CUDA, the twin on CPU
    (block_n sets the twin's key tile, hence where it rounds P). kv_lens
    (int32 [BH], each in 1 .. Lk) attends row bh over its first kv_lens[bh]
    keys only."""
    BH, Lq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    check_kv_lens("flash_attention", kv_lens, BH, q.device)
    if q.device.type == "cpu":
        return _torch_flash(q, k, v, scale, block_n, kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    Lk = k.shape[1]
    if k.shape != (BH, Lk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes {q.shape} {k.shape} {v.shape}")
    check_cuda_inputs("flash_attention", (q, k, v), (torch.bfloat16,) * 3, D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Lq), dtype=torch.float32, device=q.device)
    fn = _build.function("id_flash_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             _ptr(kv_lens), BH, Lq, Lk, D, scale * LOG2E, _stream(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def _torch_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                     lse: torch.Tensor, do: torch.Tensor, scale: float, block_n: int = 1024,
                     kv_lens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the flash backward kernels, with the TPU kernels'
    rounding (see `_torch_sla_bwd`): keys in tiles of block_n, chunked over
    heads; p = 0 at keys past kv_lens[bh] (when given), so their dk and dv
    are zero. The tile size moves no rounding point, only the order of the f32
    sums of dq."""
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for c in bh_chunks(BH, Lq * min(block_n, Lk)):
        qc, doc = q[c].float(), do[c].float()
        lse_c = lse[c].float()[..., None]
        delta = attention_delta(o[c], do[c])[..., None]
        dq_acc = torch.zeros_like(qc)
        for j in range(0, Lk, block_n):
            kj, vj = k[c, j:j + block_n].float(), v[c, j:j + block_n].float()
            p = torch.exp2((qc @ kj.transpose(-1, -2)) * (scale * LOG2E) - lse_c)
            masked = _key_mask(kv_lens, c, j, p.shape[-1], q.device)
            if masked is not None:
                p = p.masked_fill(masked, 0.0)
            dv[c, j:j + block_n] = (p.to(do.dtype).float().transpose(-1, -2) @ doc).to(v.dtype)
            ds = (p * (doc @ vj.transpose(-1, -2) - delta) * scale).to(q.dtype).float()
            dq_acc += ds @ kj
            dk[c, j:j + block_n] = (ds.transpose(-1, -2) @ qc).to(k.dtype)
        dq[c] = dq_acc.to(q.dtype)
    return dq, dk, dv


_FLASH_BWD_ARGS = [ctypes.c_void_p] * 6


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float,
                 kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ of exact attention on CUDA tensors (the sm_90a kernel that replaces
    the TPU _dq_kernel_dense); kv_lens as the forward's."""
    BH, Lq, D = q.shape
    _bwd_args("flash_bwd_dq", q, k, v, do, lse, delta, D)
    check_kv_lens("flash_bwd_dq", kv_lens, BH, q.device)
    dq = torch.empty_like(q)
    fn = _build.function("id_flash_bwd_dq", _FLASH_BWD_ARGS + [ctypes.c_void_p] * 2
                         + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), _ptr(kv_lens), BH, Lq, k.shape[1], D,
             scale * LOG2E, scale, _stream(q))
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkdv(q, k, v, do, lse, delta, scale: float,
                   kv_lens: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of exact attention on CUDA tensors (the sm_90a kernel that
    replaces the TPU _dkdv_kernel_dense); kv_lens as the forward's, the rows
    of keys past a length zero."""
    BH, Lq, D = q.shape
    _bwd_args("flash_bwd_dkdv", q, k, v, do, lse, delta, D)
    check_kv_lens("flash_bwd_dkdv", kv_lens, BH, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("id_flash_bwd_dkdv", _FLASH_BWD_ARGS + [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(kv_lens), BH, Lq, k.shape[1],
             D, scale * LOG2E, scale, _stream(q))
    _build.check(err, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, scale: Optional[float] = None,
                        block_n: int = 1024, twin: bool = False,
                        kv_lens: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's (o, lse): the two kernels on CUDA
    tensors, the twin on CPU tensors (or anywhere with twin=True)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if twin or q.device.type == "cpu":
        return _torch_flash_bwd(q, k, v, o, lse, do, scale, block_n, kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    do = do.contiguous()
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, kv_lens)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, scale, kv_lens)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, block_n, twin, kv_lens):
        if twin:
            o, lse = _torch_flash(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale,
                                  block_n, kv_lens)
        else:
            o, lse = flash_attention_fwd(q, k, v, scale, block_n, kv_lens)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens)
        ctx.cfg = (scale, block_n, twin)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens = ctx.saved_tensors
        scale, block_n, twin = ctx.cfg
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.to(o.dtype), scale, block_n, twin,
                                         kv_lens)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_m: int = 512, block_n: int = 1024,
                    scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention, q [BH, Lq, D], k/v [BH, Lk, D] -> [BH, Lq, D],
    differentiable in q, k, v. kv_lens (int32 [BH], each in 1 .. Lk) limits
    row bh to its first kv_lens[bh] keys; the keys past it get no weight and
    a zero gradient.

    block_m / block_n are the TPU kernel's tiles. The math is exact for any
    tiling; the tiles only move where a bf16 P is rounded. The twin walks
    keys in tiles of block_n as the TPU kernel does; the CUDA forward uses
    its own 128-key tiles (the backward rounds no P per tile).
    """
    return _FlashAttention.apply(q, k, v, scale, block_n, False, kv_lens)


flash_attention.launches = 0  # flash forward kernel launches


def flash_attention_twin(q, k, v, block_m: int = 512, block_n: int = 1024,
                         scale: Optional[float] = None,
                         kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flash_attention through the plain twins, forward and backward, on any
    device: what the kernel path is compared with."""
    return _FlashAttention.apply(q, k, v, scale, block_n, True, kv_lens)
