"""WanDiT's q/k RMSNorm + RoPE in one kernel pair (csrc/qk_norm_rope.cu).

`qk_norm_rope(x, weight, cos, sin, n_heads=H)` is RMSNorm(x) * weight, then,
where cos / sin are given, the rotation of interleaved pairs of each head:
what models/wan_dit.WanAttention computes for its q and k. On CUDA tensors it
launches the hand-written kernels (forward `id_qk_norm_rope_fwd`, backward
`id_qk_norm_rope_bwd`) as one `torch.autograd.Function`; on CPU tensors it
runs the plain twin, the PyTorch chain of `rms_norm` (RMSNorm.forward's
arithmetic) in x's dtype and `apply_rope`, under plain autograd. There is no fallback between the two: a CUDA input the
kernels do not take raises. `qk_norm_rope_twin` runs the twin on any device,
for comparisons.

Two more forms serve models/hunyuan_video.py. A weight of Dh elements, not
D, normalises each head's Dh lanes on their own (diffusers' RMSNorm over
[B, H, L, Dh]); the weight's length alone tells the forms apart. `rope_rows`
rotates only the first rope_rows tokens of each sequence (the video rows
ahead of the text rows of a joint sequence), with tables of that many rows;
the rest pass unrotated, still head-major.

It replaces no TPU kernel (the JAX package leaves this chain to XLA); what
bounds it on the H100 and what its design does about it is in the header of
csrc/qk_norm_rope.cu. `qk_norm_rope.launches` / `.launches_bwd` count the
forward and backward launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_HEAD_DIM = 256
MAX_D = 8192             # D / 8 threads a CTA
DTYPES = (torch.bfloat16, torch.float32)   # x's, q's, dq's and dx's


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs; x [B, H, L, D], cos/sin [B or 1, L, D / 2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos, sin = cos[:, None], sin[:, None]
    y = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.reshape(x.shape).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype: torch.dtype,
             var: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x * rsqrt(var + eps) rounded to `dtype`, times `weight` cast to it; var
    is the f32 mean square of x's last dim unless given (tensor parallelism
    sums it over the group). models/wan_dit.RMSNorm's arithmetic, and where
    the kernels round."""
    if var is None:
        var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(dtype) * weight.to(dtype)


def _per_head(x: torch.Tensor, weight: torch.Tensor, n_heads: int) -> bool:
    """True for the [Dh] weight of a norm over each head (not over D)."""
    return n_heads > 1 and weight.shape == (x.shape[-1] // n_heads,)


def _twin(x, weight, cos, sin, n_heads: int, eps: float,
          rope_rows: Optional[int] = None) -> torch.Tensor:
    """rms_norm in x's dtype (over each head for a [Dh] weight), then
    apply_rope on the head split, to the first rope_rows tokens."""
    B, L, D = x.shape
    if _per_head(x, weight, n_heads):
        y = rms_norm(x.reshape(B, L, n_heads, D // n_heads), weight, eps, x.dtype).reshape(B, L, D)
    else:
        y = rms_norm(x, weight, eps, x.dtype)
    if cos is None:
        return y
    y = y.reshape(B, L, n_heads, D // n_heads).transpose(1, 2)
    n = L if rope_rows is None else rope_rows
    if n == L:
        return apply_rope(y, cos, sin)
    return torch.cat([apply_rope(y[:, :, :n], cos, sin), y[:, :, n:]], dim=2)


def _check(x, weight, cos, sin, n_heads: int, rope_rows: Optional[int] = None) -> None:
    """Raise ValueError for an input the kernels do not take (any device)."""
    name = "qk_norm_rope"
    if x.dtype not in DTYPES or x.ndim != 3:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 or f32 x [B, L, D], got {x.dtype} "
                         f"{tuple(x.shape)}")
    B, L, D = x.shape
    if n_heads <= 0 or D % n_heads or (D // n_heads) % 8 or D // n_heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel needs D = H * Dh with Dh a multiple of 8 "
                         f"and <= {MAX_HEAD_DIM}, got D {D}, H {n_heads}")
    if D > MAX_D:
        raise ValueError(f"{name}: the CUDA kernel needs D <= {MAX_D}, got {D}")
    Dh = D // n_heads
    per_head = _per_head(x, weight, n_heads)
    if per_head and (Dh & (Dh - 1)):
        raise ValueError(f"{name}: the per-head norm needs Dh a power of two, got {Dh}")
    if (weight.shape != (D,) and not per_head) or weight.dtype not in (torch.bfloat16,
                                                                       torch.float32):
        raise ValueError(f"{name}: weight must be [{D}] or [{Dh}] bf16 or f32, got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    tensors = [x, weight]
    if (cos is None) != (sin is None):
        raise ValueError(f"{name}: give both cos and sin, or neither")
    n = L if rope_rows is None else rope_rows
    if cos is None and rope_rows is not None:
        raise ValueError(f"{name}: rope_rows without cos / sin")
    if not 0 <= n <= L:
        raise ValueError(f"{name}: rope_rows must lie in 0 .. {L}, got {n}")
    if cos is not None:
        for t in (cos, sin):
            if (t.dtype != torch.float32 or t.ndim != 3 or t.shape[0] not in (1, B)
                    or t.shape[1:] != (n, Dh // 2)):
                raise ValueError(f"{name}: cos / sin must be f32 [1 or {B}, {n}, "
                                 f"{Dh // 2}], got {t.dtype} {tuple(t.shape)}")
        if cos.shape != sin.shape:
            raise ValueError(f"{name}: cos {tuple(cos.shape)} and sin {tuple(sin.shape)} differ")
        tensors += [cos, sin]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device} (got {t.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel needs contiguous, 16-byte aligned inputs")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_resident: dict = {}   # (backward, f32, per head, D, device index) -> CTAs the card holds


def _grid(bwd: bool, x: torch.Tensor, per_head: int) -> int:
    """The row walk's grid: the kernel's resident CTAs on x's card (from the C
    side's occupancy), at most one a row."""
    f32, D = int(x.dtype == torch.float32), x.shape[-1]
    key = (int(bwd), f32, per_head, D, x.device.index)
    if key not in _resident:
        ctas = ctypes.c_int(0)
        fn = _build.function("id_qk_norm_rope_resident", [ctypes.c_int] * 4 + [ctypes.c_void_p])
        with torch.cuda.device(x.device):
            _build.check(fn(int(bwd), f32, per_head, D, ctypes.addressof(ctas)),
                         "qk_norm_rope grid")
        _resident[key] = ctas.value
    return max(1, min(_resident[key], x.shape[0] * x.shape[1]))


def _geometry(x, weight, cos, n_heads: int, rope_rows: Optional[int]):
    """The arguments shared by both C entries after the pointers: (w_f32,
    per_head, cs_batch, rope_rows, rows, L, D, H, Dh)."""
    B, L, D = x.shape
    n = (L if rope_rows is None else rope_rows) if cos is not None else 0
    cs_batch = 0 if cos is None or cos.shape[0] == 1 else n * (D // n_heads // 2)
    return (int(weight.dtype == torch.float32), int(_per_head(x, weight, n_heads)), cs_batch, n,
            B * L, L, D, n_heads, D // n_heads)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward(x, weight, cos, sin, n_heads: int, eps: float, rope_rows: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, rstd [B * L] f32, per head [B * L, H]) from the forward kernel; q
    in x's dtype, head-major [B, H, L, Dh] with RoPE, [B, L, D] without."""
    _check(x, weight, cos, sin, n_heads, rope_rows)
    B, L, D = x.shape
    shape = (B, L, D) if cos is None else (B, n_heads, L, D // n_heads)
    q = torch.empty(shape, dtype=x.dtype, device=x.device)
    w_f32, per_head, cs_batch, n_rope, rows, L, D, H, Dh = _geometry(x, weight, cos, n_heads,
                                                                     rope_rows)
    rstd = torch.empty((B * L * (H if per_head else 1),), dtype=torch.float32, device=x.device)
    fn = _build.function("id_qk_norm_rope_fwd",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int] + [ctypes.c_void_p] * 2
                         + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p])
    err = fn(x.data_ptr(), int(x.dtype == torch.float32), weight.data_ptr(), w_f32, per_head,
             _ptr(cos), _ptr(sin), cs_batch, n_rope, q.data_ptr(), rstd.data_ptr(),
             _grid(False, x, per_head), rows, L, D, H, Dh, eps, _stream(x))
    _build.check(err, "qk_norm_rope")
    qk_norm_rope.launches += 1
    return q, rstd


def _backward(dq, x, weight, cos, sin, rstd, n_heads: int, need_dw: bool,
              rope_rows: Optional[int] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dw or None) from the backward kernel; dq in the forward's q layout."""
    dq = dq.to(x.dtype).contiguous()
    if dq.data_ptr() % 16:   # a view at an odd offset: the kernel reads 16-byte rows
        dq = dq.clone()
    w_f32, per_head, cs_batch, n_rope, rows, L, D, H, Dh = _geometry(x, weight, cos, n_heads,
                                                                     rope_rows)
    dx = torch.empty_like(x)
    grid = _grid(True, x, per_head)
    dw_part = (torch.zeros((grid, D), dtype=torch.float32, device=x.device) if need_dw
               else None)
    fn = _build.function("id_qk_norm_rope_bwd",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                                  ctypes.c_int]
                         + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
                         + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(dq.data_ptr(), x.data_ptr(), int(x.dtype == torch.float32), weight.data_ptr(),
             w_f32, per_head, _ptr(cos), _ptr(sin), cs_batch, n_rope, rstd.data_ptr(),
             dx.data_ptr(), _ptr(dw_part), grid, rows, L, D, H, Dh, _stream(x))
    _build.check(err, "qk_norm_rope backward")
    qk_norm_rope.launches_bwd += 1
    if dw_part is None:
        return dx, None
    dw = dw_part.sum(dim=0)
    if per_head:   # each head's columns feed the same [Dh] weight
        dw = dw.view(H, Dh).sum(dim=0)
    return dx, dw.to(weight.dtype)


class _QKNormRope(torch.autograd.Function):
    """Both directions through the kernels; the backward reads the saved x and
    the forward's per-row rstd (no f32 copy of a row is kept)."""

    @staticmethod
    def forward(ctx, x, weight, cos, sin, n_heads, eps, rope_rows):
        q, rstd = _forward(x, weight, cos, sin, n_heads, eps, rope_rows)
        ctx.save_for_backward(x, weight, cos, sin, rstd)
        ctx.n_heads, ctx.rope_rows = n_heads, rope_rows
        return q

    @staticmethod
    def backward(ctx, dq):
        x, weight, cos, sin, rstd = ctx.saved_tensors
        dx, dw = _backward(dq, x, weight, cos, sin, rstd, ctx.n_heads, ctx.needs_input_grad[1],
                           ctx.rope_rows)
        return dx, dw, None, None, None, None, None


def qk_norm_rope(x: torch.Tensor, weight: torch.Tensor, cos: Optional[torch.Tensor] = None,
                 sin: Optional[torch.Tensor] = None, *, n_heads: int,
                 eps: float = 1e-6, rope_rows: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over the last dim of x [B, L, D] times `weight` [D] (rounded to
    x's dtype), in x's dtype, or with a [Dh] weight over each head's Dh lanes;
    with cos / sin [B or 1, L, Dh / 2] f32 also the RoPE rotation of each
    head's interleaved pairs, returned head-major [B, H, L, Dh] (contiguous),
    else [B, L, D]. rope_rows n < L rotates tokens 0 .. n - 1 only, with
    tables [B or 1, n, Dh / 2]. Differentiable in x and weight. The CUDA
    kernels take bf16 or f32 x, an f32 or bf16 weight, Dh = D / H a multiple
    of 8 and <= 256 (per head a power of two), contiguous 16-byte aligned
    inputs."""
    if x.device.type == "cpu":
        return _twin(x, weight, cos, sin, n_heads, eps, rope_rows)
    if x.device.type != "cuda":
        raise ValueError(f"qk_norm_rope: unsupported device {x.device}")
    return _QKNormRope.apply(x, weight, cos, sin, n_heads, eps, rope_rows)


def qk_norm_rope_twin(x: torch.Tensor, weight: torch.Tensor, cos: Optional[torch.Tensor] = None,
                      sin: Optional[torch.Tensor] = None, *, n_heads: int,
                      eps: float = 1e-6, rope_rows: Optional[int] = None) -> torch.Tensor:
    """`qk_norm_rope` through the plain twin under autograd, on any device."""
    return _twin(x, weight, cos, sin, n_heads, eps, rope_rows)


qk_norm_rope.launches = 0       # forward kernel launches
qk_norm_rope.launches_bwd = 0   # backward kernel launches
