"""The LayerNorm + modulation of WanDiT and HunyuanVideo in one kernel pair
(csrc/ln_modulate.cu).

`ln_modulate(x, scale, shift, form=...)` normalises the last dim of x
[B, L, D] as models/transformer.LayerNorm does (f32 statistics, var = E[x^2] -
mu^2 clipped at 0) and then applies one of two forms:

- "adaln": `LN(x) * (1 + scale) + shift` in x's dtype, with scale and shift
  one row [B, D] a batch row (f32 or bf16, at any batch stride: the rows of
  WanBlock's `mod`, the chunks of HunyuanVideo's modulation Linear), each
  rounded to x's dtype first, as the call sites' `.to(dtype)` rounds them;
- "affine": `LayerNorm(D)` with scale = its weight [D] and shift = its bias
  [D] (WanBlock's norm2), in f32 and rounded once.

On CUDA tensors it launches the hand-written kernels (forward
`id_ln_mod_fwd`, backward `id_ln_mod_bwd`) as one `torch.autograd.Function`;
on CPU tensors it runs the plain twin, the PyTorch chain of `layer_norm`
(LayerNorm.forward's arithmetic) and the modulation, under plain autograd.
There is no fallback between the two: a CUDA input the kernels do not take
raises. `ln_modulate_twin` runs the twin on any device, for comparisons.

It replaces no TPU kernel (the JAX package leaves this chain to XLA); what
bounds it on the H100 and what its design does about it is in the header of
csrc/ln_modulate.cu. `ln_modulate.launches` / `.launches_bwd` count the
forward and backward launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

FORMS = ("adaln", "affine")
MAX_D = 8192             # D / 8 threads a CTA
DTYPES = (torch.bfloat16, torch.float32)   # x's, y's, dy's and dx's; the modulation's


def layer_norm(x: torch.Tensor, eps: float, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """models/transformer.LayerNorm.forward's arithmetic: f32 statistics, then
    (x - mu) * rstd, or (x - mu) * (rstd * w) + b with f32 w and b, rounded
    to x's dtype. Where the kernels round."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    if weight is None:
        return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(x.dtype)


def _check_form(form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"ln_modulate: form must be one of {FORMS}, got {form!r}")


def _twin(x, scale, shift, form: str, eps: float) -> torch.Tensor:
    _check_form(form)
    if form == "affine":
        return layer_norm(x, eps, scale, shift)
    dtype = x.dtype
    return layer_norm(x, eps) * (1 + scale.to(dtype)[:, None]) + shift.to(dtype)[:, None]


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: the start and, past dim 0, every batch row's."""
    rows_apart = t.stride(0) * t.element_size() if t.ndim > 1 and t.shape[0] > 1 else 0
    return t.data_ptr() % 16 == 0 and rows_apart % 16 == 0


def _check(x, scale, shift, form: str) -> None:
    """Raise ValueError for an input the kernels do not take (any device)."""
    name = "ln_modulate"
    _check_form(form)
    if x.dtype not in DTYPES or x.ndim != 3:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 or f32 x [B, L, D], got {x.dtype} "
                         f"{tuple(x.shape)}")
    B, L, D = x.shape
    if D % 8 or D > MAX_D:
        raise ValueError(f"{name}: the CUDA kernel needs D a multiple of 8 and <= {MAX_D}, "
                         f"got {D}")
    if x.stride(2) != 1 or (L > 1 and x.stride(1) != D) or not _aligned(x):
        raise ValueError(f"{name}: the CUDA kernel needs x's rows contiguous and 16-byte "
                         f"aligned (any batch stride), got strides {x.stride()}")
    want = (D,) if form == "affine" else (B, D)
    for t in (scale, shift):
        if t.dtype not in DTYPES or tuple(t.shape) != want:
            raise ValueError(f"{name}: {form} scale and shift must be bf16 or f32 {list(want)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device} (got {t.device})")
        if t.stride(-1) != 1 or not _aligned(t):
            raise ValueError(f"{name}: the CUDA kernel needs scale and shift rows contiguous "
                             f"and 16-byte aligned, got strides {t.stride()}")
    if scale.dtype != shift.dtype:
        raise ValueError(f"{name}: scale ({scale.dtype}) and shift ({shift.dtype}) differ")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_resident: dict = {}   # (backward, partial, f32, affine, D, device index) -> CTAs the card holds


def _grid(bwd: bool, partial: bool, x: torch.Tensor, affine: bool) -> int:
    """The row walk's grid: the kernel's resident CTAs on x's card (from the C
    side's occupancy), at most one a row."""
    key = (int(bwd), int(partial), int(x.dtype == torch.float32), int(affine), x.shape[-1],
           x.device.index)
    if key not in _resident:
        ctas = ctypes.c_int(0)
        fn = _build.function("id_ln_mod_resident", [ctypes.c_int] * 5 + [ctypes.c_void_p])
        with torch.cuda.device(x.device):
            _build.check(fn(*key[:5], ctypes.addressof(ctas)), "ln_modulate grid")
        _resident[key] = ctas.value
    return max(1, min(_resident[key], x.shape[0] * x.shape[1]))


def _bstride(t: torch.Tensor) -> int:
    return t.stride(0) if t.ndim == 2 else 0


def _forward(x, scale, shift, form: str, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y contiguous in x's dtype, mean [B * L] f32, rstd [B * L] f32) from the
    forward kernel."""
    _check(x, scale, shift, form)
    B, L, D = x.shape
    y = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    mean = torch.empty((B * L,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    affine = form == "affine"
    fn = _build.function("id_ln_mod_fwd",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int] + [ctypes.c_void_p] * 3
                         + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_float, ctypes.c_void_p])
    err = fn(x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), scale.data_ptr(),
             _bstride(scale), shift.data_ptr(), _bstride(shift),
             int(scale.dtype == torch.float32), int(affine), y.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), _grid(False, False, x, affine), B * L, L, D, eps, _stream(x))
    _build.check(err, "ln_modulate")
    ln_modulate.launches += 1
    return y, mean, rstd


def _backward(dy, x, scale, mean, rstd, form: str, need_mod: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, d_scale or None, d_shift or None) from the backward kernel: the
    modulation's gradients (adaLN [B, D], affine dw and db [D], in their
    dtype) only with need_mod."""
    dy = dy.to(x.dtype).contiguous()
    if dy.data_ptr() % 16:   # a view at an odd offset: the kernel reads 16-byte rows
        dy = dy.clone()
    B, L, D = x.shape
    affine = form == "affine"
    dx = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    grid = _grid(True, need_mod, x, affine)
    part_b = 1 if affine else B
    part = (torch.zeros((grid, part_b, 2, D), dtype=torch.float32, device=x.device) if need_mod
            else None)
    fn = _build.function("id_ln_mod_bwd",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong,
                                                  ctypes.c_void_p, ctypes.c_longlong,
                                                  ctypes.c_int, ctypes.c_int]
                         + [ctypes.c_void_p] * 4
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p])
    err = fn(dy.data_ptr(), x.data_ptr(), int(x.dtype == torch.float32), x.stride(0),
             scale.data_ptr(), _bstride(scale), int(scale.dtype == torch.float32), int(affine),
             mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
             None if part is None else part.data_ptr(), part_b, grid, B * L, L, D, _stream(x))
    _build.check(err, "ln_modulate backward")
    ln_modulate.launches_bwd += 1
    if part is None:
        return dx, None, None
    sums = part.sum(dim=0)   # [part_b, 2, D]
    if affine:
        sums = sums[0]
    d_scale, d_shift = sums.unbind(dim=-2)
    return dx, d_scale.to(scale.dtype), d_shift.to(scale.dtype)


class _LNModulate(torch.autograd.Function):
    """Both directions through the kernels; the backward reads the saved x
    and the forward's per-row mean and rstd (no f32 copy of a row is kept)."""

    @staticmethod
    def forward(ctx, x, scale, shift, form, eps):
        y, mean, rstd = _forward(x, scale, shift, form, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.form = form
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        need_mod = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, d_scale, d_shift = _backward(dy, x, scale, mean, rstd, ctx.form, need_mod)
        return (dx if ctx.needs_input_grad[0] else None,
                d_scale if ctx.needs_input_grad[1] else None,
                d_shift if ctx.needs_input_grad[2] else None, None, None)


def ln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *, form: str,
                eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim of x [B, L, D], modulated: form "adaln"
    `LN(x) * (1 + scale) + shift` with scale and shift [B, D] rounded to x's
    dtype, or form "affine" LN with weight scale [D] and bias shift [D];
    returned contiguous in x's dtype. Differentiable in x, scale and shift.
    The CUDA kernels take bf16 or f32 x whose rows are contiguous and 16-byte
    aligned (any batch stride: a slice of a longer sequence), D a multiple
    of 8 and <= 8192, bf16 or f32 scale and shift of one dtype with
    contiguous, 16-byte aligned rows (any batch stride)."""
    if x.device.type == "cpu":
        return _twin(x, scale, shift, form, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_modulate: unsupported device {x.device}")
    return _LNModulate.apply(x, scale, shift, form, eps)


def ln_modulate_twin(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *, form: str,
                     eps: float = 1e-6) -> torch.Tensor:
    """`ln_modulate` through the plain twin under autograd, on any device."""
    return _twin(x, scale, shift, form, eps)


ln_modulate.launches = 0       # forward kernel launches
ln_modulate.launches_bwd = 0   # backward kernel launches
