"""Fused FiLM pre-norm transformer block (port of kernels/fused_block.py).

`fused_film_block` replaces the TPU kernel
interpolated_diffusion_tpu/kernels/fused_block.py::_kernel (public
fused_film_block). On CUDA tensors it launches the chain of hand-written
sm_90a kernels in csrc/fused_block.cu (LN+FiLM, a bf16 GEMM with bias /
SiLU / residual epilogues, and the attention kernel of csrc/small_mha.cu); on
CPU tensors it runs the plain twin `_torch_block`. There is no fallback
between the two: a CUDA input the kernels do not take raises.

Weights are in the torch Linear layout [out, in] (the JAX function takes the
flax [in, out] kernels). On CUDA x and the FiLM rows are bf16. The four
weight matrices are bf16, or f32 masters that are cast to bf16 for the call
(the TPU wrapper does the same cast). The four biases and four LN vectors are
all f32 (masters, read as they are: the TPU kernel's types) or all bf16 (a
model held in bf16 throughout; the kernels read them into f32, which is
exact). The plain twin takes the same dtypes and rounds at the same points.

`fused_film_block` is a `torch.autograd.Function` with the JAX package's
split: the forward is the kernel chain, the backward recomputes the plain
twin on the saved inputs and differentiates that (no backward kernel, as in
the JAX custom_vjp), so gradients reach f32 masters in f32.
`fused_film_block_twin` runs the twin forward as well, on any device.

What bounds the kernels on the H100, and what the design does about it, is in
the header of csrc/fused_block.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .small_mha import MAX_L, twin_backward

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


_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_NAMES = ("x", "gb1", "gb2", "ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv", "wout", "bout",
          "wff1", "bff1", "wff2", "bff2")
# what each of the 15 tensors is: an activation (x and the FiLM rows: bf16), a
# weight matrix (bf16, or an f32 master that is cast), a bias or LN vector
_ACT, _MAT, _VEC = 0, 1, 2
_KINDS = (_ACT, _ACT, _ACT, _VEC, _VEC, _VEC, _VEC, _MAT, _VEC, _MAT, _VEC, _MAT, _VEC, _MAT, _VEC)


def _check_block(x, args, n_heads: int) -> list:
    """The 15 tensors as the CUDA chain takes them (contiguous; f32 master
    matrices cast to bf16, as on the TPU), or ValueError for what it does not
    take. Needs no card. Runs once a block call on a host-bound path, so it
    builds its message only when it raises."""
    B, L, D = x.shape
    F = args[10].shape[0]
    dh = D // n_heads
    if D % 64 or F % 64 or D != n_heads * dh or dh not in (32, 64) or L > MAX_L:
        raise ValueError(f"fused_film_block: CUDA kernels need D and F multiples of 64, "
                         f"head dim 32 or 64 and L <= {MAX_L} (got D={D}, F={F}, "
                         f"H={n_heads}, L={L})")
    bf, f32 = torch.bfloat16, torch.float32
    vec_dtype = args[2].dtype
    if vec_dtype not in (bf, f32):
        raise ValueError(f"fused_film_block: biases and LN vectors are {vec_dtype}; the CUDA "
                         "kernels take f32 or bf16")
    shapes = ((B, L, D), (B, 2 * D), (B, 2 * D), (D,), (D,), (D,), (D,), (3 * D, D), (3 * D,),
              (D, D), (D,), (F, D), (F,), (D, F), (D,))
    wants = ((bf,), (bf, f32), (vec_dtype,))
    ins = []
    for name, kind, shape, t in zip(_NAMES, _KINDS, shapes, (x, *args)):
        if t.shape != shape or t.device != x.device or t.dtype not in wants[kind]:
            raise ValueError(f"fused_film_block: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; the CUDA kernels take "
                             f"{' or '.join(map(str, wants[kind]))} {shape} on {x.device} "
                             "(biases and LN vectors all of one dtype)")
        if t.dtype != bf and kind == _MAT:
            t = t.to(bf)
        ins.append(t if t.is_contiguous() else t.contiguous())
    return ins


def _launch_block(x, args, n_heads: int, use_film: bool) -> torch.Tensor:
    """Checks, scratch buffers and one launch of the kernel chain."""
    ins = _check_block(x, args, n_heads)
    B, L, D = x.shape
    F = args[10].shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    M = B * L
    empty = lambda *shape, dtype=bf: torch.empty(shape, dtype=dtype, device=x.device)
    h, qkv, o = empty(M, D), empty(M, 3 * D), empty(M, D)
    x2, f, y = empty(M, D, dtype=f32), empty(M, F), empty(B, L, D)
    ptrs = [t.data_ptr() for t in (*ins, h, qkv, o, x2, f, y)]
    if any(p % 16 for p in ptrs):
        raise ValueError("fused_film_block: CUDA kernels need 16-byte aligned tensors")
    fn = _build.function("id_fused_film_block", _ARGTYPES)
    err = fn(*ptrs, B, L, D, n_heads, F, int(bool(use_film)), int(args[2].dtype == f32),
             (D // n_heads) ** -0.5, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_film_block")
    fused_film_block.launches += 1
    by_len = fused_film_block.launches_by_len
    by_len[L] = by_len.get(L, 0) + 1
    return y


EPILOGUES = ("bias", "bias_silu", "resid_f32", "resid_out")   # csrc: enum Epilogue


def _torch_gemm(a, w, bias, epilogue: str, resid=None) -> torch.Tensor:
    """Plain twin of the GEMM: epilogue(a @ w^T + bias), rounded as the kernel
    rounds. The product runs in f32 on operands rounded to a.dtype; the bias is
    added in f32. "bias" rounds that to a.dtype; "bias_silu" applies SiLU in
    f32 first; "resid_f32" adds it to resid (a.dtype) and stays f32;
    "resid_out" adds it to resid (f32) and rounds to a.dtype."""
    cdt = a.dtype
    v = a.float() @ w.to(cdt).float().t() + bias.float()
    if epilogue == "bias":
        return v.to(cdt)
    if epilogue == "bias_silu":
        return (v * torch.sigmoid(v)).to(cdt)
    if epilogue == "resid_f32":
        return resid.float() + v
    if epilogue == "resid_out":
        return (resid + v).to(cdt)
    raise ValueError(f"gemm_bias_act: unknown epilogue {epilogue!r}; one of {EPILOGUES}")


def _check_gemm(a, w, bias, epilogue: str, resid) -> None:
    """The shapes and types the CUDA GEMM takes (needs no card to check)."""
    bf, f32 = torch.bfloat16, torch.float32
    if epilogue not in EPILOGUES:
        raise ValueError(f"gemm_bias_act: unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1] or a.shape[0] < 1:
        raise ValueError(f"gemm_bias_act: a {tuple(a.shape)} and w {tuple(w.shape)} must be "
                         "[M, K] and [N, K]")
    (M, K), N = a.shape, w.shape[0]
    if N % 64 or K % 64:
        raise ValueError(f"gemm_bias_act: the CUDA kernel needs N and K multiples of 64 "
                         f"(got N={N}, K={K})")
    if a.dtype != bf or w.dtype != bf or bias.dtype not in (bf, f32) or tuple(bias.shape) != (N,):
        raise ValueError(f"gemm_bias_act: the CUDA kernel takes bf16 a and w and an f32 or "
                         f"bf16 bias [{N}] (got {a.dtype}, {w.dtype}, {bias.dtype} "
                         f"{tuple(bias.shape)})")
    want = {"resid_f32": bf, "resid_out": f32}.get(epilogue)
    if (resid is None) != (want is None) or (want is not None and (
            resid.dtype != want or tuple(resid.shape) != (M, N))):
        raise ValueError(f"gemm_bias_act: epilogue {epilogue!r} takes "
                         f"{'no resid' if want is None else f'a {want} resid [{M}, {N}]'}")
    tensors = [a, w, bias] + ([resid] if resid is not None else [])
    if any(t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("gemm_bias_act: the CUDA kernel needs contiguous, 16-byte aligned "
                         "tensors on one device")


def gemm_bias_act(a, w, bias, epilogue: str = "bias", resid=None) -> torch.Tensor:
    """epilogue(a [M, K] @ w [N, K]^T + bias [N]): the GEMM of the block chain
    alone. On CUDA tensors one launch of the wgmma + TMA kernel (bf16 a and w,
    f32 or bf16 bias, N and K multiples of 64; anything else raises); on CPU
    tensors the plain twin. Output bf16 [M, N], f32 for "resid_f32"."""
    if a.device.type == "cpu":
        return _torch_gemm(a, w, bias, epilogue, resid)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_bias_act: unsupported device {a.device}")
    _check_gemm(a, w, bias, epilogue, resid)
    (M, K), N = a.shape, w.shape[0]
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.float32 if epilogue == "resid_f32" else torch.bfloat16)
    fn = _build.function("id_gemm_bias_act", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    err = fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
             resid.data_ptr() if resid is not None else None, out.data_ptr(), M, N, K,
             EPILOGUES.index(epilogue), int(bias.dtype == torch.float32),
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "gemm_bias_act")
    gemm_bias_act.launches += 1
    return out


def _forward(x, args, n_heads: int, use_film: bool, twin: bool) -> torch.Tensor:
    if twin or x.device.type == "cpu":
        return _torch_block(x, *args, n_heads=n_heads, use_film=use_film)
    if x.device.type != "cuda":
        raise ValueError(f"fused_film_block: unsupported device {x.device}")
    return _launch_block(x, args, n_heads, use_film)


def backward_twin(x, *args, n_heads: int, use_film: bool) -> torch.Tensor:
    """The twin as the backward recomputes it (a name of its own, so that a
    run can tell a recompute in backward from a twin call in forward)."""
    return _torch_block(x, *args, n_heads=n_heads, use_film=use_film)


class _FusedFilmBlock(torch.autograd.Function):
    """Forward: the kernel chain (or the twin). Backward: the twin, recomputed."""

    @staticmethod
    def forward(ctx, n_heads, use_film, twin, x, *args):
        ctx.save_for_backward(x, *args)
        ctx.n_heads, ctx.use_film = n_heads, use_film
        return _forward(x, args, n_heads, use_film, twin)

    @staticmethod
    def backward(ctx, dy):
        n_heads, use_film = ctx.n_heads, ctx.use_film
        grads = twin_backward(
            lambda *a: backward_twin(*a, n_heads=n_heads, use_film=use_film),
            ctx.saved_tensors, ctx.needs_input_grad[3:], dy)
        return (None, None, None, *grads)


def fused_film_block(x, gb1, gb2, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wout, bout,
                     wff1, bff1, wff2, bff2, n_heads: int,
                     use_film: bool = True) -> torch.Tensor:
    """One FiLM pre-norm block: x [B, L, D] -> [B, L, D].

    gb1/gb2 are the per-sample FiLM (gamma|beta) rows [B, 2D] (zeros with
    use_film=False). wqkv [3D, D], wout [D, D], wff1 [F, D], wff2 [D, F] in
    the torch Linear layout. The TPU kernel's batch-packing factor `group_b`
    has no counterpart: per-sample attention gives exactly its result.
    """
    args = (gb1, gb2, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wout, bout,
            wff1, bff1, wff2, bff2)
    return _FusedFilmBlock.apply(n_heads, use_film, False, x, *args)


def fused_film_block_twin(x, *args, n_heads: int, use_film: bool = True) -> torch.Tensor:
    """`fused_film_block` with the plain twin as forward, on any device."""
    return _FusedFilmBlock.apply(n_heads, use_film, True, x, *args)


fused_film_block.launches = 0
fused_film_block.launches_by_len = {}   # the same launches by sequence length L: {L: count}
gemm_bias_act.launches = 0      # launches of the GEMM alone (not those inside the chain)
