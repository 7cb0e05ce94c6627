"""The port's attention backward (kernels/block_sparse_attention.py,
kernels/int8_attention.py) against the JAX package, on the CPU.

On CPU tensors the port runs the plain twins of its CUDA backward kernels
(`_torch_sla_bwd`, `_torch_flash_bwd`); the JAX side runs its Pallas backward
kernels in interpret mode (`_bwd_pallas`, `_bwd_pallas_dense`) and its XLA
oracle (`_bwd_xla`). Inputs come from numpy seeds and both sides get the same
forward (o, lse), so the comparison isolates the backward.

Tolerances, as max|port - jax| / max|jax| per tensor (dq, dk, dv):
  - 1e-5 for f32 inputs: the same f32 arithmetic, sums in another order;
  - 2e-2 for bf16 inputs: p and ds are rounded to bf16 before their products
    and the outputs are bf16; f32 values a few 1e-7 apart round one bf16 ulp
    (2^-8 of the value) apart, and a flipped p or ds moves an output sum.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
    block_sparse_attention_reference)

jbsa = importlib.import_module("interpolated_diffusion_tpu.kernels.block_sparse_attention")
ji8 = importlib.import_module("interpolated_diffusion_tpu.kernels.int8_attention")

F32_TOL, BF16_TOL = 1e-5, 2e-2


def rel_err(out, ref):
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _to_torch(x, dtype):
    return torch.tensor(np.asarray(jnp.asarray(x, jnp.float32))).to(dtype)


def _inputs(seed, BH, Lq, Lk, D, dtype):
    r = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    mk = lambda L: jnp.asarray(r.normal(size=(BH, L, D)).astype(np.float32)).astype(jdt)
    return mk(Lq), mk(Lk), mk(Lk), mk(Lq)   # q, k, v, do


def _lut(seed, BH, L, block, topk, dup, block_n=None):
    """Random key-block ids (of block_n keys, default block) for query blocks
    of `block` rows; with dup, every second row repeats its first id in its
    last slot (padded rows look like this)."""
    r = np.random.default_rng(seed)
    M, N = -(-L // block), -(-L // (block_n or block))
    lut = np.stack([[r.choice(N, size=topk, replace=False) for _ in range(M)]
                    for _ in range(BH)]).astype(np.int32)
    if dup:
        lut[:, ::2, -1] = lut[:, ::2, 0]
    return lut


UNNAMED = 1   # the key block that an "unnamed" LUT names nowhere


@pytest.mark.parametrize("dtype,tol", [("f32", F32_TOL), ("bf16", BF16_TOL)])
@pytest.mark.parametrize("D,block,L,dup", [
    (64, 64, 200, False),     # ragged: 200 = 3 * 64 + 8
    (128, 64, 200, True),     # duplicated ids
    (64, 128, 256, True),     # aligned, block 128
    # block (block_m, block_n) with block_m != block_n, both ways, ragged
    (64, (128, 64), 300, False), (128, (64, 192), 330, True),
    # dup "unnamed": key block UNNAMED appears in no LUT row, so its dk and
    # dv are exactly 0
    (64, (192, 64), 400, "unnamed"), (128, 128, 300, "unnamed")])
def test_sla_bwd_twin_matches_pallas(dtype, tol, D, block, L, dup):
    bm, bn = block if isinstance(block, tuple) else (block, block)
    BH, topk = 3, 2 if L // bn < 3 else 3
    q, k, v, do = _inputs(L + D, BH, L, L, D, dtype)
    lut = _lut(D + bm + bn, BH, L, bm, topk, dup is True, bn)
    if dup == "unnamed":
        lut[lut == UNNAMED] = UNNAMED + 1   # a repeat where UNNAMED + 1 was already named
    scale = D ** -0.5
    o, lse = jbsa._fwd_pallas(q, k, v, jnp.asarray(lut), bm, bn, scale, interpret=True)
    ref = jbsa._bwd_pallas(q, k, v, jnp.asarray(lut), o, lse, do, bm, bn, scale,
                           interpret=True)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    args = [_to_torch(x, tdt) for x in (q, k, v)]
    got = bsa.block_sparse_attention_bwd(*args, torch.tensor(lut), _to_torch(o, tdt),
                                         _to_torch(lse, torch.float32), _to_torch(do, tdt),
                                         bm, bn, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == tdt and a.shape == b.shape, name
        assert rel_err(a, b) <= tol, (name, rel_err(a, b))
    if dup == "unnamed":
        keys = slice(UNNAMED * bn, (UNNAMED + 1) * bn)
        for a, b in zip(got[1:], ref[1:]):
            assert bool((a[:, keys] == 0).all()) and bool((np.asarray(b[:, keys]) == 0).all())


def test_sla_bwd_twin_matches_xla_oracle():
    """f32: the twin against autograd through the JAX gather reference."""
    BH, L, D, block = 2, 200, 64, 64
    q, k, v, do = _inputs(7, BH, L, L, D, "f32")
    lut = _lut(8, BH, L, block, 3, True)
    scale = D ** -0.5
    o, lse = jbsa.block_sparse_attention_reference(q, k, v, jnp.asarray(lut), block, block, scale)
    ref = jbsa._bwd_xla(q, k, v, jnp.asarray(lut), o, lse, do, block, block, scale)
    got = bsa.block_sparse_attention_bwd(
        *[_to_torch(x, torch.float32) for x in (q, k, v)], torch.tensor(lut),
        _to_torch(o, torch.float32), _to_torch(lse, torch.float32), _to_torch(do, torch.float32),
        block, block, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert rel_err(a, b) <= F32_TOL, (name, rel_err(a, b))


@pytest.mark.parametrize("dtype,tol", [("f32", F32_TOL), ("bf16", BF16_TOL)])
@pytest.mark.parametrize("Lq,Lk,D", [(200, 77, 64),      # rectangular, both ragged
                                     (100, 300, 128),
                                     (256, 256, 64),
                                     # ragged against the CUDA kernels' 128-row
                                     # blocks and 64-row tiles in both
                                     (300, 133, 128)])
def test_flash_bwd_twin_matches_pallas(dtype, tol, Lq, Lk, D):
    BH = 3
    q, k, v, do = _inputs(Lq + Lk, BH, Lq, Lk, D, dtype)
    scale = D ** -0.5
    o, lse = jbsa._fwd_pallas_dense(q, k, v, 64, 128, scale, interpret=True)
    ref = jbsa._bwd_pallas_dense(q, k, v, o, lse, do, 64, 128, scale, interpret=True)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = bsa.flash_attention_bwd(*[_to_torch(x, tdt) for x in (q, k, v)], _to_torch(o, tdt),
                                  _to_torch(lse, torch.float32), _to_torch(do, tdt), scale,
                                  block_n=128)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == tdt and a.shape == b.shape, name
        assert rel_err(a, b) <= tol, (name, rel_err(a, b))


def _torch_leaves(seed, BH, Lq, Lk, D):
    q, k, v, do = _inputs(seed, BH, Lq, Lk, D, "f32")
    leaves = [_to_torch(x, torch.float32).requires_grad_() for x in (q, k, v)]
    return leaves, _to_torch(do, torch.float32)


def test_sla_function_matches_autograd_through_reference():
    """The autograd.Function (forward twin + backward twin) against plain
    autograd through the f32 gather reference; the LUT gets no gradient."""
    BH, L, D, block = 2, 200, 64, 64
    lut = torch.tensor(_lut(3, BH, L, block, 3, True))
    leaves, do = _torch_leaves(4, BH, L, L, D)
    out = bsa.block_sparse_attention(*leaves, lut, block, block)
    got = torch.autograd.grad(out, leaves, do)
    ref_out, _ = block_sparse_attention_reference(*leaves, lut, block, block)
    ref = torch.autograd.grad(ref_out, leaves, do)
    assert torch.equal(out, ref_out)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert rel_err(a, b.numpy()) <= F32_TOL, (name, rel_err(a, b.numpy()))
    assert bsa.sla_bwd_dq.launches == 0 and bsa.sla_bwd_dkdv.launches == 0   # CPU: the twin


def test_flash_function_matches_autograd_through_softmax():
    BH, Lq, Lk, D = 2, 130, 77, 64
    leaves, do = _torch_leaves(5, BH, Lq, Lk, D)
    out = bsa.flash_attention(*leaves, 64, 32)
    got = torch.autograd.grad(out, leaves, do)
    q, k, v = leaves
    ref_out = torch.softmax((q @ k.transpose(-1, -2)) * D ** -0.5, dim=-1) @ v
    ref = torch.autograd.grad(ref_out, leaves, do)
    assert rel_err(out.detach(), ref_out.detach().numpy()) <= F32_TOL
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert rel_err(a, b.numpy()) <= F32_TOL, (name, rel_err(a, b.numpy()))
    assert bsa.flash_bwd_dq.launches == 0 and bsa.flash_bwd_dkdv.launches == 0


@pytest.mark.parametrize("dtype,tol", [("f32", 2.0 ** -8), ("bf16", BF16_TOL)])
def test_int8_straight_through_matches_jax(dtype, tol):
    """Gradients of sum(o * w) through int8_block_sparse_attention: the JAX
    custom_vjp with bwd_impl="pallas" in interpret mode (bwd_recompute: a
    bf16 SLA forward, then the backward kernels on the unquantized inputs)
    against the port's Function on the CPU.

    With f32 inputs the bound is still a bf16 one (2^-8, one ulp): the
    recomputed forward runs on bf16 copies in both packages and returns a
    bf16 o, from the Pallas online softmax there and the gather reference
    here, so o (and with it delta = sum(o * do)) can differ by an ulp."""
    BH, L, D, block = 2, 200, 64, 64
    q, k, v, w = _inputs(11, BH, L, L, D, dtype)
    lut = _lut(12, BH, L, block, 3, True)

    def loss(q, k, v):
        o = ji8.int8_block_sparse_attention(q, k, v, jnp.asarray(lut), block, block, None, True,
                                            "pallas", True, True)
        return jnp.sum(o.astype(jnp.float32) * w.astype(jnp.float32))

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    leaves = [_to_torch(x, tdt).requires_grad_() for x in (q, k, v)]
    out = i8.int8_block_sparse_attention(*leaves, torch.tensor(lut), block, block)
    assert out.dtype == torch.bfloat16
    (out.float() * _to_torch(w, torch.float32)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
        assert a.grad.dtype == tdt, name
        assert rel_err(a.grad, b) <= tol, (name, rel_err(a.grad, b))


def test_twin_entries_match_dispatching_entries_on_cpu():
    """The `*_twin` entries (what the kernel path is compared with on the
    card) are the dispatching entries' CPU path."""
    BH, L, D, block = 2, 130, 64, 64
    lut = torch.tensor(_lut(13, BH, L, block, 2, False))
    for fn, twin, extra in ((bsa.block_sparse_attention, bsa.block_sparse_attention_twin,
                             (lut, block, block)),
                            (i8.int8_block_sparse_attention, i8.int8_block_sparse_attention_twin,
                             (lut, block, block)),
                            (bsa.flash_attention, bsa.flash_attention_twin, ())):
        grads = []
        for f in (fn, twin):
            leaves, do = _torch_leaves(14, BH, L, L, D)
            grads.append(torch.autograd.grad(f(*leaves, *extra), leaves, do.to(torch.float32)))
        for a, b in zip(*grads):
            assert torch.equal(a, b)
