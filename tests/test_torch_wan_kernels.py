"""The plain twins of the Wan path's three attention kernels, and the SLA
block map, against the JAX package on the CPU, at small odd shapes.

On the CPU every port wrapper runs its twin (the CUDA kernels run only on the
card: tests/test_torch_port_gpu.py, chip_smoke.py). JAX runs SLA through its
gather reference (its CPU path) and through the Pallas kernel in interpret
mode, flash and int8 SLA in interpret mode.

Tolerances:
  - f32 inputs: max|port - jax| <= 1e-5 * max(1, max|jax|), o and lse (the
    same f32 math, summed in another order);
  - bf16 outputs (int8 SLA's contract, bf16 flash, the SLA module's sparse
    branch): each element within one bf16 ulp (<= 2^-7 relative) of JAX's
    and at most 0.1% of them not bit-equal: f32 sums ~1e-7 apart round to
    neighbouring bf16 values when they straddle a rounding boundary.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.kernels import sla as jsla
from interpolated_diffusion_tpu.kernels.block_sparse_reference import (
    block_sparse_attention_reference as jref)
from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
from interpolated_diffusion_tpu_torch.kernels import sla

# the package's __init__ re-exports functions under the submodules' names
jbsa = importlib.import_module("interpolated_diffusion_tpu.kernels.block_sparse_attention")
ji8 = importlib.import_module("interpolated_diffusion_tpu.kernels.int8_attention")
BH, D = 3, 16


def close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def bf16_close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    d = np.abs(out - ref)
    assert (d <= 2.0 ** -7 * np.abs(ref) + 1e-30).all(), d.max()  # one bf16 ulp
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


def _qkv(L, seed, Lk=None, bh=BH, d=D):
    r = np.random.default_rng(seed)
    q = r.normal(size=(bh, L, d)).astype(np.float32)
    k, v = (r.normal(size=(bh, Lk or L, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _lut(L, block, topk, seed, n_blocks=None):
    """Distinct key blocks per row, random order."""
    r = np.random.default_rng(seed)
    m, n = -(-L // block), n_blocks or -(-L // block)
    return np.stack([np.stack([r.permutation(n)[:topk] for _ in range(m)])
                     for _ in range(BH)]).astype(np.int32)


@pytest.mark.parametrize("block", [32, 64])
def test_sla_twin_matches_jax_partial_last_block(block):
    L = 150                                   # the last block is partial at 32 and 64
    q, k, v = _qkv(L, block)
    lut = _lut(L, block, 2, block)
    o, lse = bsa.block_sparse_attention_fwd(*map(torch.tensor, (q, k, v, lut)), block, block)
    jo, jlse = jref(*map(jnp.asarray, (q, k, v, lut)), block, block)
    close(o, jo)
    close(lse, jlse)
    po, plse = jbsa._fwd_pallas(*map(jnp.asarray, (q, k, v, lut)), block, block, D ** -0.5,
                                interpret=True)
    close(o, po)
    close(lse, plse)
    close(bsa.block_sparse_attention(*map(torch.tensor, (q, k, v, lut)), block, block), jo)


def test_sla_lse_sentinel_matches_jax():
    """Sentinel LUT entries (id ceil(Lkv / block_n)) add nothing; rows of
    sentinels only give o = 0 and lse = log2(1e-30), never NaN."""
    block, L = 32, 100
    q, k, v = _qkv(L, 7)
    sentinel = -(-L // block)
    lut = _lut(L, block, 2, 7)
    lut[:, 1, 1] = sentinel                   # one real block + one sentinel
    lut[:, 2, :] = sentinel                   # all sentinels
    o, lse = bsa.block_sparse_attention_lse(*map(torch.tensor, (q, k, v, lut)), block, block)
    jo, jlse = jbsa.block_sparse_attention_lse(*map(jnp.asarray, (q, k, v, lut)), block, block,
                                               impl="reference")
    close(o, jo)
    close(lse, jlse, tol=1e-6)
    rows = slice(2 * block, 3 * block)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o[:, rows] == 0).all()
    np.testing.assert_allclose(lse[:, rows].numpy(), np.log2(1e-30), rtol=1e-6)


@pytest.mark.parametrize("Lq,Lk,block_n", [
    (300, 70, 128),
    # neither Lq nor Lk a multiple of the tiles: a ragged last key tile after
    # full ones, fewer keys than one tile, one row past a query block
    (136, 70, 128), (136, 70, 256), (64, 5, 128), (64, 5, 256), (300, 200, 128), (129, 131, 128),
    (129, 131, 256)])
def test_flash_twin_matches_pallas_interpret(Lq, Lk, block_n):
    """o and lse (f32, base 2) of the twin against the TPU kernel in interpret
    mode: rectangular Lq x Lk, keys past Lk at probability 0, rows past Lq not
    produced. This is the contract the CUDA kernel is held to on the card."""
    q, k, v = _qkv(Lq, 8, Lk=Lk)
    out = bsa.flash_attention(*map(torch.tensor, (q, k, v)), 128, block_n)
    ref = jbsa.flash_attention(*map(jnp.asarray, (q, k, v)), 128, block_n, interpret=True)
    assert out.shape == (BH, Lq, D)
    close(out, ref)
    _, lse = bsa.flash_attention_fwd(*map(torch.tensor, (q, k, v)), block_n=block_n)
    _, jlse = jbsa._fwd_pallas_dense(*map(jnp.asarray, (q, k, v)), 128, block_n, D ** -0.5,
                                     interpret=True)
    assert lse.shape == (BH, Lq)
    close(lse, jlse)


def test_flash_twin_bf16_matches_pallas_interpret():
    """bf16 q/k/v as WanAttention passes them (cross-attention shape, the
    JAX key tile max(128, Lk rounded up to 128)): P is rounded to bf16 per key
    tile in both, o to bf16."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(300, 15, Lk=70))
    out = bsa.flash_attention(q, k, v, 512, 128)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    ref = jbsa.flash_attention(jq, jk, jv, 512, 128, interpret=True)
    assert out.dtype == torch.bfloat16
    bf16_close(out.float(), np.asarray(ref.astype(jnp.float32)))


def test_quantize_rows_matches_jax():
    x = (np.random.default_rng(9).normal(size=(BH, 70, D)) * 3).astype(np.float32)
    x[0, 3] = 0.0                             # an all-zero row: scale floor 1e-8 / 127
    xi, s = i8.quantize_rows(torch.tensor(x))
    jxi, js = ji8.quantize_rows(jnp.asarray(x))
    assert xi.dtype == torch.int8
    np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_twin_matches_pallas_interpret_f32():
    """On the same int8 inputs with an f32 V (no rounding of P or o), the twin
    is the TPU kernel's arithmetic in the same order."""
    block, L = 32, 150
    q, k, v = _qkv(L, 10)
    lut = _lut(L, block, 3, 10)
    qi, ki, qs, ks = i8.quantize_qk(torch.tensor(q), torch.tensor(k))
    o, lse = i8.int8_attention_fwd(qi, ki, torch.tensor(v), qs, ks, torch.tensor(lut), block,
                                   block, D ** -0.5)
    jo, jlse = ji8._fwd_pallas_int8(*map(jnp.asarray, (qi.numpy(), ki.numpy(), v, qs.numpy(),
                                                       ks.numpy(), lut)),
                                    block, block, D ** -0.5, interpret=True)
    close(o, jo)
    close(lse, jlse)


def test_int8_public_matches_jax():
    """Public entry, bf16 q/k/v as the SLA module passes them: smooth-k and
    quantization inside, bf16 output."""
    block, L = 32, 150
    q, k, v = _qkv(L, 11)
    lut = _lut(L, block, 3, 11)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)
    out = i8.int8_block_sparse_attention(bf(q), bf(k), bf(v), torch.tensor(lut), block, block)
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    ref = ji8.int8_block_sparse_attention(jbf(q), jbf(k), jbf(v), jnp.asarray(lut), block, block,
                                          None, True, "pallas", True)
    assert out.dtype == torch.bfloat16
    bf16_close(out.float(), np.asarray(ref.astype(jnp.float32)))


def test_mean_pool_and_block_map_match_jax():
    """Ragged pooling; the top-k LUT equals JAX's as a set per row (the data
    has no ties)."""
    q, k, _ = _qkv(150, 12, bh=4)
    close(sla.mean_pool_blocks(torch.tensor(q), 32), jsla.mean_pool_blocks(jnp.asarray(q), 32))
    for ratio in (0.5, 0.1, 1.0):
        smap, lut, topk = sla.get_block_map(torch.tensor(q), torch.tensor(k), ratio, 32, 32)
        jsmap, jlut, jtopk = jsla.get_block_map(jnp.asarray(q), jnp.asarray(k), ratio, 32, 32)
        assert topk == jtopk and lut.dtype == torch.int32
        np.testing.assert_array_equal(np.sort(lut.numpy(), -1), np.sort(np.asarray(jlut), -1))
        np.testing.assert_array_equal(smap.numpy(), np.asarray(jsmap))


def _tied_qk(seed, n_blocks=32, block=32, d=2):
    """q, k [3, n_blocks * block, d] whose pooled block scores are small
    integers, many of them equal: every block holds one row repeated, q's rows
    in {0, 1}^d, k's blocks b and -b in pairs (so smooth-k subtracts zero)."""
    r = np.random.default_rng(seed)
    qb = r.integers(0, 2, size=(3, n_blocks, d)).astype(np.float32)
    kb = r.integers(0, 2, size=(3, n_blocks // 2, d)).astype(np.float32)
    kb = np.concatenate([kb, -kb], axis=1)
    return np.repeat(qb, block, axis=1), np.repeat(kb, block, axis=1)


@pytest.mark.parametrize("case", ["zero_q", "integer_ties", "random"])
@pytest.mark.parametrize("ratio", [0.1, 0.2, 0.5])
def test_block_map_breaks_ties_as_jax(case, ratio):
    """The LUT (in order) and the sparse map equal JAX's exactly, also where
    pooled scores tie: jax.lax.top_k puts the lower block index first."""
    if case == "random":
        q, k, _ = _qkv(32 * 31, 8, bh=3)
    else:
        q, k = _tied_qk(7)
        if case == "zero_q":   # every score 0: the first topk blocks
            q = np.zeros_like(q)
    smap, lut, topk = sla.get_block_map(torch.tensor(q), torch.tensor(k), ratio, 32, 32)
    jsmap, jlut, jtopk = jsla.get_block_map(jnp.asarray(q), jnp.asarray(k), ratio, 32, 32)
    assert topk == jtopk
    np.testing.assert_array_equal(lut.numpy(), np.asarray(jlut))
    np.testing.assert_array_equal(smap.numpy(), np.asarray(jsmap))
    if case == "zero_q":
        np.testing.assert_array_equal(lut.numpy(), np.broadcast_to(np.arange(topk), lut.shape))


@pytest.mark.parametrize("fmap", ["softmax", "elu", "relu"])
def test_linear_attention_matches_jax(fmap):
    q, k, v = _qkv(150, 13)
    close(sla._linear_attention(*map(torch.tensor, (q, k, v)), fmap),
          jsla._linear_attention(*map(jnp.asarray, (q, k, v)), fmap))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sparse_linear_attention_module_matches_jax(quant):
    """The SLA module in an f32 model: block map on f32 q/k, sparse branch on
    bf16 q/k/v (its output bf16), linear branch f32, non-zero proj_l."""
    r = np.random.default_rng(14)
    B, H, L, dh = 2, 3, 150, 16
    q, k, v = (r.normal(size=(B, H, L, dh)).astype(np.float32) for _ in range(3))
    jm = jsla.SparseLinearAttention(head_dim=dh, topk=0.5, block_q=32, block_k=32, quant=quant)
    w = r.normal(size=(dh, dh)).astype(np.float32) * 0.2
    b = r.normal(size=dh).astype(np.float32) * 0.1
    ref = jm.apply({"params": {"proj_l": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}},
                   *map(jnp.asarray, (q, k, v)))
    pm = sla.SparseLinearAttention(dh, topk=0.5, block_q=32, block_k=32, quant=quant)
    pm.load_state_dict({"proj_l.weight": torch.tensor(w.T.copy()), "proj_l.bias": torch.tensor(b)})
    with torch.no_grad():
        out = pm(*map(torch.tensor, (q, k, v)))
    assert out.shape == (B, H, L, dh) and out.dtype == torch.float32
    # the linear branch and projection agree to f32 rounding; the sparse
    # branch to one bf16 step on a few elements
    d = np.abs(out.numpy().astype(np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 2.0 ** -8 * np.abs(np.asarray(ref)).max(), d.max()
    assert (d > 1e-5 * np.abs(np.asarray(ref)).max()).mean() <= 1e-3
