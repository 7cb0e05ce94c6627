"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
mode). This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q

(--noconftest: tests/conftest.py sets up JAX for the CPU suite.) Shapes are
the bench's main path; tolerances are chip_smoke.py's, as max|kernel - twin|
over max|twin| in bf16: 2e-2 for the block and its GEMM alone, 1e-2 for the attention kernels
(o and lse), 0.08 for int8 SLA against the bf16 SLA twin, 2e-2 for the
attention backward kernels (dq, dk, dv: bf16 outputs of f32 sums over
products of twice-rounded bf16 factors).
"""
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
from interpolated_diffusion_tpu_torch.kernels import fused_block, int8_attention, small_mha
from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
    block_sparse_attention_reference)
from interpolated_diffusion_tpu_torch.kernels.sla import get_block_map

D, H, F = 384, 12, 1536


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins are f32 references
    return torch.device("cuda")


def _block_args(B, L, film, device, seed=0, D=D, F=F):
    r = np.random.default_rng(seed)
    n = lambda *s, scale=1.0: torch.tensor((r.normal(size=s) * scale).astype(np.float32),
                                           device=device)
    gb = lambda: n(B, 2 * D, scale=0.1) if film else torch.zeros((B, 2 * D), device=device)
    args = (gb(), gb(), 1 + n(D, scale=0.1), n(D, scale=0.1), 1 + n(D, scale=0.1),
            n(D, scale=0.1), n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.1),
            n(D, D, scale=D ** -0.5), n(D, scale=0.1), n(F, D, scale=D ** -0.5),
            n(F, scale=0.1), n(D, F, scale=F ** -0.5), n(D, scale=0.1))
    return n(B, L, D).to(torch.bfloat16), tuple(a.to(torch.bfloat16) for a in args)


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,film,d,h,f", [
    (1024, 8, True, D, H, F), (1024, 64, True, D, H, F), (1, 8, True, D, H, F),
    (37, 64, True, D, H, F), (37, 8, False, D, H, F),
    # the causal sampler's per-chunk Stage 1: K_local = 4 (its CLI default) and 3
    (1024, 4, True, D, H, F), (37, 3, True, D, H, F),
    # widths the 192-wide GEMM tile does not divide (N = 320, 1280: the 64- and
    # 128-column instantiations) and Dh = 64
    (64, 64, True, 320, 10, 1280), (64, 64, True, 384, 6, 1536)])
def test_fused_film_block_matches_twin(cuda, B, L, film, d, h, f):
    x, args = _block_args(B, L, film, cuda, D=d, F=f)
    before = fused_block.fused_film_block.launches
    before_len = dict(fused_block.fused_film_block.launches_by_len)
    with torch.inference_mode():
        out = fused_block.fused_film_block(x, *args, n_heads=h, use_film=film)
        ref = fused_block._torch_block(x, *args, n_heads=h, use_film=film)
    torch.cuda.synchronize()
    assert fused_block.fused_film_block.launches == before + 1
    before_len[L] = before_len.get(L, 0) + 1   # the same launch, counted by its length
    assert fused_block.fused_film_block.launches_by_len == before_len
    assert out.shape == (B, L, d) and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("M", [65536, 8192, 2368, 8])
@pytest.mark.parametrize("epilogue,N,K", [
    ("bias", 3 * D, D), ("resid_f32", D, D), ("bias_silu", F, D), ("resid_out", D, F),
    # widths the narrower tiles serve: 128 columns (N = 1280), 64 (N = 320)
    ("bias_silu", 1280, 320), ("resid_out", 320, 1280)])
def test_gemm_bias_act_matches_twin(cuda, M, epilogue, N, K):
    """The block's GEMM alone, each epilogue at its product of the path (M =
    65536 and 8192 are Stage 2's and Stage 1's rows at B = 1024), at a ragged M
    and at M = 8; f32 bias at the large M, bf16 at the others."""
    g = torch.Generator(device=cuda).manual_seed(M + N)
    bf = torch.bfloat16
    a = torch.randn((M, K), generator=g, device=cuda).to(bf)
    w = (torch.randn((N, K), generator=g, device=cuda) * K ** -0.5).to(bf)
    bias = 0.1 * torch.randn(N, generator=g, device=cuda)
    bias = bias if M == 65536 else bias.to(bf)
    resid = {"resid_f32": torch.randn((M, N), generator=g, device=cuda).to(bf),
             "resid_out": torch.randn((M, N), generator=g, device=cuda)}.get(epilogue)
    before = fused_block.gemm_bias_act.launches
    with torch.inference_mode():
        out = fused_block.gemm_bias_act(a, w, bias, epilogue, resid)
        ref = fused_block._torch_gemm(a, w, bias, epilogue, resid)
    torch.cuda.synchronize()
    assert fused_block.gemm_bias_act.launches == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype and torch.isfinite(out).all()
    assert _rel(out, ref) <= 2e-2


@pytest.mark.gpu
def test_gemm_bias_act_raises_instead_of_falling_back(cuda):
    bf = torch.bfloat16
    a, w = torch.zeros((16, 128), dtype=bf, device=cuda), torch.zeros((64, 128), dtype=bf, device=cuda)
    bias = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):          # f32 activations: the kernel takes bf16
        fused_block.gemm_bias_act(a.float(), w, bias)
    with pytest.raises(ValueError):          # N = 96 is no multiple of 64
        fused_block.gemm_bias_act(a, w.new_zeros((96, 128)), bias.new_zeros(96))
    with pytest.raises(ValueError):          # the residual epilogue without its residual
        fused_block.gemm_bias_act(a, w, bias, "resid_out")
    with pytest.raises(ValueError):          # bias on another device
        fused_block.gemm_bias_act(a, w, bias.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 8, 17, 64, 200, 256])
@pytest.mark.parametrize("h,dm", [(12, 384), (6, 384), (5, 160), (3, 192)])
def test_small_mha_kernel_window(cuda, L, h, dm):
    """small_mha_kernel over its window through both entries: every strip
    length, one row, ragged lengths, head dims 32 and 64, and head counts that
    leave a block's last group of heads short (5 heads of 32, 3 of 64)."""
    g = torch.Generator(device=cuda).manual_seed(L + h)
    for entry, heads in ((small_mha.small_mha_packed, h),
                         (small_mha.small_mha, min(h, 1024 // L))):
        width = heads * (dm // h)
        qkv = torch.randn((67, L, 3 * width), generator=g, device=cuda).to(torch.bfloat16)
        q, k, v = qkv.split(width, dim=-1)
        with torch.inference_mode():
            out, ref = entry(q, k, v, heads), small_mha._torch_attention(q, k, v, heads)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and _rel(out, ref) <= 1e-2


@pytest.mark.gpu
def test_small_mha_packed_many_blocks(cuda):
    """B * H beyond 65535 (24000 samples x 6 heads of 64, two heads a block:
    72000 blocks): the grid is one-dimensional."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((24000, 8, 3 * D), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    with torch.inference_mode():
        out, ref = small_mha.small_mha_packed(q, k, v, 6), small_mha._torch_attention(q, k, v, 6)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("L,h", [(8, H), (64, H), (100, H), (256, H), (64, 6), (256, 6)])
def test_small_mha_packed_matches_twin(cuda, L, h):
    """h = 6 gives head dim 64; L = 256 with it holds the longest logits strip
    (128 floats a thread) beside the widest accumulator."""
    g = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn((64, L, 3 * D), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    before = small_mha.small_mha_packed.launches
    with torch.inference_mode():
        out = small_mha.small_mha_packed(q, k, v, h)
        ref = small_mha._torch_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert small_mha.small_mha_packed.launches == before + 1
    assert _rel(out, ref) <= 1e-2


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA input the kernels do not take raises; an autograd input is taken
    (the forward launches the kernel, the backward recomputes the twin)."""
    x = torch.randn((2, 8, D), device=cuda)
    for entry in (small_mha.small_mha_packed, small_mha.small_mha):
        with pytest.raises(ValueError):          # f32 activations: the kernels take bf16
            entry(x, x, x, H)
        xb = x.to(torch.bfloat16)
        with pytest.raises(ValueError):          # head dim 384 / 4 = 96 is not 32 or 64
            entry(xb, xb, xb, 4)
        before = entry.launches
        leaf = xb.clone().requires_grad_()
        entry(leaf, leaf, leaf, H).float().sum().backward()   # autograd inputs: kernel forward
        assert entry.launches == before + 1 and torch.isfinite(leaf.grad).all()
    long = torch.zeros((1, 512, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="512"):     # L > 256 is outside the packed window
        small_mha.small_mha_packed(long, long, long, 2)
    with pytest.raises(ValueError, match="512"):     # H * L = 2048 > 1024
        small_mha.small_mha(long, long, long, 4)
    xb, args = _block_args(2, 8, True, cuda)
    with pytest.raises(ValueError):          # f32 activations
        fused_block.fused_film_block(xb.float(), *args, n_heads=H)
    with pytest.raises(ValueError):          # one f32 bias among bf16 ones: mixed vectors
        fused_block.fused_film_block(xb, *args[:7], args[7].float(), *args[8:], n_heads=H)
    with pytest.raises(ValueError):          # f32 FiLM rows
        fused_block.fused_film_block(xb, args[0].float(), *args[1:], n_heads=H)


def _masters(args):
    """The block's parameters as f32 masters (FiLM rows stay bf16)."""
    return tuple(a if i < 2 else a.float() for i, a in enumerate(args))


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,h,dm", [
    (256, 64, H, D), (64, 8, H, D), (64, 100, 6, D),        # L <= 256: small_mha_kernel
    (64, 512, 2, 128), (16, 1024, 1, 64), (8, 300, 2, 64),  # tiled over queries and keys
    (8, 333, 3, 96),
    # the tiled kernel's edges: the first L past the one-block kernel, ragged
    # last tiles, the widest window (L = 1024 at H = 1), head dims 32 and 64
    (8, 257, 2, 64), (8, 257, 2, 128), (8, 300, 2, 128), (16, 512, 2, 64), (16, 1024, 1, 32),
    (3, 449, 1, 64), (700, 260, 3, 96)])
def test_small_mha_matches_twin(cuda, B, L, h, dm):
    """q, k, v are strided views of one qkv tensor, as the block passes them."""
    g = torch.Generator(device=cuda).manual_seed(L + h)
    qkv = torch.randn((B, L, 3 * dm), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(dm, dim=-1)
    before = small_mha.small_mha.launches, small_mha.small_mha_packed.launches
    with torch.inference_mode():
        out = small_mha.small_mha(q, k, v, h)
        ref = small_mha._torch_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert (small_mha.small_mha.launches, small_mha.small_mha_packed.launches) == \
        (before[0] + 1, before[1])
    assert torch.isfinite(out).all() and _rel(out, ref) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("entry,L", [("small_mha", 64), ("small_mha_packed", 64),
                                     ("small_mha", 512), ("small_mha_packed", 8),
                                     ("small_mha", 300)])
def test_small_mha_gradients_match_twin_path(cuda, entry, L):
    """Kernel forward + twin-recompute backward against the twin path's
    output and gradients (2e-2 of each gradient's max)."""
    h, dm, B = (2, 128, 32) if L > 256 else (H, D, 256)
    g = torch.Generator(device=cuda).manual_seed(L)
    base = torch.randn((B, L, 3 * dm), generator=g, device=cuda).to(torch.bfloat16)
    do = torch.randn((B, L, dm), generator=g, device=cuda).to(torch.bfloat16)
    results = []
    for fn in (getattr(small_mha, entry), getattr(small_mha, entry + "_twin")):
        qkv = base.clone().requires_grad_()
        q, k, v = qkv.split(dm, dim=-1)
        out = fn(q, k, v, h)
        out.backward(do)
        results.append((out.detach(), qkv.grad))
    torch.cuda.synchronize()
    assert _rel(results[0][0], results[1][0]) <= 1e-2
    assert _rel(results[0][1], results[1][1]) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("L,film,masters", [(64, True, True), (8, True, True),
                                            (64, False, True), (64, True, False)])
def test_fused_film_block_gradients_match_twin_path(cuda, L, film, masters):
    """Kernel forward + twin-recompute backward against the twin path: output
    2e-2, every input's gradient 2e-2 of its max; f32 masters get f32
    gradients."""
    B = 256
    x, args = _block_args(B, L, film, cuda, seed=L)
    if masters:
        args = _masters(args)
    dy = torch.randn((B, L, D), device=cuda, generator=torch.Generator(device=cuda).manual_seed(1)
                     ).to(torch.bfloat16)
    results = []
    before = fused_block.fused_film_block.launches
    for fn in (fused_block.fused_film_block, fused_block.fused_film_block_twin):
        leaves = [t.clone().requires_grad_() for t in (x, *args)]
        out = fn(*leaves, n_heads=H, use_film=film)
        grads = torch.autograd.grad(out, leaves, dy, allow_unused=not film)
        results.append((out.detach(), grads, leaves))
    torch.cuda.synchronize()
    assert fused_block.fused_film_block.launches == before + 1
    assert _rel(results[0][0], results[1][0]) <= 2e-2
    for gk, gt, leaf in zip(results[0][1], results[1][1], results[0][2]):
        if gt is None:
            assert gk is None
            continue
        assert gk.dtype == leaf.dtype and gk.shape == leaf.shape
        assert _rel(gk, gt) <= 2e-2


@pytest.mark.gpu
def test_fused_film_block_f32_masters_match_twin(cuda):
    """The kernels read f32 biases and LN vectors as they are and cast f32
    weight matrices to bf16, as the twin does."""
    x, args = _block_args(64, 64, True, cuda, seed=5)
    args = _masters(args)
    with torch.inference_mode():
        out = fused_block.fused_film_block(x, *args, n_heads=H)
        ref = fused_block._torch_block(x, *args, n_heads=H, use_film=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and _rel(out, ref) <= 2e-2


def _qkv_bf16(bh, L, d, device, seed, Lk=None):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((bh, L, d), generator=g, device=device).to(torch.bfloat16)
    k, v = (torch.randn((bh, Lk or L, d), generator=g, device=device).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


# (BH, L, Dh, block_m, block_n, top-k ratio, duplicated ids) of the SLA
# forward kernels' cases: ragged last blocks, the Wan sampler's and trainer's
# shapes, blocks of 64 and 192 (the two 64-row halves of a 128-row work item
# follow different LUT rows, and the last 128-key tile of an id is half
# masked), block_m != block_n both ways, and LUTs with duplicated ids.
SLA_CASES = [
    (6, 1000, 128, 128, 128, 0.3, False), (6, 1000, 64, 128, 128, 0.3, False),
    (6, 1000, 128, 256, 256, 0.5, False), (6, 1000, 64, 256, 256, 0.5, False),
    (6, 7800, 128, 128, 128, 0.1, False), (24, 7800, 128, 256, 256, 0.1, False),
    (6, 1000, 128, 64, 64, 0.3, False), (6, 1000, 64, 192, 192, 0.3, False),
    (6, 1000, 128, 192, 64, 0.3, False), (6, 1000, 128, 128, 256, 0.5, False),
    (6, 1000, 64, 256, 128, 0.3, False), (6, 1000, 128, 128, 128, 0.4, True),
    (6, 1000, 64, 192, 192, 0.4, True), (6, 1000, 128, 256, 256, 0.5, True)]


def _sla_lut(q, k, ratio, bm, bn, dup):
    _, lut, _ = get_block_map(q, k, ratio, bm, bn)
    if dup:   # every second row repeats its first id in its last slot
        lut[:, ::2, -1] = lut[:, ::2, 0]
    return lut.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("bh,L,d,bm,bn,ratio,dup", SLA_CASES)
def test_sla_kernel_matches_twin(cuda, bh, L, d, bm, bn, ratio, dup):
    q, k, v = _qkv_bf16(bh, L, d, cuda, L + d + bm + bn)
    lut = _sla_lut(q, k, ratio, bm, bn, dup)
    before = bsa.block_sparse_attention.launches
    with torch.inference_mode():
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn)
        ro, rlse = block_sparse_attention_reference(q, k, v, lut, bm, bn)
    torch.cuda.synchronize()
    assert bsa.block_sparse_attention.launches == before + 1
    assert o.dtype == torch.bfloat16 and torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _rel(o, ro) <= 1e-2
    assert _rel(lse, rlse) <= 1e-2


@pytest.mark.gpu
def test_sla_lse_kernel_sentinel(cuda):
    """Sentinel entries add nothing; rows of sentinels give o = 0 and
    lse = log2(1e-30), as the twin does."""
    block, L = 128, 1000
    q, k, v = _qkv_bf16(4, L, 128, cuda, 3)
    _, lut, _ = get_block_map(q, k, 0.3, block, block)
    sentinel = -(-L // block)
    lut[:, 1, -1] = sentinel
    lut[:, 3, :] = sentinel
    with torch.inference_mode():
        o, lse = bsa.block_sparse_attention_lse(q, k, v, lut.contiguous(), block, block)
        ro, rlse = block_sparse_attention_reference(q, k, v, lut, block, block, kv_len=L,
                                                    kv_pad_blocks=1)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _rel(o, ro) <= 1e-2 and _rel(lse, rlse) <= 1e-2
    rows = slice(3 * block, 4 * block)
    assert (o[:, rows] == 0).all()
    torch.testing.assert_close(lse[:, rows], torch.full_like(lse[:, rows], float(np.log2(1e-30))))


@pytest.mark.gpu
@pytest.mark.parametrize("bm,bn,d", [(128, 128, 128), (192, 64, 64), (256, 128, 128)])
def test_sla_kernel_kv_len_below_lk(cuda, bm, bn, d):
    """kv_len < Lk: keys kv_len..Lk hold data and get probability 0; LUT ids
    from the first kv_len keys, sentinels among them, and a query block whose
    every entry is a sentinel (o = 0, lse = log2(1e-30))."""
    L, kv_len = 1000, 700
    q, k, v = _qkv_bf16(6, L, d, cuda, bm + bn + d)
    _, lut, _ = get_block_map(q, k[:, :kv_len], 0.5, bm, bn)
    sentinel = -(-kv_len // bn)
    lut[:, 1::2, -1] = sentinel
    lut[:, 2, :] = sentinel
    lut = lut.contiguous()
    with torch.inference_mode():
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn, kv_len=kv_len,
                                                kv_pad_blocks=1)
        ro, rlse = block_sparse_attention_reference(q, k, v, lut, bm, bn, kv_len=kv_len,
                                                    kv_pad_blocks=1)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _rel(o, ro) <= 1e-2 and _rel(lse, rlse) <= 1e-2
    rows = slice(2 * bm, 3 * bm)
    assert (o[:, rows] == 0).all()
    torch.testing.assert_close(lse[:, rows], torch.full_like(lse[:, rows], float(np.log2(1e-30))))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["sla", "int8"])
@pytest.mark.parametrize("bm,bn", [(128, 128), (192, 64)])
def test_sla_kernels_are_deterministic(cuda, which, bm, bn):
    """Every output row has one writer and no atomics: two calls give the
    same bits."""
    q, k, v = _qkv_bf16(6, 1000, 128, cuda, 8)
    lut = _sla_lut(q, k, 0.4, bm, bn, True)
    qi, ki, qs, ks = int8_attention.quantize_qk(q, k)
    with torch.inference_mode():
        if which == "sla":
            first, second = (bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn)
                             for _ in range(2))
        else:
            first, second = (int8_attention.int8_attention_fwd(qi, ki, v, qs, ks, lut, bm, bn,
                                                               128 ** -0.5) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lk,d", [
    (1000, 517, 128), (1000, 70, 128), (1000, 517, 64), (333, 70, 64), (2048, 2048, 128),
    # the edges of the 128-row query block and the 128-key tile (one row or
    # key, one short of / exactly / one past a tile, the Wan path's 7800 and 517)
    *[(lq, lk, d) for lq in (1, 127, 128, 129, 7800) for lk in (1, 5, 128, 129, 517)
      for d in (64, 128)]])
def test_flash_kernel_matches_twin(cuda, Lq, Lk, d):
    """o and lse; a row written past Lq would land in the next head's rows."""
    q, k, v = _qkv_bf16(6, Lq, d, cuda, Lq + Lk + d, Lk=Lk)
    before = bsa.flash_attention.launches
    with torch.inference_mode():
        o, lse = bsa.flash_attention_fwd(q, k, v)
        ro, rlse = bsa._torch_flash(q, k, v, d ** -0.5, 1024)
    torch.cuda.synchronize()
    assert bsa.flash_attention.launches == before + 1
    assert _rel(o, ro) <= 1e-2 and _rel(lse, rlse) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("bh,L,d,bm,bn,ratio,dup", [
    (6, 1000, 128, 128, 128, 0.3, False), (6, 1000, 64, 128, 128, 0.3, False),
    (6, 1000, 128, 256, 256, 0.3, False), (6, 7800, 128, 128, 128, 0.3, False),
    (24, 7800, 128, 256, 256, 0.1, False),   # the Wan trainer's shape
    (6, 1000, 64, 256, 256, 0.5, False),     # head dim 64: 64-byte rows
    (6, 1000, 64, 64, 64, 0.3, False), (6, 1000, 128, 192, 192, 0.3, True),
    (6, 1000, 128, 128, 256, 0.5, False), (6, 1000, 64, 192, 64, 0.3, True)])
def test_int8_kernel_matches_twins(cuda, bh, L, d, bm, bn, ratio, dup):
    q, k, v = _qkv_bf16(bh, L, d, cuda, 7 * L + d + bm + bn)
    lut = _sla_lut(q, k, ratio, bm, bn, dup)
    qi, ki, qs, ks = int8_attention.quantize_qk(q, k)
    before = int8_attention.int8_block_sparse_attention.launches
    with torch.inference_mode():
        o, lse = int8_attention.int8_attention_fwd(qi, ki, v, qs, ks, lut, bm, bn, d ** -0.5)
        ro, rlse = int8_attention._torch_int8_attention(qi, ki, v, qs, ks, lut, bm, bn,
                                                        d ** -0.5)
        bo, _ = block_sparse_attention_reference(q, k, v, lut, bm, bn)
        pub = int8_attention.int8_block_sparse_attention(q, k, v, lut, bm, bn)
    torch.cuda.synchronize()
    assert int8_attention.int8_block_sparse_attention.launches == before + 2
    assert _rel(o, ro) <= 1e-2 and _rel(lse, rlse) <= 1e-2
    assert _rel(o, bo) <= 0.08                 # the reference's own int8 bound
    assert torch.equal(pub, o)


@pytest.mark.gpu
def test_attention_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _qkv_bf16(2, 256, 128, cuda, 0)
    _, lut, _ = get_block_map(q, k, 0.5, 128, 128)
    with pytest.raises(ValueError):          # f32 inputs: the kernels take bf16
        bsa.block_sparse_attention(q.float(), k.float(), v.float(), lut, 128, 128)
    with pytest.raises(ValueError):
        bsa.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError):          # head dim 96
        bsa.flash_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                            v[..., :96].contiguous())
    with pytest.raises(ValueError):          # int64 LUT
        bsa.block_sparse_attention(q, k, v, lut.long(), 128, 128)
    with pytest.raises(ValueError):          # SLA block not a multiple of 64
        bsa.block_sparse_attention(q, k, v, get_block_map(q, k, 0.5, 32, 32)[1], 32, 32)
    with pytest.raises(ValueError):          # f32 upstream gradient buffers: bf16 only
        bsa.sla_bwd_dq(q, k, v, lut, q.float(), torch.zeros(q.shape[:2], device=cuda),
                       torch.zeros(q.shape[:2], device=cuda), 128, 128, 1.0)
    qi, ki, qs, ks = int8_attention.quantize_qk(q, k)
    with pytest.raises(ValueError):          # f32 V: the int8 kernel takes bf16 V
        int8_attention.int8_attention_fwd(qi, ki, v.float(), qs, ks, lut, 128, 128, 1.0)


BWD_TOL = 2e-2


def _dup_lut(q, k, ratio, block):
    """The block map's LUT with the last entry of every second row replaced
    by a repeat of the first: duplicated ids, as padded rows have."""
    _, lut, _ = get_block_map(q, k, ratio, block, block)
    lut[:, ::2, -1] = lut[:, ::2, 0]
    return lut.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("L,d,block,ratio,dup", [
    (1000, 128, 128, 0.4, False), (1000, 64, 128, 0.4, True),    # ragged: 1000 = 7 * 128 + 104
    (1024, 128, 128, 0.4, True), (1024, 64, 256, 0.5, False),    # aligned
    (1000, 128, 256, 0.5, True), (1000, 64, 256, 0.5, True),
    (7800, 128, 256, 0.1, False), (7800, 128, 128, 0.1, True),   # the Wan trainer's L
    # block (block_m, block_n): 192, and block_m != block_n both ways (the two
    # 64-row halves of a work item in different query or key blocks)
    (1000, 128, 192, 0.3, False), (1000, 64, (192, 64), 0.3, True),
    (1000, 128, (128, 256), 0.5, False), (1111, 64, (64, 192), 0.4, False),
    # dup "unnamed": one key block appears in no LUT row; its dk, dv are 0
    (1000, 128, (256, 128), 0.3, "unnamed"), (7800, 128, 256, 0.1, "unnamed")])
def test_sla_bwd_kernels_match_twin(cuda, L, d, block, ratio, dup):
    bm, bn = block if isinstance(block, tuple) else (block, block)
    q, k, v = _qkv_bf16(6, L, d, cuda, L + d + bm + bn)
    do = _qkv_bf16(6, L, d, cuda, 1)[0]
    lut = get_block_map(q, k, ratio, bm, bn)[1]
    if dup is True:
        lut[:, ::2, -1] = lut[:, ::2, 0]
    unnamed = 2
    if dup == "unnamed":
        lut = torch.where(lut == unnamed, unnamed + 1, lut)
    lut = lut.contiguous()
    before = bsa.sla_bwd_dq.launches, bsa.sla_bwd_dkdv.launches
    with torch.inference_mode():
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn)
        got = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, bm, bn)
        ref = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, bm, bn, twin=True)
    torch.cuda.synchronize()
    assert (bsa.sla_bwd_dq.launches, bsa.sla_bwd_dkdv.launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel(a, b) <= BWD_TOL, (name, _rel(a, b))
    if dup == "unnamed":
        keys = slice(unnamed * bn, (unnamed + 1) * bn)
        assert all(bool((t[:, keys] == 0).all()) for t in got[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("L,d,block", [(7800, 128, 256), (1000, 64, (192, 64)),
                                       (1000, 128, (128, 256))])
def test_sla_bwd_kernels_are_deterministic(cuda, L, d, block):
    """Every output row is written by one block, without atomics on data (the
    dK/dV ticket counter only picks the SM): two calls give the same bits."""
    bm, bn = block if isinstance(block, tuple) else (block, block)
    q, k, v = _qkv_bf16(6, L, d, cuda, 7)
    do = _qkv_bf16(6, L, d, cuda, 8)[0]
    lut = get_block_map(q, k, 0.3, bm, bn)[1]
    with torch.inference_mode():
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn)
        first = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, bm, bn)
        second = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, bm, bn)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lk,d,bh", [
    (1000, 517, 128, 6), (1000, 70, 64, 6), (333, 517, 64, 6), (1024, 1024, 128, 6),
    (2048, 2048, 64, 6),
    (300, 133, 128, 6),     # ragged in both, through the forward's lse
    (129, 65, 128, 6),      # one row / key past the 128-row blocks and 64-row tiles
    (7800, 517, 128, 24),   # the Wan trainer's cross-attention
    (200, 40, 64, 6)])      # fewer keys than one 64-key tile
def test_flash_bwd_kernels_match_twin(cuda, Lq, Lk, d, bh):
    q, k, v = _qkv_bf16(bh, Lq, d, cuda, Lq + Lk + d, Lk=Lk)
    do = _qkv_bf16(bh, Lq, d, cuda, 2)[0]
    before = bsa.flash_bwd_dq.launches, bsa.flash_bwd_dkdv.launches
    with torch.inference_mode():
        o, lse = bsa.flash_attention_fwd(q, k, v)
        got = bsa.flash_attention_bwd(q, k, v, o, lse, do)
        ref = bsa.flash_attention_bwd(q, k, v, o, lse, do, twin=True)
    torch.cuda.synchronize()
    assert (bsa.flash_bwd_dq.launches, bsa.flash_bwd_dkdv.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel(a, b) <= BWD_TOL, (name, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lk,d", [(1000, 517, 128), (300, 40, 64)])
def test_flash_bwd_kernels_are_deterministic(cuda, Lq, Lk, d):
    """Every output row is written by one block, without atomics: two calls
    give the same bits."""
    q, k, v = _qkv_bf16(6, Lq, d, cuda, 3, Lk=Lk)
    do = _qkv_bf16(6, Lq, d, cuda, 4)[0]
    with torch.inference_mode():
        o, lse = bsa.flash_attention_fwd(q, k, v)
        first = bsa.flash_attention_bwd(q, k, v, o, lse, do)
        second = bsa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["sla", "int8", "flash"])
def test_functions_kernel_path_matches_twin_path(cuda, which):
    """The autograd Functions: gradients of a scalar loss through the kernel
    path against the same Function through the twins (forward and backward)."""
    L, d, block = 1000, 128, 128
    q, k, v = _qkv_bf16(4, L, d, cuda, 5, Lk=517 if which == "flash" else None)
    w = _qkv_bf16(4, L, d, cuda, 6)[0].float()
    lut = _dup_lut(q, k, 0.4, block)
    fns = {"sla": (bsa.block_sparse_attention, bsa.block_sparse_attention_twin),
           "int8": (int8_attention.int8_block_sparse_attention,
                    int8_attention.int8_block_sparse_attention_twin),
           "flash": (bsa.flash_attention, bsa.flash_attention_twin)}[which]
    grads = []
    for fn in fns:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves) if which == "flash" else fn(*leaves, lut, block, block)
        (out.float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        assert a is not None and a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        assert _rel(a, b) <= BWD_TOL, (name, _rel(a, b))


@pytest.mark.gpu
def test_causal_pipeline_kernel_path_matches_twin_path(cuda, monkeypatch):
    """sample/generate_causal under policy block: each chunk's Stage 1 runs
    fused_film_block at [B, 4, 384] (4 chunks x 4 DDIM evaluations x 2
    layers), the causal Stage 2 plain attention; the twin path on the same
    draws agrees within chip_smoke.py's pipeline tolerance (5e-2)."""
    from interpolated_diffusion_tpu_torch.models import transformer
    from interpolated_diffusion_tpu_torch.models.denoisers import (InterpLevelDenoiser,
                                                                  KeypointDenoiser)
    from interpolated_diffusion_tpu_torch.models.init import build_model
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample import generate_causal

    w = dict(d_model=D, n_layers=2, n_heads=H, d_ff=F, d_cond=128, maze_channels=(32, 64),
             dtype=torch.bfloat16, device=cuda, attn_policy="block")
    kp = build_model(KeypointDenoiser, generator=torch.Generator().manual_seed(1), **w).eval()
    it = build_model(InterpLevelDenoiser, generator=torch.Generator().manual_seed(2),
                     mask_channels=2, causal=True, **w).eval()
    with torch.no_grad():
        it.out.weight.normal_(0.0, 0.02, generator=torch.Generator(cuda).manual_seed(3))
    B, T = 64, 64
    g = torch.Generator(cuda).manual_seed(4)
    cond = {"occ": (torch.rand((B, 1, 21, 21), generator=g, device=cuda) < 0.2).float(),
            "start_goal": torch.rand((B, 4), generator=g, device=cuda)}
    pipe = generate_causal.make_causal_pipeline(
        kp, it, make_schedule("linear", 100, device=cuda), T=T, K_min=4, levels=3, chunk=16,
        ddim_steps=5, data_dim=2, mask_channels=2)
    draws = generate_causal.make_causal_draws(T, 4, 16, B, 2, g)
    before = fused_block.fused_film_block.launches
    before_len = dict(fused_block.fused_film_block.launches_by_len)
    out = pipe(cond, draws=draws)
    torch.cuda.synchronize()
    assert fused_block.fused_film_block.launches - before == 4 * 4 * 2
    assert fused_block.fused_film_block.launches_by_len[4] - before_len.get(4, 0) == 4 * 4 * 2
    monkeypatch.setattr(transformer, "fused_film_block", fused_block.fused_film_block_twin)
    ref = pipe(cond, draws=draws)
    assert out.shape == (B, T, 2) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 5e-2


# The Wan Phase-2 trainer's attention shapes: B = 2 x 12 heads, L = 21 x 30 x
# 52 = 32760 tokens (the last 256-key block holds 248), SLA block 256, top-k
# int(0.1 x 128) = 12; cross-attention to 512 text + 21 frame tokens.
PHASE2_BH, PHASE2_L, PHASE2_LK = 24, 32760, 533


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["sla", "int8", "sla_bwd"])
def test_phase2_shape_sla_kernels_match_twins(cuda, which):
    q, k, v = _qkv_bf16(PHASE2_BH, PHASE2_L, 128, cuda, 31)
    _, lut, topk = get_block_map(q, k, 0.1, 256, 256)
    assert topk == 12
    with torch.inference_mode():
        ref = block_sparse_attention_reference(q, k, v, lut, 256, 256)
        if which == "sla":
            got = bsa.block_sparse_attention_fwd(q, k, v, lut, 256, 256)
            pairs = zip(got, ref)
        elif which == "int8":
            qi, ki, qs, ks = int8_attention.quantize_qk(q, k)
            got = int8_attention.int8_attention_fwd(qi, ki, v, qs, ks, lut, 256, 256, 128 ** -0.5)
            want = int8_attention._torch_int8_attention(qi, ki, v, qs, ks, lut, 256, 256,
                                                        128 ** -0.5)
            assert _rel(got[0], ref[0]) <= 0.08
            pairs = zip(got, want)
        else:
            do = _qkv_bf16(PHASE2_BH, PHASE2_L, 128, cuda, 32)[0]
            o, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, 256, 256)
            got = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, 256, 256)
            pairs = zip(got, bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, 256, 256,
                                                            twin=True))
    torch.cuda.synchronize()
    tol = BWD_TOL if which == "sla_bwd" else 1e-2
    for a, b in pairs:
        assert torch.isfinite(a).all() and _rel(a, b) <= tol, _rel(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("Lk", [PHASE2_LK, PHASE2_L])
def test_phase2_shape_flash_kernels_match_twins(cuda, Lk):
    q, k, v = _qkv_bf16(PHASE2_BH, PHASE2_L, 128, cuda, 33, Lk=Lk)
    do = _qkv_bf16(PHASE2_BH, PHASE2_L, 128, cuda, 34)[0]
    with torch.inference_mode():
        o, lse = bsa.flash_attention_fwd(q, k, v)
        ref = bsa._torch_flash(q, k, v, 128 ** -0.5, 1024)
        got = bsa.flash_attention_bwd(q, k, v, o, lse, do)
        want = bsa.flash_attention_bwd(q, k, v, o, lse, do, twin=True)
    torch.cuda.synchronize()
    assert _rel(o, ref[0]) <= 1e-2 and _rel(lse, ref[1]) <= 1e-2
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and _rel(a, b) <= BWD_TOL, _rel(a, b)


def _phase2_args(extra=()):
    from interpolated_diffusion_tpu_torch.train import train_interp_levels_wansynth as p2

    return p2, p2.build_argparser().parse_args(
        ["--T", "17", "--latent_c", "4", "--latent_h", "16", "--latent_w", "32",
         "--text_len", "8", "--text_dim", "64", "--wan_dim", "256", "--wan_layers", "2",
         "--wan_heads", "2", "--wan_ffn", "512", "--lora_rank", "4", "--K_min", "3",
         "--attn_mode", "dense", "--device", "cuda", *extra])


@pytest.mark.gpu
def test_phase2_loss_kernel_path_matches_twin_path(cuda, monkeypatch):
    """The Phase-2 loss and every trainable leaf's gradient at head dim 128,
    17 frames of 128 tokens (L = 2176: self- and cross-attention through the
    flash kernels), bf16: the kernel path against the same step through the
    flash twins, chip_smoke.py's training tolerances (1e-2 loss, 5e-2
    gradients)."""
    from interpolated_diffusion_tpu_torch.models import wan_dit
    from interpolated_diffusion_tpu_torch.train.state import flatten_dict, tree_leaves

    p2, args = _phase2_args()
    state, _, _, model, fc = p2.make_trainer(args, cuda)
    g = torch.Generator(cuda).manual_seed(5)
    batch = {"latents": torch.randn(2, 17, 4, 16, 32, generator=g, device=cuda),
             "text_embed": torch.randn(2, 8, 64, generator=g, device=cuda) * 0.02}
    draws = p2.make_phase2_draws(g, args, 2, 17, 128 * 16)
    leaves = tree_leaves(state.params)
    with torch.no_grad():
        for name, p in flatten_dict(state.params).items():
            if name.endswith("lora_B") or name.startswith("frame_cond/out"):
                p.normal_(0.0, 0.02, generator=g)
    before = bsa.flash_attention.launches
    results = []
    for twin in (False, True):
        if twin:
            monkeypatch.setattr(wan_dit, "flash_attention", bsa.flash_attention_twin)
        loss, _ = p2.phase2_loss(model, fc, args, batch, draws)
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        if not twin:   # self + cross, 2 layers, forward and the remat recompute
            assert bsa.flash_attention.launches - before == 2 * 2 * 2
    (lk, gk), (lt, gt) = results
    assert abs(lk.item() - lt.item()) <= 1e-2 * abs(lt.item())
    for a, b in zip(gk, gt):
        assert torch.isfinite(a).all() and _rel(a, b) <= 5e-2, _rel(a, b)


@pytest.mark.gpu
def test_merged_lora_on_the_card_is_apply_lora(cuda):
    """The merged form in bf16 on the card: each Linear merges its adapter at
    the JAX rounding point, so the model agrees with a lora_rank 0 model
    holding models/lora.apply_lora's merged weights (the two f32 products of
    rank 4 may round a weight to the neighbouring bf16 value)."""
    from interpolated_diffusion_tpu_torch.models import lora
    from interpolated_diffusion_tpu_torch.models.wan_dit import WanDiT
    from interpolated_diffusion_tpu_torch.train import wansynth_common as common

    p2, args = _phase2_args(["--lora_form", "merged"])
    args.frame_cond, args.frame_cond_dim = 0, 7
    wan, _ = common.build_wan(args, True, device=cuda, zero_init_scale=0.05,
                              generator=torch.Generator(cuda).manual_seed(6))
    lora_sd, base = common.split_lora_state_dict(wan.state_dict())
    plain = WanDiT(dim=256, n_layers=2, n_heads=2, ffn_dim=512, in_channels=4, out_channels=4,
                   text_dim=64).to(cuda, torch.bfloat16).eval()
    plain.load_state_dict(lora.apply_lora(base, lora.leaves_to_tree(lora_sd), 4, 16.0))
    g = torch.Generator(cuda).manual_seed(7)
    lat = torch.randn(2, 4, 3, 16, 32, generator=g, device=cuda)
    ctx = torch.randn(2, 8, 64, generator=g, device=cuda)
    t = torch.tensor([100, 200], device=cuda)
    with torch.no_grad():
        assert _rel(wan(lat, t, ctx), plain(lat, t, ctx)) <= 2.0 ** -7


def _interp_models(T=21):
    """Seeded interpolators and selector at small widths, each with an input
    maker: (name, model, inputs(device)) for the card-vs-CPU forwards."""
    from interpolated_diffusion_tpu_torch.models.flow_interpolator import LatentFlowInterpolator
    from interpolated_diffusion_tpu_torch.models.init import build_model
    from interpolated_diffusion_tpu_torch.models.sinkhorn_warp import SinkhornWarpInterpolator
    from interpolated_diffusion_tpu_torch.models.straightener import (
        LatentStraightener, LatentStraightenerTokenTransformer)
    from interpolated_diffusion_tpu_torch.models.video_selector import VideoKeyframeSelector

    g = torch.Generator().manual_seed(8)
    lat = torch.randn(2, T, 16, 60, 104, generator=g)
    idx = torch.tensor([[0, 5, 10, 15, 20], [0, 3, 9, 14, 20]])
    text = torch.randn(2, 16, 64, generator=g)
    seeded = lambda cls, **kw: build_model(cls, generator=torch.Generator().manual_seed(9),
                                           zero_init_scale=0.05, **kw).eval()
    return [
        ("flow", seeded(LatentFlowInterpolator, in_channels=16, time_mask=True, gap_cond=True,
                        use_cost_volume=True), lambda d: (lat.to(d), idx.to(d))),
        ("straightener", seeded(LatentStraightener, in_channels=16),
         lambda d: (lat[:, 0].to(d),)),
        ("straightener_token", seeded(LatentStraightenerTokenTransformer, in_channels=16,
                                      d_model=64, n_layers=2, n_heads=4, d_ff=128),
         lambda d: (lat[:, 0].to(d),)),
        ("sinkhorn", seeded(SinkhornWarpInterpolator, in_channels=16, learn_tau=True,
                            learn_dustbin=True, fb_sigma=2.0, global_mode="none"),
         lambda d: (lat.to(d), idx.to(d))),
        ("video_selector", seeded(VideoKeyframeSelector, T=T, text_dim=64, d_model=64,
                                  d_cond=32, n_layers=2, n_heads=4, d_ff=128),
         lambda d: ({"text_embed": text.to(d)},)),
    ]


@pytest.mark.gpu
def test_interpolators_on_the_card_match_the_cpu(cuda):
    """The video interpolators and the selector have no kernel of their own:
    their f32 forward on the card (cuDNN convolutions, grid_sample, FFTs,
    TF32 off) equals the CPU forward of the same weights and inputs within
    1e-4 of the output's scale, at the Wan latent size 16 x 60 x 104. The
    Sinkhorn output is held where its confidence is at least 1e-2: below it
    the blend divides rounding noise, and f32 does not determine the output
    (chip_smoke.py's phase 5g gate)."""
    torch.backends.cudnn.allow_tf32 = False
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    for name, model, inputs in _interp_models():
        with torch.no_grad():
            ref = as_tuple(model(*inputs(torch.device("cpu"))))
            got = as_tuple(model.to(cuda)(*inputs(cuda)))
        for k, (a, b) in enumerate(zip(got, ref)):
            d = (a.cpu() - b).abs()
            if name == "sinkhorn" and k == 0:
                d = d * (ref[1] >= 1e-2)[:, :, None]
            assert float(d.max()) <= 1e-4 * float(b.abs().max()), (name, k, _rel(a.cpu(), b))


@pytest.mark.gpu
def test_full_finetune_step_on_the_card(cuda):
    """--lora_rank 0 --bf16 1 at head dim 128 under sla: every WanDiT weight
    an f32 master, the SLA and flash kernels launched, every weight moved."""
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
    from interpolated_diffusion_tpu_torch.train.state import tree_leaves

    args = p1.build_argparser().parse_args(
        ["--T", "9", "--latent_c", "4", "--latent_h", "32", "--latent_w", "64",
         "--text_len", "8", "--text_dim", "64", "--wan_dim", "256", "--wan_layers", "2",
         "--wan_heads", "2", "--wan_ffn", "512", "--lora_rank", "0", "--K", "5",
         "--sla_block", "64", "--sla_topk", "0.5", "--attn_mode", "sla", "--device", "cuda"])
    state, base, step, wan, fc = p1.make_trainer(args, cuda)
    assert base is None and all(p.dtype == torch.float32 for p in tree_leaves(state.params))
    g = torch.Generator(cuda).manual_seed(10)
    batch = {"latents": torch.randn(2, 9, 4, 32, 64, generator=g, device=cuda),
             "text_embed": torch.randn(2, 8, 64, generator=g, device=cuda)}
    before = [p.detach().clone() for p in tree_leaves(state.params)]
    launches = bsa.block_sparse_attention.launches
    state, metrics = step(state, base, batch, g)
    assert bsa.block_sparse_attention.launches > launches
    assert np.isfinite(float(metrics["loss"]))
    moved = sum(not torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))
    assert moved == len(before)
