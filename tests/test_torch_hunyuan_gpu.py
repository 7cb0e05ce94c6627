"""The kernel modes HunyuanVideo's joint attention added, on the card.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
mode). This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_hunyuan_gpu.py -q -s

- The flash kernels (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu) with a
  key length per (batch, head) row, forward and both backward kernels,
  against the twin with the same lengths (o, lse, dq, dk, dv), and the rows
  of keys past a length exactly zero. Lengths equal to Lk give the scalar
  path's results bit for bit, so Wan's calls (no lengths) are unchanged.
- qk_norm_rope (csrc/qk_norm_rope.cu) in its per-head form ([Dh] weight)
  with RoPE on the first rope_rows tokens, against its twin: forward within
  two bf16 ulps of the pair's magnitude (f32: 64 f32 ulps), backward dx
  within twice the twin's distance of an f64 chain, and a training [Dh]
  weight's dw folded over the heads as the twin's autograd gives it.
"""
import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
from interpolated_diffusion_tpu_torch.kernels import qk_norm_rope as qknr

BWD_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _qkv(bh, Lq, Lk, d, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((bh, Lq, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((bh, Lk, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((bh, Lq, d), generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, do


# (Lq = Lk, d, lengths): one key, a tile edge, one past it, a length inside
# the last 64-key tile of dQ's walk and of dK/dV's 128-key blocks, the whole
# sequence; and HunyuanVideo's joint sequence (10,200 video + 261 text rows,
# valid text 29 .. 165)
CASES = [(300, 64, [1, 64, 65, 129, 200, 300]),
         (1000, 128, [1, 127, 128, 129, 511, 1000]),
         (10461, 128, [10229, 10365, 10461, 10300])]


@pytest.mark.gpu
@pytest.mark.parametrize("L,d,lens", CASES, ids=["L300", "L1000", "hy_joint"])
def test_flash_with_key_lengths_matches_twin(cuda, L, d, lens):
    q, k, v, do = _qkv(len(lens), L, L, d, cuda, L + d)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (bsa.flash_attention.launches, bsa.flash_bwd_dq.launches,
              bsa.flash_bwd_dkdv.launches)
    with torch.inference_mode():
        o, lse = bsa.flash_attention_fwd(q, k, v, kv_lens=kv)
        ro, rlse = bsa._torch_flash(q, k, v, d ** -0.5, 1024, kv)
        got = bsa.flash_attention_bwd(q, k, v, o, lse, do, kv_lens=kv)
        ref = bsa.flash_attention_bwd(q, k, v, o, lse, do, twin=True, kv_lens=kv)
    torch.cuda.synchronize()
    assert (bsa.flash_attention.launches, bsa.flash_bwd_dq.launches,
            bsa.flash_bwd_dkdv.launches) == tuple(b + 1 for b in before)
    print(f"[flash kv_lens] L {L} d {d}: o {_rel(o, ro):.2e}, lse {_rel(lse, rlse):.2e}, "
          + ", ".join(f"{n} {_rel(a, b):.2e}" for n, a, b in zip(("dq", "dk", "dv"), got, ref)))
    assert _rel(o, ro) <= 1e-2 and _rel(lse, rlse) <= 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= BWD_TOL, (name, _rel(a, b))
    past = torch.arange(L, device=cuda)[None, :] >= kv[:, None]
    for name, t in zip(("dk", "dv"), got[1:]):
        assert float(t[past].float().abs().max()) == 0.0, name


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lk,d", [(1000, 517, 128), (7800, 517, 128), (300, 133, 64)])
def test_full_key_lengths_are_the_scalar_path_bitwise(cuda, Lq, Lk, d):
    q, k, v, do = _qkv(6, Lq, Lk, d, cuda, 9)
    kv = torch.full((6,), Lk, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        a = bsa.flash_attention_fwd(q, k, v)
        b = bsa.flash_attention_fwd(q, k, v, kv_lens=kv)
        ga = bsa.flash_attention_bwd(q, k, v, a[0], a[1], do)
        gb = bsa.flash_attention_bwd(q, k, v, a[0], a[1], do, kv_lens=kv)
    torch.cuda.synchronize()
    for x, y in zip((*a, *ga), (*b, *gb)):
        assert torch.equal(x, y)


def _ulps(a, b, mantissa=7):
    a, b = a.float(), b.float()
    m = torch.sqrt(b[..., 0::2] ** 2 + b[..., 1::2] ** 2).repeat_interleave(2, dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp_min(2.0 ** -120))) - mantissa)
    return (a - b).abs() / ulp


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,rope_rows", [(1, 10461, 24, 10200), (2, 300, 24, 300),
                                             (1, 261, 24, None)],
                         ids=["single_joint", "dual_video", "dual_text"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["x_bf16", "x_f32"])
def test_qk_norm_per_head_matches_twin(cuda, B, L, H, rope_rows, x_dtype):
    Dh = 128
    g = torch.Generator(device=cuda).manual_seed(L + H)
    x = (torch.randn(B, L, H * Dh, generator=g, device=cuda) * 3.0).to(x_dtype)
    w = (1 + 0.3 * torch.randn(Dh, generator=g, device=cuda)).to(torch.bfloat16)
    cos = sin = None
    if rope_rows is not None:
        ang = torch.rand(B, rope_rows, Dh // 2, generator=g, device=cuda) * 100
        cos, sin = torch.cos(ang), torch.sin(ang)
    before = qknr.qk_norm_rope.launches, qknr.qk_norm_rope.launches_bwd
    xa = x.clone().requires_grad_(True)
    q = qknr.qk_norm_rope(xa, w, cos, sin, n_heads=H, rope_rows=rope_rows)
    dq = torch.randn(q.shape, generator=g, device=cuda).to(x_dtype)
    (dx,) = torch.autograd.grad(q, (xa,), dq)
    xt = x.clone().requires_grad_(True)
    twin = qknr.qk_norm_rope_twin(xt, w, cos, sin, n_heads=H, rope_rows=rope_rows)
    (dxt,) = torch.autograd.grad(twin, (xt,), dq)
    torch.cuda.synchronize()
    assert (qknr.qk_norm_rope.launches, qknr.qk_norm_rope.launches_bwd) == (before[0] + 1,
                                                                           before[1] + 1)
    assert q.shape == twin.shape and q.dtype == x_dtype
    # f64 chain for the backward: per-head RMS, weight, the rotation of the first rows
    x64 = x.double().requires_grad_(True)
    xh = x64.reshape(B, L, H, Dh)
    y = (xh * torch.rsqrt(xh.square().mean(-1, keepdim=True) + 1e-6) * w.double()).transpose(1, 2)
    if rope_rows is not None:
        n = rope_rows
        y1, y2 = y[:, :, :n, 0::2], y[:, :, :n, 1::2]
        c, s = cos.double()[:, None], sin.double()[:, None]
        rot = torch.stack([y1 * c - y2 * s, y1 * s + y2 * c], dim=-1).reshape(y[:, :, :n].shape)
        y = torch.cat([rot, y[:, :, n:]], dim=2)
    else:
        y = y.transpose(1, 2).reshape(B, L, H * Dh)
    (dx64,) = torch.autograd.grad(y, (x64,), dq.double())
    gap = lambda a: ((a.double() - dx64).norm() / dx64.norm()).item()
    mant = 7 if x_dtype == torch.bfloat16 else 23
    u = _ulps(q if rope_rows is not None else q.reshape(B, L, H, Dh),
              twin if rope_rows is not None else twin.reshape(B, L, H, Dh), mant)
    print(f"[qk_norm per head] B {B} L {L} rope_rows {rope_rows} {x_dtype}: max {u.max():.2f} "
          f"ulps, dx gap to f64 {gap(dx):.2e} (twin {gap(dxt):.2e})")
    assert u.max().item() <= (2.0 if x_dtype == torch.bfloat16 else 64.0)
    assert gap(dx) <= max(2 * gap(dxt), 1e-6)


@pytest.mark.gpu
def test_per_head_weight_gradient(cuda):
    """dw of a per-head weight that trains (full fine-tuning): the wrapper
    folds the heads' partial sums, against the twin's autograd in f32."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, L, H, Dh = 2, 333, 4, 128
    x = torch.randn(B, L, H * Dh, generator=g, device=cuda)
    w = (1 + 0.3 * torch.randn(Dh, generator=g, device=cuda)).requires_grad_(True)
    dq = torch.randn(B, L, H * Dh, generator=g, device=cuda)
    (dw,) = torch.autograd.grad(qknr.qk_norm_rope(x, w, n_heads=H), (w,), dq)
    (dwt,) = torch.autograd.grad(qknr.qk_norm_rope_twin(x, w, n_heads=H), (w,), dq)
    assert _rel(dw, dwt) <= 1e-5
