"""kernels/qk_norm_rope on the CPU: the plain twin against WanDiT's chain
(RMSNorm, then apply_rope on the head split), forward and gradients bit for
bit, in bf16 and in f32; WanAttention's CPU path, which runs the twin; and the input
contract the CUDA kernels enforce (`_check`, which needs no card). The
kernels themselves are held to the twin on the card
(tests/test_torch_qk_norm_rope_gpu.py)."""
import math

import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import qk_norm_rope as qknr
from interpolated_diffusion_tpu_torch.models import wan_dit
from interpolated_diffusion_tpu_torch.models.transformer import dense_attention

B, L, H, DH = 2, 15, 4, 16
D = H * DH


def _rope(frames: bool):
    """Wan's RoPE tables for a 3 x 5 token grid: frame-indexed [B, L, Dh/2]
    (absolute-time frames, per sample) or shared [1, L, Dh/2]."""
    tables, dims = wan_dit.wan_rope_tables(64, DH)
    fi = torch.tensor([[0, 7, 19], [2, 3, 40]]) if frames else None
    return wan_dit.build_rope_freqs(tables, dims, 3, 1, 5, fi)


def _inputs(w_dtype, seed=0, x_dtype=torch.bfloat16):
    """x and a norm computing in x's dtype: under bf16 compute (as the
    trainers' default, an f32 master weight cast per call) or in f32 (a
    model run with --bf16 0: no compute dtype, f32 weights)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, D, generator=g).mul(3.0).to(x_dtype)
    norm = wan_dit.RMSNorm(D)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(D, generator=g))
    norm.weight.data = norm.weight.data.to(w_dtype)
    norm.compute_dtype = torch.bfloat16 if x_dtype == torch.bfloat16 else None
    return x, norm


def _chain(x, norm, rope):
    """WanAttention's q before the kernel route: RMSNorm, head split, RoPE."""
    y = norm(x)
    if rope is None:
        return y
    return wan_dit.apply_rope(y.reshape(B, L, H, DH).transpose(1, 2), *rope)


SITES = [("self_frames", True), ("self_shared", False), ("cross", None)]


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32], ids=["w_bf16", "w_f32"])
@pytest.mark.parametrize("site,frames", SITES, ids=[s for s, _ in SITES])
def test_twin_equals_the_chain(site, frames, w_dtype):
    x, norm = _inputs(w_dtype)
    rope = None if frames is None else _rope(frames)
    cs = rope if rope is not None else (None, None)
    want = _chain(x, norm, rope)
    for fn in (qknr.qk_norm_rope, qknr.qk_norm_rope_twin):
        got = fn(x, norm.weight, *cs, n_heads=H, eps=norm.eps)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.equal(got, want)
    if rope is not None:   # the layout the kernel writes: head-major, contiguous
        assert got.is_contiguous() and got.shape == (B, H, L, DH)


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32], ids=["w_bf16", "w_f32"])
@pytest.mark.parametrize("site,frames", SITES, ids=[s for s, _ in SITES])
def test_twin_gradients_equal_the_chain(site, frames, w_dtype):
    x, norm = _inputs(w_dtype, seed=1)
    rope = None if frames is None else _rope(frames)
    cs = rope if rope is not None else (None, None)
    g = torch.Generator().manual_seed(2)
    cot = torch.randn(_chain(x, norm, rope).shape, generator=g).to(torch.bfloat16)
    grads = []
    for use_chain in (True, False):
        xl = x.clone().requires_grad_(True)
        w = norm.weight
        w.grad = None
        out = (_chain(xl, norm, rope) if use_chain
               else qknr.qk_norm_rope(xl, w, *cs, n_heads=H, eps=norm.eps))
        dx, dw = torch.autograd.grad(out, [xl, w], cot)
        grads.append((dx, dw))
    (dx_c, dw_c), (dx_t, dw_t) = grads
    assert dx_t.dtype == torch.bfloat16 and dw_t.dtype == w_dtype
    assert torch.equal(dx_t, dx_c) and torch.equal(dw_t, dw_c)
    assert bool(dx_t.abs().max() > 0) and bool(dw_t.abs().max() > 0)


def test_twin_in_f32_equals_the_chain():
    """An f32 model (no compute dtype, f32 weights): the twin, which rounds
    to x's dtype, is the chain bit for bit, forward and gradients, at every
    site."""
    for site, frames in SITES:
        x, norm = _inputs(torch.float32, seed=5, x_dtype=torch.float32)
        rope = None if frames is None else _rope(frames)
        cs = rope if rope is not None else (None, None)
        cot = torch.randn(_chain(x, norm, rope).shape, generator=torch.Generator().manual_seed(6))
        outs = []
        for use_chain in (True, False):
            xl = x.clone().requires_grad_(True)
            out = (_chain(xl, norm, rope) if use_chain
                   else qknr.qk_norm_rope(xl, norm.weight, *cs, n_heads=H, eps=norm.eps))
            outs.append((out, *torch.autograd.grad(out, [xl, norm.weight], cot)))
        for want, got in zip(*outs):
            assert got.dtype == torch.float32, site
            assert torch.equal(got, want), site


def test_rms_norm_is_rmsnorm_forward():
    """RMSNorm.forward (without tensor parallelism) is rms_norm in the norm's
    compute dtype, the function whose rounding points the kernels copy."""
    for x_dtype, w_dtype in ((torch.bfloat16, torch.float32), (torch.float32, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
        x, norm = _inputs(w_dtype, seed=7, x_dtype=x_dtype)
        dtype = norm.compute_dtype or norm.weight.dtype
        assert torch.equal(norm(x), qknr.rms_norm(x, norm.weight, norm.eps, dtype))


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_wan_attention_cpu_path_is_the_chain(cross, monkeypatch):
    """On CPU tensors WanAttention goes through qk_norm_rope, whose twin runs
    there, and gives what its chain gives: norms, RoPE, dense attention,
    output projection."""
    torch.manual_seed(3)
    attn = wan_dit.WanAttention(D, H, lora_rank=2).to(torch.bfloat16).eval()
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_(0.0, 0.2)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(B, L, D, generator=g).to(torch.bfloat16)
    ctx = torch.randn(B, 7, D, generator=g).to(torch.bfloat16) if cross else None
    rope = None if cross else _rope(True)

    calls = []

    def counting(*a, **kw):
        calls.append(a[0].device.type)
        return qknr.qk_norm_rope(*a, **kw)

    monkeypatch.setattr(wan_dit, "qk_norm_rope", counting)
    with torch.no_grad():
        out = attn(x, context=ctx, rope=rope)
        kv = x if ctx is None else ctx
        q = attn.norm_q(attn.to_q(x)).reshape(B, L, H, DH).transpose(1, 2)
        k = attn.norm_k(attn.to_k(kv)).reshape(B, kv.shape[1], H, DH).transpose(1, 2)
        if rope is not None:
            q, k = wan_dit.apply_rope(q, *rope), wan_dit.apply_rope(k, *rope)
        v = attn.to_v(kv)
        packed = lambda t: t.transpose(1, 2).reshape(B, t.shape[2], D)
        want = attn.to_out[0](dense_attention(packed(q), packed(k), v, H))
    assert torch.equal(out, want) and calls == ["cpu", "cpu"]


def _misaligned(shape):
    n = math.prod(shape)
    return torch.zeros(n + 8, dtype=torch.bfloat16)[1:1 + n].view(shape)   # 2 bytes off


def _good():
    cos, sin = _rope(True)
    return (torch.zeros(B, L, D, dtype=torch.bfloat16), torch.ones(D), cos, sin, H)


REFUSED = {
    "dh_not_multiple_of_8": lambda x, w, c, s, h: (torch.zeros(B, L, 40, dtype=torch.bfloat16),
                                                   torch.ones(40), None, None, 4),
    "x_f16": lambda x, w, c, s, h: (x.half(), w, c, s, h),
    "x_2d": lambda x, w, c, s, h: (x[0], w, c, s, h),
    "dh_odd": lambda x, w, c, s, h: (torch.zeros(B, L, 72, dtype=torch.bfloat16),
                                     torch.ones(72), None, None, 8),
    "dh_over_256": lambda x, w, c, s, h: (torch.zeros(B, L, 1040, dtype=torch.bfloat16),
                                          torch.ones(1040), None, None, 4),
    "heads_do_not_divide": lambda x, w, c, s, h: (x, w, None, None, 5),
    "d_not_16_byte_rows": lambda x, w, c, s, h: (torch.zeros(B, L, 12, dtype=torch.bfloat16),
                                                 torch.ones(12), None, None, 2),
    "x_misaligned": lambda x, w, c, s, h: (_misaligned((B, L, D)), w, c, s, h),
    "x_strided": lambda x, w, c, s, h: (torch.zeros(B, D, L, dtype=torch.bfloat16)
                                        .transpose(1, 2), w, c, s, h),
    "w_shape": lambda x, w, c, s, h: (x, torch.ones(D + 8), c, s, h),
    "w_f16": lambda x, w, c, s, h: (x, w.half(), c, s, h),
    "cos_f64": lambda x, w, c, s, h: (x, w, c.double(), s.double(), h),
    "cos_bf16": lambda x, w, c, s, h: (x, w, c.to(torch.bfloat16), s.to(torch.bfloat16), h),
    "cos_wrong_len": lambda x, w, c, s, h: (x, w, c[:, :-1], s[:, :-1], h),
    "cos_without_sin": lambda x, w, c, s, h: (x, w, c, None, h),
    "cos_strided": lambda x, w, c, s, h: (x, w, c.transpose(0, 1).contiguous()
                                          .transpose(0, 1), s, h),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_refuses_what_the_kernels_do_not_take(case):
    qknr._check(*_good())   # the well-formed inputs pass
    with pytest.raises(ValueError, match="qk_norm_rope"):
        qknr._check(*REFUSED[case](*_good()))


def test_check_takes_shared_tables_bf16_weights_and_no_rope():
    x, w, cos, sin, h = _good()
    qknr._check(x, w.to(torch.bfloat16), cos[:1].contiguous(), sin[:1].contiguous(), h)
    qknr._check(x, w, None, None, h)
    qknr._check(x.float(), w, cos, sin, h)   # an f32 model's q / k
