"""kernels/ln_modulate on the CPU: the plain twin against the expressions it
replaced at its call sites, forward and gradients bit for bit, in bf16 and in
f32 — adaLN `LayerNorm(x) * (1 + scale) + shift` with the modulation as bf16
rows or as strided f32 rows of WanBlock's `mod`, and the affine
`LayerNorm(D)(x)`; WanBlock, WanDiT and both HunyuanVideo block types, whose
CPU path runs the twin, against the same models on those expressions; and the
input contract the CUDA kernels enforce (`_check`, which needs no card). The
kernels themselves are held to the twin on the card
(tests/test_torch_ln_modulate_gpu.py)."""
import types

import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import ln_modulate as lnm
from interpolated_diffusion_tpu_torch.models import hunyuan_video, wan_dit
from interpolated_diffusion_tpu_torch.models.transformer import LayerNorm

B, L, D = 2, 13, 64
X_DTYPES = [torch.bfloat16, torch.float32]
# how the modulation arrives: bf16 [B, D] rows (HunyuanVideo's Linear
# chunks, strided), or the f32 rows of a [B, 6, D] `mod` (WanBlock's)
MOD_LAYOUTS = ["bf16_chunks", "f32_mod_rows"]


def _x(x_dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, L, D, generator=g) * 2.0 + 0.5).to(x_dtype)


def _mod(layout, seed=1):
    """(scale, shift) [B, D] as the call sites hand them."""
    g = torch.Generator().manual_seed(seed)
    if layout == "f32_mod_rows":
        mod = 0.3 * torch.randn(B, 6, D, generator=g)
        return mod[:, 1], mod[:, 0]
    out = (0.3 * torch.randn(B, 6 * D, generator=g)).to(torch.bfloat16)
    shift, scale = out.chunk(6, dim=-1)[:2]
    return scale, shift


def _affine(w_dtype, seed=2):
    g = torch.Generator().manual_seed(seed)
    return ((1 + 0.3 * torch.randn(D, generator=g)).to(w_dtype),
            (0.2 * torch.randn(D, generator=g)).to(w_dtype))


def _old(x, scale, shift, *, form, eps=1e-6):
    """The expressions the call sites computed before the kernel pair:
    LayerNorm modules, then `* (1 + scale) + shift` with the rows cast to
    x's dtype (WanBlock's `mod[:, i][:, None, :].to(dtype)`; HunyuanVideo's
    rows already are in it)."""
    if form == "affine":
        return LayerNorm.forward(types.SimpleNamespace(eps=eps, weight=scale, bias=shift), x)
    norm = LayerNorm(x.shape[-1], eps, affine=False)
    return norm(x) * (1 + scale[:, None, :].to(x.dtype)) + shift[:, None, :].to(x.dtype)


def _cases():
    for layout in MOD_LAYOUTS:
        yield "adaln", layout
    for w_dtype in ("bf16", "f32"):
        yield "affine", w_dtype


CASES = list(_cases())


def _inputs(form, how, x_dtype):
    x = _x(x_dtype)
    if form == "affine":
        return (x, *_affine(torch.bfloat16 if how == "bf16" else torch.float32))
    return (x, *_mod(how))


@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("form,how", CASES, ids=[f"{f}-{h}" for f, h in CASES])
def test_twin_equals_the_old_expression(form, how, x_dtype):
    x, scale, shift = _inputs(form, how, x_dtype)
    want = _old(x, scale, shift, form=form)
    for fn in (lnm.ln_modulate, lnm.ln_modulate_twin):
        got = fn(x, scale, shift, form=form)
        assert got.dtype == x_dtype and got.shape == x.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("form,how", CASES, ids=[f"{f}-{h}" for f, h in CASES])
def test_twin_gradients_equal_the_old_expression(form, how, x_dtype):
    """dx, and the modulation's gradients (full fine-tuning: the f32 `mod`,
    the bf16 chunks, the norm's weight and bias), bit for bit."""
    x, scale, shift = _inputs(form, how, x_dtype)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(x_dtype)
    grads = []
    for fn in (_old, lnm.ln_modulate):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, shift)]
        grads.append(torch.autograd.grad(fn(*leaves, form=form), leaves, cot))
    for want, got, t in zip(*grads, (x, scale, shift)):
        assert got.dtype == t.dtype and torch.equal(got, want)
        assert bool(got.abs().max() > 0)


def test_layer_norm_is_layernorm_forward():
    """`layer_norm`, the twin's statistics, is models/transformer.LayerNorm's
    arithmetic, with and without its affine parameters."""
    for x_dtype in X_DTYPES:
        x = _x(x_dtype, seed=4)
        assert torch.equal(lnm.layer_norm(x, 1e-6), LayerNorm(D, affine=False)(x))
        norm = LayerNorm(D)
        with torch.no_grad():
            norm.weight.copy_(_affine(torch.float32)[0])
            norm.bias.copy_(_affine(torch.float32)[1])
        assert torch.equal(lnm.layer_norm(x, 1e-6, norm.weight, norm.bias), norm(x))


def _seeded(module, seed):
    """Every parameter drawn (norm weights near 1), so that each one acts."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=g) * 0.1
            p.copy_(1 + noise if name.endswith("norm2.weight") else noise)
    return module


@pytest.mark.parametrize("dtype", X_DTYPES, ids=["bf16", "f32"])
def test_wan_block_and_dit_cpu_path_are_the_old_expressions(dtype, monkeypatch):
    """WanDiT (2 blocks, its head) on CPU tensors: output and every
    parameter's gradient equal the same model's on the old expressions."""
    model = _seeded(wan_dit.WanDiT(dim=D, n_layers=2, n_heads=2, ffn_dim=128, in_channels=4,
                                   out_channels=4, text_dim=32, lora_rank=2), 5).to(dtype)
    g = torch.Generator().manual_seed(6)
    latents = torch.randn(B, 4, 2, 8, 8, generator=g)
    t = torch.tensor([17, 803])
    ctx = torch.randn(B, 7, 32, generator=g)
    leaves = [p for p in model.parameters()]
    results = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(wan_dit, "ln_modulate", _old)
        out = model(latents, t, ctx)
        results.append((out, torch.autograd.grad(out.square().sum(), leaves)))
    (out, grads), (want, want_grads) = results
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    block = model.blocks[0]   # and the block alone, on its own inputs
    x = torch.randn(B, 32, D, generator=g).to(dtype)
    t_mod = torch.randn(B, 6, D, generator=g).to(dtype)
    rope = wan_dit.build_rope_freqs(*wan_dit.wan_rope_tables(64, D // 2), 2, 4, 4)
    monkeypatch.setattr(wan_dit, "ln_modulate", lnm.ln_modulate)
    got = block(x, model.condition_embedder.text_embedder(ctx), t_mod, rope)
    monkeypatch.setattr(wan_dit, "ln_modulate", _old)
    assert torch.equal(got, block(x, model.condition_embedder.text_embedder(ctx), t_mod, rope))


@pytest.mark.parametrize("dtype", X_DTYPES, ids=["bf16", "f32"])
def test_hunyuan_blocks_cpu_path_are_the_old_expressions(dtype, monkeypatch):
    """HunyuanVideo with one dual- and one single-stream block and its head
    (dim 256, 2 heads of 128) on CPU tensors: output and every parameter's
    gradient equal the same model's on the old `_mod` expression."""
    model = hunyuan_video.HunyuanVideoTransformer3DModel(
        in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=128,
        num_layers=1, num_single_layers=1, num_refiner_layers=1, text_embed_dim=64,
        pooled_projection_dim=32, lora_rank=2)
    model = _seeded(model, 7).to(dtype)
    g = torch.Generator().manual_seed(8)
    latents = torch.randn(B, 4, 2, 8, 8, generator=g)
    text = torch.randn(B, 6, 64, generator=g)
    mask = (torch.arange(6)[None] < torch.tensor([3, 6])[:, None]).int()
    pooled = torch.randn(B, 32, generator=g)
    leaves = [p for p in model.parameters()]
    results = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(hunyuan_video, "ln_modulate", _old)
        out = model(latents, torch.tensor([17, 803]), text, text_mask=mask, pooled=pooled)
        results.append((out, torch.autograd.grad(out.square().sum(), leaves)))
    (out, grads), (want, want_grads) = results
    assert torch.isfinite(out).all() and torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_unknown_form_raises_on_every_device():
    x, scale, shift = _inputs("adaln", "f32_mod_rows", torch.float32)
    with pytest.raises(ValueError, match="form"):
        lnm.ln_modulate(x, scale, shift, form="rms")
    with pytest.raises(ValueError, match="form"):
        lnm._check(x, scale, shift, "rms")


def _misaligned(shape, dtype=torch.bfloat16):
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 8, dtype=dtype)[1:1 + n].view(shape)   # one element off


def _good_adaln():
    return _x(torch.bfloat16), *_mod("f32_mod_rows")


REFUSED = {
    "x_f16": lambda: (_x(torch.float32).half(), *_mod("bf16_chunks"), "adaln"),
    "x_2d": lambda: (_x(torch.bfloat16)[0], *_mod("bf16_chunks"), "adaln"),
    "d_not_multiple_of_8": lambda: (torch.zeros(B, L, 60, dtype=torch.bfloat16),
                                    torch.zeros(B, 60), torch.zeros(B, 60), "adaln"),
    "d_over_8192": lambda: (torch.zeros(1, 1, 8200, dtype=torch.bfloat16),
                            torch.zeros(1, 8200), torch.zeros(1, 8200), "adaln"),
    "x_rows_strided": lambda: (torch.zeros(B, D, L, dtype=torch.bfloat16).transpose(1, 2),
                               *_mod("bf16_chunks"), "adaln"),
    "x_misaligned": lambda: (_misaligned((B, L, D)), *_mod("bf16_chunks"), "adaln"),
    "x_batch_stride_misaligned": lambda: (torch.zeros(B, L * D + 1, dtype=torch.bfloat16)
                                          [:, :L * D].view(B, L, D), *_mod("bf16_chunks"),
                                          "adaln"),
    "scale_shape": lambda: (_x(torch.bfloat16), torch.zeros(B, 1, D), torch.zeros(B, D),
                            "adaln"),
    "scale_f64": lambda: (_x(torch.bfloat16), torch.zeros(B, D, dtype=torch.float64),
                          torch.zeros(B, D, dtype=torch.float64), "adaln"),
    "scale_shift_dtypes_differ": lambda: (_x(torch.bfloat16), torch.zeros(B, D),
                                          torch.zeros(B, D, dtype=torch.bfloat16), "adaln"),
    "scale_columns_strided": lambda: (_x(torch.bfloat16), torch.zeros(D, B).t(),
                                      torch.zeros(B, D), "adaln"),
    "scale_misaligned": lambda: (_x(torch.bfloat16), _misaligned((B, D), torch.float32),
                                 torch.zeros(B, D), "adaln"),
    "affine_weight_per_row": lambda: (_x(torch.bfloat16), torch.ones(B, D), torch.zeros(B, D),
                                      "affine"),
    "adaln_rows_as_a_weight": lambda: (_x(torch.bfloat16), torch.ones(D), torch.zeros(D),
                                       "adaln"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_refuses_what_the_kernels_do_not_take(case):
    lnm._check(*_good_adaln(), "adaln")   # the well-formed inputs pass
    with pytest.raises(ValueError):
        lnm._check(*REFUSED[case]())


def test_check_takes_what_the_call_sites_hand():
    """WanBlock's f32 `mod` rows (batch stride 6 D), HunyuanVideo's bf16
    chunks and its video and text slices of the joint x, the affine norm's
    bf16 or f32 weight, an f32 model's x."""
    full = torch.zeros(B, L + 5, D, dtype=torch.bfloat16)
    lnm._check(full[:, :L], *_mod("bf16_chunks"), "adaln")
    lnm._check(full[:, L:], *_mod("bf16_chunks"), "adaln")
    lnm._check(_x(torch.float32), *_mod("f32_mod_rows"), "adaln")
    for w_dtype in (torch.bfloat16, torch.float32):
        lnm._check(_x(torch.bfloat16), *_affine(w_dtype), "affine")
