"""The LayerNorm + modulation kernels (csrc/ln_modulate.cu) on the card.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
mode). This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_ln_modulate_gpu.py -q -s

At the training shapes (Wan Phase 2 and Phase 1, HunyuanVideo's video rows and
a strided slice of its text rows), in both forms and in bf16 (the trainers'
default) and f32 (a model run with --bf16 0). Forward: the kernel rounds where
the twin (layer_norm, then the modulation) rounds, so for the kernel's own
per-row mean and rstd the twin's arithmetic gives its output bit for bit; the
statistics differ from the twin's only by the order of the sums, and the
outputs by one ulp of the element's largest term (affine) or three (adaLN,
where (1 + scale) carries a flip of n by one ulp). Backward: dx and the
modulation's gradients against an f64 evaluation of the same function, no
farther from it than the twin's autograd (in f32, where neither rounds to a
coarser grid, within twice its gap). Then the models on the kernel route:
the launches of a Wan Phase-1 step and of a 2-block HunyuanVideo step, and a
2-block Wan model's loss and LoRA gradients against the same model on the
twin.
"""
import statistics

import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import ln_modulate as lnm
from interpolated_diffusion_tpu_torch.models import hunyuan_video, wan_dit

# (name, B, L, D, how x is laid out): Wan Phase 2 and Phase 1 (a residual
# stream of its own), HunyuanVideo's video rows, and its text rows as the
# dual block reads them: a slice [:, 10200:] of a 2-row joint sequence
CASES = [("wan_p2", 2, 32760, 1536, "whole"), ("wan_p1", 2, 7800, 1536, "whole"),
         ("hy_video", 1, 10200, 3072, "whole"), ("hy_text_slice", 2, 261, 3072, "slice")]
FORMS = ["adaln", "affine"]
X_DTYPES = [torch.bfloat16, torch.float32]
MANTISSA = {torch.bfloat16: 7, torch.float32: 23}
HY_SLICE_AT = 10200


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(B, L, D, layout, form, dev, x_dtype, seed=0):
    """x (a slice of a longer sequence for "slice"), and scale / shift: adaLN
    as the f32 rows 1 and 0 of a [B, 6, D] `mod` (WanBlock's) for the Wan
    cases, bf16 chunks of a [B, 6 D] Linear output (HunyuanVideo's) for the
    others; affine an f32 weight and bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = L + HY_SLICE_AT if layout == "slice" else L
    full = (torch.randn(B, rows, D, generator=g, device=dev) * 2.0 + 0.5).to(x_dtype)
    x = full[:, HY_SLICE_AT:] if layout == "slice" else full
    if form == "affine":
        return (x, 1 + 0.3 * torch.randn(D, generator=g, device=dev),
                0.2 * torch.randn(D, generator=g, device=dev))
    if D == 1536:
        mod = 0.3 * torch.randn(B, 6, D, generator=g, device=dev)
        return x, mod[:, 1], mod[:, 0]
    out = (0.3 * torch.randn(B, 6 * D, generator=g, device=dev)).to(x_dtype)
    shift, scale = out.chunk(6, dim=-1)[:2]
    return x, scale, shift


def _from_stats(x, scale, shift, form, mean, rstd):
    """The twin's arithmetic after the statistics, on given mean and rstd [B*L]."""
    B, L, D = x.shape
    xf, mu, r = x.float(), mean.reshape(B, L, 1), rstd.reshape(B, L, 1)
    if form == "affine":
        return ((xf - mu) * (r * scale.float()) + shift.float()).to(x.dtype)
    n = ((xf - mu) * r).to(x.dtype)
    return n * (1 + scale.to(x.dtype)[:, None]) + shift.to(x.dtype)[:, None]


def _ulps(a, b, scale_of, mantissa):
    """|a - b| in ulps (of a `mantissa`-bit format) of `scale_of`'s magnitude."""
    m = scale_of.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp_min(2.0 ** -120))) - mantissa)
    return (a.float() - b.float()).abs() / ulp


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,B,L,D,layout", CASES, ids=[c[0] for c in CASES])
def test_forward_against_the_twin(cuda, name, B, L, D, layout, form, x_dtype):
    x, scale, shift = _inputs(B, L, D, layout, form, cuda, x_dtype)
    before = lnm.ln_modulate.launches
    y, mean, rstd = lnm._forward(x, scale, shift, form, 1e-6)
    assert lnm.ln_modulate.launches == before + 1
    twin = lnm.ln_modulate_twin(x, scale, shift, form=form)
    assert y.shape == twin.shape and y.is_contiguous() and y.dtype == x_dtype
    # the statistics: f32 sums of D elements in two orders, a few f32 ulps apart
    xf = x.float()
    mu = xf.mean(dim=-1).reshape(-1)
    var = torch.clamp(xf.square().mean(dim=-1).reshape(-1) - mu * mu, min=0.0)
    mu_gap = ((mean - mu).abs() / var.sqrt()).max().item()
    rel = ((rstd - torch.rsqrt(var + 1e-6)).abs() / rstd).max().item()
    assert mu_gap <= 1e-5 and rel <= 1e-5, (mu_gap, rel)
    # for the kernel's own statistics, the twin's rounding points give its output exactly
    assert torch.equal(y, _from_stats(x, scale, shift, form, mean, rstd))
    # against the twin, in ulps of the element's largest term (the output, the
    # product before the shift, or the modulation itself, the scale of a row
    # whose n is near 0). bf16 affine: the f32 value moves by a few f32 ulps
    # and rounds once: one ulp. bf16 adaLN: n may flip by one ulp of n, which
    # (1 + scale) carries into up to two ulps of the product, rounded once more
    # with the shift: three. f32: every element moves by the statistics' gaps,
    # (rel + mu_gap) * 2^24 ulps of the row's scale, and a few roundings
    B_, L_ = x.shape[:2]
    n_hat = (xf - mu.reshape(B_, L_, 1)) * rstd.reshape(B_, L_, 1)
    a = scale.float() if form == "affine" else (1 + scale.to(x_dtype)[:, None]).float()
    big = torch.maximum(torch.maximum(twin.float().abs(), (n_hat * a).abs()), a.abs())
    u = _ulps(y, twin, big, MANTISSA[x_dtype])
    equal = (y == twin).float().mean().item()
    within1 = (u <= 1).float().mean().item()
    print(f"[ln_modulate] {name} {form} [{B},{L},{D}] {x_dtype}: bitwise-equal share {equal:.7f}, "
          f"within one ulp {within1:.7f}, max {u.max().item():.2f} ulps, mean gap {mu_gap:.2e}, "
          f"rstd gap {rel:.2e}")
    if x_dtype == torch.bfloat16:
        bound = 1.0 if form == "affine" else 3.0
    else:
        bound = 2 * (rel + mu_gap) * 2 ** 24 + 4
    assert u.max().item() <= bound


def _chain64(x, scale, shift, form):
    """The function in f64 without rounding, on the modulation values the
    paths compute with (adaLN: scale and shift rounded to x's dtype)."""
    mu = x.mean(dim=-1, keepdim=True)
    n = (x - mu) * torch.rsqrt((x - mu).square().mean(dim=-1, keepdim=True) + 1e-6)
    if form == "affine":
        return n * scale + shift
    return n * (1 + scale[:, None]) + shift[:, None]


def _gap(a, ref):
    return ((a.double() - ref).norm() / ref.norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,B,L,D,layout", CASES[1:], ids=[c[0] for c in CASES[1:]])
def test_backward_against_f64(cuda, name, B, L, D, layout, form, x_dtype):
    """dx, and the modulation's gradients (as in full fine-tuning: d_scale and
    d_shift of each batch row, or dw and db), against f64 autograd of the
    unrounded function: relative 2-norm gap of the kernel's <= the twin's in
    bf16 (1% over it where both round the same f32 sum to bf16: HunyuanVideo's
    bf16 d_shift, whose ties may round either way), <= twice the twin's in
    f32."""
    x, scale, shift = _inputs(B, L, D, layout, form, cuda, x_dtype, seed=1)
    g = torch.Generator(device=cuda).manual_seed(2)
    dy = torch.randn((B, L, D), generator=g, device=cuda).to(x_dtype)
    grads = {}
    for path, fn in (("kernel", lnm.ln_modulate), ("twin", lnm.ln_modulate_twin)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, shift)]
        before = lnm.ln_modulate.launches_bwd
        out = fn(*leaves, form=form)
        grads[path] = torch.autograd.grad(out, leaves, dy)
        assert lnm.ln_modulate.launches_bwd == before + (path == "kernel")
    cast = (lambda t: t) if form == "affine" else (lambda t: t.to(x_dtype))
    ref_in = [x.double()] + [cast(t).double() for t in (scale, shift)]
    ref_in = [t.requires_grad_(True) for t in ref_in]
    ref = torch.autograd.grad(_chain64(*ref_in, form), ref_in, dy.double())
    for i, what in enumerate(("dx", "d_scale", "d_shift")):
        k, t = _gap(grads["kernel"][i], ref[i]), _gap(grads["twin"][i], ref[i])
        print(f"[ln_modulate] {name} {form} {x_dtype} {what}: gap to f64 kernel {k:.3e}, "
              f"twin {t:.3e}")
        assert k <= (1.01 * t if x_dtype == torch.bfloat16 else 2 * t) + 1e-7, (what, k, t)
        assert grads["kernel"][i].dtype == (x, scale, shift)[i].dtype


def _p1_args(layers, extra=()):
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1

    return p1, p1.build_argparser().parse_args(
        ["--T", "9", "--latent_c", "4", "--latent_h", "32", "--latent_w", "64", "--text_len", "8",
         "--text_dim", "64", "--wan_dim", "256", "--wan_layers", str(layers), "--wan_heads",
         "2", "--wan_ffn", "512", "--K", "5", "--sla_block", "64", "--sla_topk", "0.5",
         "--device", "cuda", *extra])


@pytest.mark.gpu
def test_wan_phase1_step_launches(cuda):
    """A Phase-1 LoRA step at 30 blocks (remat): three LNs a block (norm1,
    norm2, norm3), each forward twice (once more in the recompute), and the
    head's once: 2 * 3 * 30 + 1 = 181 forward launches. Backward: every LN
    but the first block's norm1, whose input (the frozen patch embedding)
    and modulation (the frozen time projection) want no gradient: 3 * 30 -
    1 + 1 = 90."""
    p1, args = _p1_args(30)
    state, base, step, _, _ = p1.make_trainer(args, cuda)
    g = torch.Generator(cuda).manual_seed(10)
    batch = {"latents": torch.randn(2, 9, 4, 32, 64, generator=g, device=cuda),
             "text_embed": torch.randn(2, 8, 64, generator=g, device=cuda)}
    fwd, bwd = lnm.ln_modulate.launches, lnm.ln_modulate.launches_bwd
    state, metrics = step(state, base, batch, g)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert (lnm.ln_modulate.launches - fwd, lnm.ln_modulate.launches_bwd - bwd) == (181, 90)


@pytest.mark.gpu
def test_hunyuan_two_block_step_launches(cuda):
    """A HunyuanVideo Phase-1 LoRA step with one dual- and one single-stream
    block (remat, batch 2, so the dual block's video and text slices of x are
    strided): four LNs in the dual block (video and text, before attention
    and before the FFNs), one in the single block, each forward twice, and
    the head's once: 2 * (4 + 1) + 1 = 11 forward launches. Backward: every
    LN once, the first video LN too (its rows are a slice of the joint x,
    which wants a gradient for the text rows' trainable frame-condition
    tokens): 4 + 1 + 1 = 6."""
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as tk

    args = tk.build_argparser().parse_args(
        ["--dit", "hunyuan_video", "--hy_heads", "2", "--hy_double", "1", "--hy_single", "1",
         "--latent_c", "4", "--latent_h", "8", "--latent_w", "8", "--T", "9", "--K", "3",
         "--text_len", "12", "--text_dim", "64", "--pooled_dim", "32", "--text_valid_min", "2",
         "--text_valid_max", "9", "--lora_rank", "4", "--batch", "2", "--use_remat", "1",
         "--device", "cuda"])
    state, base, step, model, _ = tk.make_trainer(args, cuda)
    assert isinstance(model, hunyuan_video.HunyuanVideoTransformer3DModel)
    g = torch.Generator(cuda).manual_seed(12)
    batch = {"latents": torch.randn(2, 9, 4, 8, 8, generator=g, device=cuda),
             "text_embed": torch.randn(2, 12, 64, generator=g, device=cuda) * 0.5,
             "text_mask": (torch.arange(12, device=cuda)[None]
                           < torch.tensor([4, 11], device=cuda)[:, None]).int(),
             "pooled": torch.randn(2, 32, generator=g, device=cuda)}
    fwd, bwd = lnm.ln_modulate.launches, lnm.ln_modulate.launches_bwd
    state, metrics = step(state, base, batch, g)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert (lnm.ln_modulate.launches - fwd, lnm.ln_modulate.launches_bwd - bwd) == (11, 6)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", ["1", "0"], ids=["bf16", "f32"])
def test_two_block_loss_and_lora_grads_match_the_twin_path(cuda, monkeypatch, bf16):
    """WanDiT at Wan2.1-1.3B's width, 2 blocks, batch 2 x L 7800 (the flash
    path, whose outputs do not hang on a discrete top-k choice), computing in
    bf16 or in f32 (--bf16 0): the kernel route against the same model with
    the LNs on the twin, same state, batch and draws; the benchmark's Wan
    limits (loss 1e-3; the median leaf's gradient-norm gap 2e-3, a leaf's gap
    over the larger of its own and the median leaf's norm)."""
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
    from interpolated_diffusion_tpu_torch.train.state import flatten_dict, tree_leaves

    args = p1.build_argparser().parse_args(
        ["--wan_layers", "2", "--attn_mode", "dense", "--text_len", "64", "--bf16", bf16,
         "--device", "cuda"])
    state, _, _, wan, fc = p1.make_trainer(args, cuda)
    g = torch.Generator(cuda).manual_seed(11)
    with torch.no_grad():   # LoRA B and the projector's output away from zero
        for name, p in flatten_dict(state.params).items():
            if name.endswith("lora_B") or name.startswith("frame_cond/out"):
                p.normal_(0.0, 0.02, generator=g)
    C, H, W = args.latent_c, args.latent_h, args.latent_w
    batch = {"latents": torch.randn(args.batch, args.T, C, H, W, generator=g, device=cuda),
             "text_embed": torch.randn(args.batch, args.text_len, args.text_dim, generator=g,
                                       device=cuda) * 0.02}
    N = (H // args.patch_size) * (W // args.patch_size)
    draws = p1.draw_phase1(g, args, args.batch, (args.batch, args.K, N, C * args.patch_size ** 2))
    schedule = make_schedule(args.schedule, args.N_train, device=cuda)
    names, leaves = list(flatten_dict(state.params)), tree_leaves(state.params)
    results = []
    for twin in (False, True):
        if twin:
            monkeypatch.setattr(wan_dit, "ln_modulate", lnm.ln_modulate_twin)
        launches = lnm.ln_modulate.launches
        loss, _ = p1.phase1_loss(wan, fc, args, schedule, batch, draws)
        grads = torch.autograd.grad(loss, leaves)
        assert lnm.ln_modulate.launches - launches == (0 if twin else 2 * 3 * 2 + 1)
        results.append((loss.item(), {n: gr.float().norm().item() for n, gr in zip(names, grads)}))
    (lk, gk), (lt, gt) = results
    loss_gap = abs(lk - lt) / abs(lt)
    med = statistics.median(gt.values())
    gaps = {n: abs(gk[n] - gt[n]) / max(gt[n], med) for n in gt}
    print(f"[ln_modulate] 2-block Wan (--bf16 {bf16}), kernel vs twin route: loss gap "
          f"{loss_gap:.3e}, median leaf gap {statistics.median(gaps.values()):.3e}, worst "
          f"{max(gaps.values()):.3e} ({len(gaps)} leaves)")
    assert loss_gap <= 1e-3
    assert statistics.median(gaps.values()) <= 2e-3
