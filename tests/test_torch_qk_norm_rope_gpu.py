"""The q/k RMSNorm + RoPE kernels (csrc/qk_norm_rope.cu) on the card.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
mode). This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_qk_norm_rope_gpu.py -q -s

Each in bf16 (the trainers' default) and in f32 (a model run with --bf16 0).
Forward: the kernel rounds where the twin (rms_norm, then apply_rope) rounds,
so for the same per-row rstd its output is the twin's bit for bit; the rstd
itself differs only by the order of the mean square's sum. Backward: the
kernel's f32 dx and dw against an f64 evaluation of the same chain, no farther
from it than the twin's autograd (in f32, where neither rounds to a coarser
grid, within twice its gap). Then WanDiT on the kernel route: the launches of
a Phase-1 step, and a 2-block model's loss and LoRA gradients against the
same model on the twin.
"""
import statistics

import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import qk_norm_rope as qknr
from interpolated_diffusion_tpu_torch.models import wan_dit

WAN_D, WAN_H = 1536, 12
# (name, B, L, D, H, rope): the Phase-1 self-attention (frame-indexed tables,
# one per sample), its cross-attention keys (no RoPE), Phase 2's 32760 tokens
# (tables shared by the batch), and a small head dim with ragged rows
CASES = [("p1_self", 2, 7800, WAN_D, WAN_H, "frames"),
         ("p1_cross_k", 2, 517, WAN_D, WAN_H, None),
         ("p2_self", 2, 32760, WAN_D, WAN_H, "shared"),
         ("dh8", 3, 37, 24, 3, "frames")]
X_DTYPES = [torch.bfloat16, torch.float32]
MANTISSA = {torch.bfloat16: 7, torch.float32: 23}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(B, L, D, H, rope, w_dtype, dev, seed=0, x_dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(B, L, D, generator=g, device=dev) * 3.0).to(x_dtype)
    w = (1 + 0.3 * torch.randn(D, generator=g, device=dev)).to(w_dtype)
    if rope is None:
        return x, w, None, None
    dh = D // H
    pos = torch.rand(B if rope == "frames" else 1, L, 1, generator=g, device=dev) * 1000
    ang = pos * torch.rand(dh // 2, generator=g, device=dev)
    return x, w, torch.cos(ang), torch.sin(ang)


def _from_rstd(x, w, cos, sin, H, rstd):
    """The twin's arithmetic after the mean square, on a given rstd [B*L]."""
    B, L, D = x.shape
    y = (x.float() * rstd.reshape(B, L, 1)).to(x.dtype) * w.to(x.dtype)
    if cos is None:
        return y
    return qknr.apply_rope(y.reshape(B, L, H, D // H).transpose(1, 2), cos, sin)


def _ulps(a, b, cos, mantissa):
    """|a - b| in ulps (of a `mantissa`-bit format) of the scale it rounds at:
    the element's (without RoPE) or its pair's magnitude (with RoPE: the
    rotation keeps the pair's norm)."""
    a, b = a.float(), b.float()
    if cos is None:
        m = torch.maximum(a.abs(), b.abs())
    else:
        m = torch.sqrt(b[..., 0::2] ** 2 + b[..., 1::2] ** 2).repeat_interleave(2, dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp_min(2.0 ** -120))) - mantissa)
    return (a - b).abs() / ulp


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16], ids=["w_f32", "w_bf16"])
@pytest.mark.parametrize("name,B,L,D,H,rope", CASES, ids=[c[0] for c in CASES])
def test_forward_against_the_twin(cuda, name, B, L, D, H, rope, w_dtype, x_dtype):
    x, w, cos, sin = _inputs(B, L, D, H, rope, w_dtype, cuda, x_dtype=x_dtype)
    before = qknr.qk_norm_rope.launches
    q, rstd = qknr._forward(x, w, cos, sin, H, 1e-6)
    assert qknr.qk_norm_rope.launches == before + 1
    twin = qknr.qk_norm_rope_twin(x, w, cos, sin, n_heads=H)
    assert q.shape == twin.shape and q.is_contiguous() and q.dtype == x_dtype
    # the rstd: f32 sums of 1536 squares in two orders, a few f32 ulps apart
    var = x.float().square().mean(dim=-1).reshape(-1)
    rel = ((rstd - torch.rsqrt(var + 1e-6)).abs() / rstd).max().item()
    assert rel <= 1e-5, rel
    # for the kernel's own rstd, the twin's rounding points give its output exactly
    assert torch.equal(q, _from_rstd(x, w, cos, sin, H, rstd))
    # against the twin: in bf16 a flip of n by one ulp, carried by the weight's
    # product (one ulp of n is up to |w| / ulp(y) of y's ulps) and rounded once
    # more. In f32 every element moves: the rstd gap (rel of the value, up to
    # rel * 2^24 ulps), one ulp of n times |w| (< 2 here) and one of y, both
    # carried through the rotation (|c| + |s| <= sqrt 2), and the rotation's
    # three roundings: up to 1.5 (rel * 2^24 + 3) + 3 ulps
    u = _ulps(q, twin, cos, MANTISSA[x_dtype])
    equal = (u == 0).float().mean().item()
    within1 = (u <= 1).float().mean().item()
    print(f"[qk_norm_rope] {name} [{B},{L},{D}] H {H} x {x_dtype} w {w_dtype}: bitwise-equal "
          f"share {equal:.7f}, within one ulp {within1:.7f}, max {u.max().item():.2f} ulps, "
          f"rstd max rel gap {rel:.2e}")
    bound = 2.0 if x_dtype == torch.bfloat16 else 1.5 * (rel * 2 ** 24 + 3) + 3
    assert u.max().item() <= bound


def _chain64(x, w, cos, sin, H):
    """The same chain in f64, without rounding: y = x rsqrt(mean x^2 + eps) w, rotated."""
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + 1e-6) * w
    if cos is None:
        return y
    B, L, D = x.shape
    y = y.reshape(B, L, H, D // H).transpose(1, 2)
    y1, y2 = y[..., 0::2], y[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([y1 * c - y2 * s, y1 * s + y2 * c], dim=-1).reshape(y.shape)


def _gap(a, ref):
    return ((a.double() - ref).norm() / ref.norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("name,B,L,D,H,rope", [c for c in CASES if c[0] != "p2_self"],
                         ids=[c[0] for c in CASES if c[0] != "p2_self"])
def test_backward_against_f64(cuda, name, B, L, D, H, rope, x_dtype):
    """dx and dw (an f32 weight that wants a gradient, as in full fine-tuning)
    against f64 autograd of the unrounded chain, on the weight values both
    paths compute with (rounded to x's dtype): relative 2-norm gap of the
    kernel's <= the twin's in bf16, <= twice the twin's in f32 (both a few
    f32 ulps, summed in other orders)."""
    x, w, cos, sin = _inputs(B, L, D, H, rope, torch.float32, cuda, seed=1, x_dtype=x_dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    shape = (B, L, D) if rope is None else (B, H, L, D // H)
    dq = torch.randn(shape, generator=g, device=cuda).to(x_dtype)
    grads = {}
    for path, fn in (("kernel", qknr.qk_norm_rope), ("twin", qknr.qk_norm_rope_twin)):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = fn(xl, wl, cos, sin, n_heads=H)
        grads[path] = torch.autograd.grad(out, [xl, wl], dq)
    x64 = x.double().requires_grad_(True)
    w64 = w.to(x_dtype).double().requires_grad_(True)
    c64, s64 = (None, None) if cos is None else (cos.double(), sin.double())
    ref = torch.autograd.grad(_chain64(x64, w64, c64, s64, H), [x64, w64], dq.double())
    for i, what in enumerate(("dx", "dw")):
        k, t = _gap(grads["kernel"][i], ref[i]), _gap(grads["twin"][i], ref[i])
        print(f"[qk_norm_rope] {name} {x_dtype} {what}: gap to f64 kernel {k:.3e}, twin {t:.3e}")
        assert k <= (t if x_dtype == torch.bfloat16 else 2 * t), (what, k, t)
    assert grads["kernel"][0].dtype == x_dtype and grads["kernel"][1].dtype == torch.float32


def _p1_args(layers, extra=()):
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1

    return p1, p1.build_argparser().parse_args(
        ["--T", "9", "--latent_c", "4", "--latent_h", "32", "--latent_w", "64", "--text_len", "8",
         "--text_dim", "64", "--wan_dim", "256", "--wan_layers", str(layers), "--wan_heads",
         "2", "--wan_ffn", "512", "--K", "5", "--sla_block", "64", "--sla_topk", "0.5",
         "--device", "cuda", *extra])


@pytest.mark.gpu
def test_phase1_step_launches(cuda):
    """A Phase-1 LoRA step at 30 blocks (remat): 4 norms a block (self q, k
    with RoPE; cross q, k without), each forward twice, each backward once."""
    p1, args = _p1_args(30)
    state, base, step, _, _ = p1.make_trainer(args, cuda)
    g = torch.Generator(cuda).manual_seed(10)
    batch = {"latents": torch.randn(2, 9, 4, 32, 64, generator=g, device=cuda),
             "text_embed": torch.randn(2, 8, 64, generator=g, device=cuda)}
    fwd, bwd = qknr.qk_norm_rope.launches, qknr.qk_norm_rope.launches_bwd
    state, metrics = step(state, base, batch, g)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert (qknr.qk_norm_rope.launches - fwd, qknr.qk_norm_rope.launches_bwd - bwd) == (240, 120)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", ["1", "0"], ids=["bf16", "f32"])
def test_two_block_loss_and_lora_grads_match_the_twin_path(cuda, monkeypatch, bf16):
    """WanDiT at Wan2.1-1.3B's width, 2 blocks, batch 2 x L 7800 (the flash
    path, whose outputs do not hang on a discrete top-k choice), computing in
    bf16 or in f32 (--bf16 0): the kernel route against the same model with
    the q/k chain on the twin, same state, batch and draws; the benchmark's Wan
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
            monkeypatch.setattr(wan_dit, "qk_norm_rope", qknr.qk_norm_rope_twin)
        launches = qknr.qk_norm_rope.launches
        loss, _ = p1.phase1_loss(wan, fc, args, schedule, batch, draws)
        grads = torch.autograd.grad(loss, leaves)
        assert qknr.qk_norm_rope.launches - launches == (0 if twin else 2 * 4 * 2)
        results.append((loss.item(), {n: gr.float().norm().item() for n, gr in zip(names, grads)}))
    (lk, gk), (lt, gt) = results
    loss_gap = abs(lk - lt) / abs(lt)
    med = statistics.median(gt.values())
    gaps = {n: abs(gk[n] - gt[n]) / max(gt[n], med) for n in gt}
    print(f"[qk_norm_rope] 2-block Wan (--bf16 {bf16}), kernel vs twin route: loss gap "
          f"{loss_gap:.3e}, median "
          f"leaf gap {statistics.median(gaps.values()):.3e}, worst {max(gaps.values()):.3e} "
          f"({len(gaps)} leaves)")
    assert loss_gap <= 1e-3
    assert statistics.median(gaps.values()) <= 2e-3
