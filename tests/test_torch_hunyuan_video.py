"""HunyuanVideo as the Phase-1 backbone (models/hunyuan_video.py, --dit
hunyuan_video) against the plain float32 reference the benchmark uses
(portbench/reference/hunyuan_ref.py), on the CPU at a small size: dim 256 (2
heads of 128, the published head width, so RoPE's 16 / 56 / 56 split holds),
2 dual- and 2 single-stream blocks, 2 refiner blocks, ragged prompt masks.

Both run in float32 on the same seeded weights (the base drawn in bfloat16,
as the benchmark draws it), so they differ by the order of their sums alone:
the forward and the loss within 1e-6 relative (5e-8 is read; the
reference in float8, the benchmark's control, is 5e-2 off), every LoRA
gradient within 1e-5 of the largest one's norm. Padded prompt tokens, whatever they hold,
leave every video output bit for bit as it was. Then the port's normal path:
one CPU step of make_trainer under --dit hunyuan_video, and run_meta read back
into the model's arguments; the kernels' plain twins with the per-row key
length and the per-head, row-bounded q/k norm against plain PyTorch.
"""
import copy

import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
from interpolated_diffusion_tpu_torch.kernels import qk_norm_rope as qknr
from interpolated_diffusion_tpu_torch.models.hunyuan_video import HunyuanVideoTransformer3DModel
from interpolated_diffusion_tpu_torch.models.wan_dit import FrameCondProjector, WanDiT
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as tk
from interpolated_diffusion_tpu_torch.train.wansynth_common import (hunyuan_kwargs,
                                                                     wan_args_from_meta)
from portbench.harness.weights import load_into, make_weights
from portbench.reference import hunyuan_ref
from portbench.reference.numerics import Numerics

CFG = {"num_attention_heads": 2, "attention_head_dim": 128, "num_layers": 2,
       "num_single_layers": 2, "num_refiner_layers": 2, "mlp_ratio": 4.0, "patch_size": 2,
       "patch_size_t": 1, "in_channels": 4, "out_channels": 4, "text_embed_dim": 64,
       "pooled_projection_dim": 32, "rope_theta": 256.0, "rope_axes_dim": [16, 56, 56],
       "lora_rank": 4, "lora_alpha": 8.0, "frame_cond_dim": 5, "frame_cond_hidden": 16,
       "guidance": 6.0, "K": 3, "uniform_jitter": 0.5, "cond_drop_prob": 0.5, "n_train": 1000,
       "lr": 1e-4, "weight_decay": 0.01, "grad_clip": 1.0}
B, T, H, W, LT = 2, 9, 8, 8, 12
FLAGS = ["--dit", "hunyuan_video", "--hy_heads", "2", "--hy_double", "2",
         "--hy_single", "2", "--latent_c", "4", "--latent_h", str(H),
         "--latent_w", str(W), "--T", str(T), "--K", "3", "--text_len", str(LT),
         "--text_dim", "64", "--pooled_dim", "32", "--text_valid_min", "2",
         "--text_valid_max", "9", "--lora_rank", "4", "--lora_alpha", "8", "--batch", str(B),
         "--cond_drop_prob", "0.5", "--uniform_jitter", "0.5", "--device", "cpu", "--bf16", "0",
         "--use_remat", "1", "--prefetch_depth", "0", "--seed", "3"]


def _program(P):
    """The port's model and projector in f32, holding the reference's weights."""
    args = tk.build_argparser().parse_args(FLAGS)
    model = HunyuanVideoTransformer3DModel(**hunyuan_kwargs(args)).float()
    fc = FrameCondProjector(5, 64, 16).float()
    load_into(model, {k: v.float() for k, v in P.items()}, "hy.")
    load_into(fc, {k: v.float() for k, v in P.items()}, "fc.")
    return args, model, fc


def _weights(seed=0):
    return make_weights(hunyuan_ref.param_spec(CFG), seed, "cpu")


def _inputs(seed=1, valid=(3, 9)):
    g = torch.Generator().manual_seed(seed)
    lat = torch.randn(B, 4, 3, H, W, generator=g)
    text = torch.randn(B, LT, 64, generator=g)
    mask = (torch.arange(LT)[None] < torch.tensor(valid)[:, None]).int()
    pooled = torch.randn(B, 32, generator=g)
    t = torch.tensor([17, 803])
    frames = torch.tensor([[0, 4, 8], [1, 3, 7]])
    return lat, t, text, mask, pooled, torch.full((B,), 6000.0), frames


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_forward_matches_the_reference():
    P = _weights()
    _, model, _ = _program(P)
    lat, t, text, mask, pooled, g, frames = _inputs()
    with torch.no_grad():
        out = model(lat, t, text, frames, text_mask=mask, pooled=pooled, guidance=g)
        ref = hunyuan_ref.HyRef(P, CFG, Numerics("f32")).forward(lat, t, text, mask.bool(),
                                                                 pooled, g, frames)
    assert out.shape == lat.shape
    assert _rel(out, ref) < 1e-6


def test_padded_text_leaves_the_video_unchanged():
    P = _weights()
    _, model, _ = _program(P)
    lat, t, text, mask, pooled, g, frames = _inputs(valid=(2, 7))
    noisy = text.clone()
    noisy[mask == 0] = torch.randn(int((mask == 0).sum()), 64) * 50.0
    with torch.no_grad():
        a = model(lat, t, text, frames, text_mask=mask, pooled=pooled, guidance=g)
        b = model(lat, t, noisy, frames, text_mask=mask, pooled=pooled, guidance=g)
    assert torch.equal(a, b)


def _batch(seed=5):
    g = torch.Generator().manual_seed(seed)
    return {"latents": torch.randn(B, T, 4, H, W, generator=g),
            "text_embed": torch.randn(B, LT, 64, generator=g) * 0.5,
            "text_mask": (torch.arange(LT)[None] < torch.tensor([4, 11])[:, None]).int(),
            "pooled": torch.randn(B, 32, generator=g)}


def _draws(seed=6):
    g = torch.Generator().manual_seed(seed)
    return {"idx_rand": torch.rand(B, 3, generator=g), "t": torch.tensor([250, 900]),
            "eps": torch.randn(B, 3, (H // 2) * (W // 2), 16, generator=g),
            "drop_rand": torch.tensor([0.7, 0.2])}   # the second row's prompt is dropped


def test_phase1_loss_and_lora_gradients_match_the_reference():
    P = _weights()
    args, model, fc = _program(P)
    lora = {n: p for n, p in model.named_parameters() if n.endswith(("lora_A", "lora_B"))}
    for p in model.parameters():
        p.requires_grad_(False)
    for p in list(lora.values()) + list(fc.parameters()):
        p.requires_grad_(True)
    batch, draws = _batch(), _draws()
    schedule = make_schedule("linear", 1000)
    loss, _ = tk.phase1_loss(model, fc, args, schedule, batch, draws)
    grads = torch.autograd.grad(loss, list(lora.values()))

    R = {n: (v.float().clone().requires_grad_(True) if n.startswith("fc.") or "lora" in n
             else v) for n, v in P.items()}
    ref_loss = hunyuan_ref.phase1_loss(hunyuan_ref.HyRef(R, CFG, Numerics("f32")), CFG, batch,
                                       draws)
    ref_grads = torch.autograd.grad(ref_loss, [R["hy." + n] for n in lora])
    assert abs(float(loss.detach()) - float(ref_loss)) / float(ref_loss) < 1e-6
    top = max(float(g.norm()) for g in ref_grads)
    assert len(grads) == 68
    for n, a, b in zip(lora, grads, ref_grads):
        assert float((a - b).norm()) < 1e-5 * top, n


def test_one_trainer_step_on_the_cpu():
    args = tk.build_argparser().parse_args(FLAGS)
    state, base, step, model, fc = tk.make_trainer(args, torch.device("cpu"))
    assert isinstance(model, HunyuanVideoTransformer3DModel)
    before = {n: p.detach().clone() for n, p in state.params["lora"].items()}
    rng = torch.Generator().manual_seed(0)
    state, metrics = step(state, base, _batch(), rng)
    assert torch.isfinite(metrics["loss"])
    moved = [n for n, p in state.params["lora"].items() if not torch.equal(p, before[n])]
    assert len(moved) == len(before) == 68
    assert all(p.dtype == torch.float32 for p in state.params["frame_cond"].values())


def test_run_meta_round_trip():
    args = tk.build_argparser().parse_args(FLAGS)
    meta = tk.run_meta(args, 4, H, W)
    assert meta["dit"] == "hunyuan_video" and meta["hy_double"] == 2
    back = wan_args_from_meta(meta, lora_form="runtime", use_remat=1)
    assert hunyuan_kwargs(back) == hunyuan_kwargs(args)
    defaults = tk.build_argparser().parse_args(["--dit", "hunyuan_video"])
    with torch.device("meta"):   # 12.8B parameters: shapes only
        published = HunyuanVideoTransformer3DModel(**hunyuan_kwargs(defaults))
    assert (published.heads, published.dim, len(published.transformer_blocks),
            len(published.single_transformer_blocks),
            len(published.context_embedder.token_refiner.refiner_blocks),
            published.single_transformer_blocks[0].proj_mlp.out_features,
            published.time_text_embed.text_embedder.linear_1.in_features) == (
        24, 3072, 20, 40, 2, 12288, 768)
    assert "dit" in tk.run_meta(copy.copy(tk.build_argparser().parse_args([])), 16, 60, 104)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_twin_with_key_lengths_is_masked_attention(dtype):
    g = torch.Generator().manual_seed(0)
    BH, Lq, Lk, D = 4, 70, 300, 64
    q, k, v, do = (torch.randn(BH, n, D, generator=g).to(dtype) for n in (Lq, Lk, Lk, Lq))
    lens = torch.tensor([1, 37, 129, 300], dtype=torch.int32)
    keep = torch.arange(Lk)[None, None, :] < lens[:, None, None].long()
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * D ** -0.5
    ref = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1) @ vf
    dq_r, dk_r, dv_r = torch.autograd.grad(ref, (qf, kf, vf), do.float())
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = bsa.flash_attention(qa, ka, va, 512, 128, kv_lens=lens)
    dq, dk, dv = torch.autograd.grad(out, (qa, ka, va), do)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for a, b in ((out, ref), (dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert _rel(a.float(), b) < tol
    past = ~keep[:, 0, :]
    assert float(dk.float()[past].abs().max()) == 0.0 and float(dv.float()[past].abs().max()) == 0.0


def test_qk_norm_per_head_and_rope_rows_twin():
    g = torch.Generator().manual_seed(0)
    Bq, L, Hq, Dh, n = 2, 11, 3, 64, 7
    x = torch.randn(Bq, L, Hq * Dh, generator=g)
    w = 1 + 0.1 * torch.randn(Dh, generator=g)
    ang = torch.rand(Bq, n, Dh // 2, generator=g) * 10
    cos, sin = torch.cos(ang), torch.sin(ang)
    out = qknr.qk_norm_rope(x, w, cos, sin, n_heads=Hq, rope_rows=n)
    xh = x.reshape(Bq, L, Hq, Dh)
    y = (xh * torch.rsqrt(xh.square().mean(-1, keepdim=True) + 1e-6) * w).transpose(1, 2)
    want = torch.cat([qknr.apply_rope(y[:, :, :n], cos, sin), y[:, :, n:]], dim=2)
    assert out.shape == (Bq, Hq, L, Dh)
    assert torch.allclose(out, want, atol=1e-6, rtol=1e-6)
    qknr._check(x, w, cos, sin, Hq, rope_rows=n)
    with pytest.raises(ValueError, match="qk_norm_rope"):
        qknr._check(x, w, cos, sin, Hq)   # tables of n rows need rope_rows n
    with pytest.raises(ValueError, match="qk_norm_rope"):
        qknr._check(torch.randn(Bq, L, 3 * 40), torch.ones(40), None, None, 3)   # Dh not 2^k


WAN_FLAGS = ["--wan_dim", "256", "--wan_layers", "1", "--wan_heads", "2", "--wan_ffn", "64",
             "--latent_c", "4", "--latent_h", str(H), "--latent_w", str(W), "--T", str(T),
             "--text_len", str(LT), "--text_dim", "64", "--batch", str(B), "--device", "cpu"]


@pytest.mark.parametrize("flags,cls,inputs", [
    (FLAGS, HunyuanVideoTransformer3DModel, {"text_mask", "pooled"}),
    (WAN_FLAGS, WanDiT, set())])
def test_the_backbone_choice_reaches_the_build_and_the_rows(flags, cls, inputs):
    """--dit is read where the model is built and where the rows are made:
    a checkpoint's meta rebuilds the backbone it was trained with, and only
    HunyuanVideo's rows carry the prompt mask and the pooled vector (the
    Phase-1 loss hands the model what the batch carries)."""
    from interpolated_diffusion_tpu_torch.train.wansynth_common import (build_wan,
                                                                         make_wansynth_loader)

    args = tk.build_argparser().parse_args(flags)
    back = wan_args_from_meta(tk.run_meta(args, 4, H, W))
    model, _ = build_wan(back, False, generator=torch.Generator().manual_seed(0), device="cpu")
    assert type(model) is cls
    row = next(make_wansynth_loader(args, 0))
    assert set(row) == {"latents", "text_embed"} | inputs
    if inputs:
        n = row["text_mask"].sum(axis=1)
        assert (n >= 2).all() and (n <= 9).all() and row["pooled"].shape == (B, 32)
