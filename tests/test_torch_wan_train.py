"""The pieces of the port's Wan Phase-1 trainer against the JAX package, on the
CPU: WanDiT gradients of the trainable leaves, remat, the optimizer, EMA, the
index sampler and helpers, the data copies and the checkpoint format.

Gradient tolerances, per leaf as max|port - jax| / max|jax|:
  - 1e-4 in f32 with dense attention (the same arithmetic, other sum order);
  - 2e-2 where attention runs under a kernel's bf16 contract (sla, sage_sla,
    flash): both packages round q/k/v, p, ds and the attention output to bf16,
    at the same points, but from f32 values a few 1e-7 apart, so some elements
    land one bf16 ulp (2^-8) apart; a leaf's gradient sums such elements over
    all tokens, and through the other layer. The JAX side's attention backward
    is patched to its Pallas kernels in interpret mode for these tests (its CPU
    default differentiates the gather reference instead).
"""
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from interpolated_diffusion_tpu.models.wan_dit import FrameCondProjector as JFrameCond
from interpolated_diffusion_tpu.models.wan_dit import LoRADense as JLoRADense
from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
from interpolated_diffusion_tpu_torch.kernels import sla as psla
from interpolated_diffusion_tpu_torch.models import jax_import
from interpolated_diffusion_tpu_torch.models.wan_dit import (FrameCondProjector, LoRALinear,
                                                             WanDiT, set_compute_dtype)
from interpolated_diffusion_tpu_torch.train import state as pstate
from interpolated_diffusion_tpu_torch.train import wansynth_common as pcommon
from interpolated_diffusion_tpu_torch.utils import checkpoint as pckpt
from interpolated_diffusion_tpu_torch.utils import ema as pema

jbsa = importlib.import_module("interpolated_diffusion_tpu.kernels.block_sparse_attention")
ji8 = importlib.import_module("interpolated_diffusion_tpu.kernels.int8_attention")
jsla = importlib.import_module("interpolated_diffusion_tpu.kernels.sla")

TINY = dict(dim=48, n_layers=2, n_heads=4, ffn_dim=96, in_channels=4, out_channels=4,
            text_dim=32, sla_topk=0.5, sla_block=32, lora_rank=2, lora_alpha=8.0)
F32_TOL, BF16_TOL = 1e-4, 2e-2


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _nonzero(params, rng, scale=0.1):
    """Replace the zero-initialised leaves (lora_B, proj_l, out) with noise."""
    out = {}
    for k, v in traverse_util.flatten_dict(params).items():
        v = np.asarray(v, np.float32)
        if not np.any(v):
            v = (rng.normal(size=v.shape) * scale).astype(np.float32)
        out[k] = v
    return traverse_util.unflatten_dict(out)


def _force_pallas_backward(monkeypatch):
    """JAX side: SLA and int8 SLA differentiate through the Pallas backward
    kernels in interpret mode, flash runs its Pallas kernels in interpret mode."""
    sla_fn, int8_fn = jsla.block_sparse_attention, ji8.int8_block_sparse_attention
    monkeypatch.setattr(jsla, "block_sparse_attention",
                        lambda q, k, v, lut, bm, bn, scale, impl, bwd_impl:
                        sla_fn(q, k, v, lut, bm, bn, scale, "xla", "pallas"))
    monkeypatch.setattr(ji8, "int8_block_sparse_attention",
                        lambda q, k, v, lut, bm, bn, scale, i8mm, bwd_impl, interpret:
                        int8_fn(q, k, v, lut, bm, bn, scale, i8mm, "pallas", True))
    monkeypatch.setattr(jbsa, "flash_attention",
                        functools.partial(jbsa.flash_attention, interpret=True))


def _wan_pair(attn_mode, seed, T=3, H=16, W=16, **over):
    """(jax loss grads over lora + frame_cond, port grads in the JAX layout)."""
    cfg = dict(TINY, **over)
    r = np.random.default_rng(seed)
    lat = r.normal(size=(2, cfg["in_channels"], T, H, W)).astype(np.float32)
    t = np.array([999, 111], np.int32)
    ctx = r.normal(size=(2, 5, cfg["text_dim"])).astype(np.float32)
    fi = np.array([[0, 7, 20], [2, 3, 15]], np.int32)[:, :T]
    feat = r.uniform(size=(2, T, 5)).astype(np.float32)
    w = r.normal(size=(2, cfg["out_channels"], T, H, W)).astype(np.float32)

    jm = JWanDiT(attn_mode=attn_mode, layer_mode="loop", dtype=jnp.float32, **cfg)
    jfc = JFrameCond(feat_dim=5, text_dim=cfg["text_dim"])
    fc_params = _nonzero(jfc.init(jax.random.PRNGKey(seed), jnp.asarray(feat))["params"], r)
    extra0 = jfc.apply({"params": fc_params}, jnp.asarray(feat))
    params = _nonzero(jm.init(jax.random.PRNGKey(seed + 1), *map(jnp.asarray, (lat, t, ctx, fi)),
                              extra0)["params"], r)
    flat = traverse_util.flatten_dict(params)
    lora = traverse_util.unflatten_dict({k: v for k, v in flat.items() if "lora" in k[-1]})
    base = traverse_util.unflatten_dict({k: v for k, v in flat.items() if "lora" not in k[-1]})

    def loss(trainable):
        merged = dict(traverse_util.flatten_dict(base))
        merged.update(traverse_util.flatten_dict(trainable["lora"]))
        extra = jfc.apply({"params": trainable["frame_cond"]}, jnp.asarray(feat))
        out = jm.apply({"params": traverse_util.unflatten_dict(merged)},
                       *map(jnp.asarray, (lat, t, ctx, fi)), extra)
        return jnp.sum(out * w)

    ref = jax.grad(loss)({"lora": lora, "frame_cond": fc_params})   # op by op, no jit

    sd, fc_sd = jax_import.wan_params_to_state_dict(params, frame_cond=fc_params)
    pm = WanDiT(attn_mode=attn_mode, extra_context=True, **cfg).eval()
    pm.load_state_dict(sd, strict=True)
    pfc = FrameCondProjector(feat_dim=5, text_dim=cfg["text_dim"])
    pfc.load_state_dict(fc_sd, strict=True)
    return ref, pm, pfc, tuple(map(torch.tensor, (lat, t, ctx, fi, feat, w)))


def _port_grads(pm, pfc, inputs):
    lat, t, ctx, fi, feat, w = inputs
    lora, base = pcommon.split_lora_state_dict(dict(pm.named_parameters()))
    for p in base.values():
        p.requires_grad_(False)
    leaves = {**{f"lora/{k}": v for k, v in lora.items()},
              **{f"fc/{k}": v for k, v in pfc.named_parameters()}}
    out = pm(lat, t, ctx, fi, pfc(feat))
    grads = torch.autograd.grad((out * w).sum(), list(leaves.values()))
    return dict(zip(leaves, grads))


def _compare_grads(ref, grads, tol):
    got = {"lora": jax_import.lora_to_params(
               {k[5:]: v for k, v in grads.items() if k.startswith("lora/")}),
           "frame_cond": jax_import.frame_cond_to_params(
               {k[3:]: v for k, v in grads.items() if k.startswith("fc/")})}
    flat_ref, flat_got = traverse_util.flatten_dict(ref), traverse_util.flatten_dict(got)
    assert flat_ref.keys() == flat_got.keys()
    worst = max((rel_err(flat_got[k], flat_ref[k]), "/".join(k)) for k in flat_ref)
    assert all(np.abs(v).max() > 0 for v in flat_ref.values())   # every leaf acts
    assert worst[0] <= tol, worst
    return worst


def test_wan_dit_gradients_match_jax_dense_f32():
    ref, pm, pfc, inputs = _wan_pair("dense", seed=1)
    _compare_grads(ref, _port_grads(pm, pfc, inputs), F32_TOL)


@pytest.mark.parametrize("attn_mode", ["sla", "sage_sla"])
def test_wan_dit_gradients_match_jax_sparse(monkeypatch, attn_mode):
    _force_pallas_backward(monkeypatch)
    ref, pm, pfc, inputs = _wan_pair(attn_mode, seed=2)
    _compare_grads(ref, _port_grads(pm, pfc, inputs), BF16_TOL)


def test_wan_dit_gradients_match_jax_flash(monkeypatch):
    """L = 1 x 32 x 64 = 2048: self- and cross-attention through flash, forward
    and backward (one layer, to bound the interpreter's time)."""
    _force_pallas_backward(monkeypatch)
    ref, pm, pfc, inputs = _wan_pair("dense", seed=3, T=1, H=64, W=128, n_layers=1)
    _compare_grads(ref, _port_grads(pm, pfc, inputs), BF16_TOL)


@pytest.mark.parametrize("attn_mode", ["dense", "sla"])
def test_remat_gives_identical_gradients(monkeypatch, attn_mode):
    """One activation checkpoint per block changes no gradient bit; the top-k
    LUT recomputed in the backward pass is the forward's."""
    _, pm, pfc, inputs = _wan_pair(attn_mode, seed=4)
    luts = []
    real = psla.get_block_map
    monkeypatch.setattr(psla, "get_block_map",
                        lambda *a, **k: (lambda out: luts.append(out[1]) or out)(real(*a, **k)))
    plain = _port_grads(pm, pfc, inputs)
    n_plain = len(luts)
    pm.use_remat = True
    remat = _port_grads(pm, pfc, inputs)
    assert plain.keys() == remat.keys()
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
    if attn_mode == "sla":
        n_layers = TINY["n_layers"]
        assert n_plain == n_layers and len(luts) == 3 * n_layers
        forward, recomputed = luts[n_layers:2 * n_layers], luts[2 * n_layers:][::-1]
        assert all(torch.equal(a, b) for a, b in zip(forward, recomputed))


def test_lora_linear_bf16_compute_f32_masters_match_jax():
    """f32 master parameters, bf16 compute: the output is bf16, as JAX's
    LoRADense(dtype=bfloat16) on f32 params, and the masters' gradients are
    f32. Tolerance 2^-7: bf16 products of the same bf16-rounded operands, one
    rounding each for x A, (x A) B, the scaling and the sum."""
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 7, 24)).astype(np.float32)
    w = r.normal(size=(2, 7, 16)).astype(np.float32)
    jl = JLoRADense(features=16, rank=3, alpha=8.0, dtype=jnp.bfloat16)
    p = _nonzero(jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], r)

    def loss(p):
        y = jl.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y.astype(jnp.float32) * w), y

    (_, ref_y), ref_g = jax.value_and_grad(loss, has_aux=True)(p)
    pl = LoRALinear(24, 16, rank=3, alpha=8.0)
    pl.load_state_dict({"weight": torch.tensor(p["kernel"].T.copy()),
                        "bias": torch.tensor(p["bias"]),
                        "lora_A": torch.tensor(p["lora_A"].T.copy()),
                        "lora_B": torch.tensor(p["lora_B"].T.copy())})
    set_compute_dtype(pl, torch.bfloat16)
    y = pl(torch.tensor(x))
    assert y.dtype == torch.bfloat16 and ref_y.dtype == jnp.bfloat16
    (y.float() * torch.tensor(w)).sum().backward()
    assert pl.lora_A.dtype == torch.float32 and pl.lora_A.grad.dtype == torch.float32
    assert rel_err(y.float().detach(), np.asarray(ref_y, np.float32)) <= 2.0 ** -7
    assert rel_err(pl.lora_A.grad.T, ref_g["lora_A"]) <= 2.0 ** -5
    assert rel_err(pl.lora_B.grad.T, ref_g["lora_B"]) <= 2.0 ** -5
    assert rel_err(pl.weight.grad.T, ref_g["kernel"]) <= 2.0 ** -5


def test_init_wan_trainables_partition():
    import types

    args = types.SimpleNamespace(
        wan_dim=48, wan_layers=2, wan_heads=4, wan_ffn=96, latent_c=4, text_dim=32,
        attn_mode="sla", sla_topk=0.5, sla_block=32, lora_rank=2, lora_alpha=8.0,
        lora_form="runtime", lora_targets="attn,ffn", ffn_mode="dense", use_remat=1,
        layer_mode="scan", frame_cond=1, frame_cond_dim=5, wan_pretrained=None)
    wan, fc = pcommon.build_wan(args, bf16=True, generator=torch.Generator().manual_seed(0))
    trainable, base = pcommon.init_wan_trainables(args, wan, fc, bf16=True)
    assert set(trainable) == {"lora", "frame_cond"}
    assert len(trainable["lora"]) == 2 * 10 * 2 and len(trainable["frame_cond"]) == 4
    leaves = pstate.tree_leaves(trainable)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in leaves)   # f32 masters
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in base.values())
    assert wan.compute_dtype == fc.compute_dtype == torch.bfloat16 and wan.use_remat
    # ffn_mode moe: Switch-MoE blocks, no LoRA on the experts (as JAX), frozen in the base
    moe = types.SimpleNamespace(**{**vars(args), "ffn_mode": "moe", "n_experts": 4,
                                   "capacity_factor": 2.0})
    wan, fc = pcommon.build_wan(moe, bf16=True, generator=torch.Generator().manual_seed(0))
    trainable, base = pcommon.init_wan_trainables(moe, wan, fc, bf16=True)
    assert wan.blocks[0].moe_ffn.ffn_in.shape == (4, 48, 96) and not hasattr(wan.blocks[0], "ffn")
    assert len(trainable["lora"]) == 2 * 8 * 2 and "blocks.1.moe_ffn.ffn_out" in base
    # the merged LoRA form: the same leaves and partition, merged into the weights per call
    merged = types.SimpleNamespace(**{**vars(args), "lora_form": "merged"})
    wan, fc = pcommon.build_wan(merged, bf16=True, generator=torch.Generator().manual_seed(0))
    trainable, base = pcommon.init_wan_trainables(merged, wan, fc, bf16=True)
    assert len(trainable["lora"]) == 2 * 10 * 2 and wan.blocks[0].attn1.to_q.form == "merged"
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in pstate.tree_leaves(trainable))
    missing = types.SimpleNamespace(**{**vars(args), "wan_pretrained": "no/such/dir"})
    with pytest.raises(FileNotFoundError):
        pcommon.build_wan(missing, bf16=True, generator=torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# optimizer, EMA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(lr=1e-2, weight_decay=1e-2, grad_clip=1.0),                    # the clip acts
    dict(lr=1e-2, weight_decay=0.1, grad_clip=1e3),                     # it does not
    dict(lr=1e-2, grad_clip=1.0, warmup_steps=2),
    dict(lr=1e-2, grad_clip=0.5, warmup_steps=1, total_steps=3, schedule="cosine")])
def test_optimizer_matches_optax(kwargs):
    """Three AdamW steps behind the global-norm clip against optax, from the
    same parameters and gradients: 1e-6 of each leaf's max."""
    from interpolated_diffusion_tpu.train.state import make_optimizer as j_make_optimizer

    r = np.random.default_rng(6)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}
    mk = lambda scale: jax.tree_util.tree_map(
        lambda s: (r.normal(size=s) * scale).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params0 = mk(1.0)
    grads = [mk(s) for s in (3.0, 0.01, 1.0)]
    tx = j_make_optimizer(**kwargs)
    jp, opt_state, j_norms = jax.tree_util.tree_map(jnp.asarray, params0), None, []
    opt_state = tx.init(jp)
    for g in grads:
        g = jax.tree_util.tree_map(jnp.asarray, g)
        j_norms.append(float(optax.global_norm(g)))
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    to_t = lambda tree: {k: (to_t(v) if isinstance(v, dict) else torch.tensor(v))
                         for k, v in tree.items()}
    pp = to_t(params0)
    opt = pstate.make_optimizer(**kwargs)(pp)
    for g, j_norm in zip(grads, j_norms):
        norm = opt.update(pstate.tree_leaves(to_t(g)))
        assert abs(float(norm) - j_norm) <= 1e-6 * j_norm
    flat_j = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, jp), sep="/")
    flat_p = pstate.flatten_dict(pp)
    assert flat_j.keys() == flat_p.keys()
    for k in flat_j:
        assert rel_err(flat_p[k].numpy(), flat_j[k]) <= 1e-6, k
    # optimizer="muon" is the other optimizer now (held to optax in
    # tests/test_torch_tuning_muon.py), no longer a refusal
    assert isinstance(pstate.make_optimizer(1e-3, optimizer="muon")(to_t(params0)), pstate.Muon)


def test_optimizer_state_roundtrip():
    p = {"w": torch.ones(3, requires_grad=True)}
    tx = pstate.make_optimizer(1e-2, warmup_steps=3)
    a, b = tx(p), None
    a.update([torch.full((3,), 0.5)])
    q = {"w": p["w"].detach().clone().requires_grad_()}
    b = tx(q)
    b.load_state_dict(a.state_dict())
    a.update([torch.full((3,), -0.25)])
    b.update([torch.full((3,), -0.25)])
    assert b.count == 2 and torch.equal(p["w"], q["w"])


def test_ema_matches_jax():
    from interpolated_diffusion_tpu.utils.ema import ema_update as j_ema_update

    r = np.random.default_rng(7)
    p0 = {"a": r.normal(size=(4, 3)).astype(np.float32), "b": {"c": r.normal(size=5).astype(np.float32)}}
    p1 = jax.tree_util.tree_map(lambda x: x + 1, p0)
    ref = j_ema_update(jax.tree_util.tree_map(jnp.asarray, p0),
                       jax.tree_util.tree_map(jnp.asarray, p1), 0.9)
    tt = lambda tree: {k: (tt(v) if isinstance(v, dict) else torch.tensor(v)) for k, v in tree.items()}
    params = tt(p0)
    ema = pema.ema_init(params)
    assert ema["a"] is not params["a"] and torch.equal(ema["b"]["c"], params["b"]["c"])
    out = pema.ema_update(ema, tt(p1), 0.9)
    assert out is ema
    assert rel_err(ema["a"].numpy(), ref["a"]) <= 1e-6
    assert rel_err(ema["b"]["c"].numpy(), ref["b"]["c"]) <= 1e-6


def test_train_step_frozen_updates_only_trainables():
    """loss = |W x + b|^2 with W frozen: one step moves b, not W, and reports
    the loss and the pre-clip gradient norm."""
    W = torch.randn(3, 3, generator=torch.Generator().manual_seed(0))
    params = {"b": torch.zeros(3, requires_grad=True)}
    x = torch.ones(3)

    def loss_fn(p, frozen, batch, rng):
        return ((frozen["W"] @ batch + p["b"]) ** 2).sum(), {"extra": torch.tensor(1.0)}

    state = pstate.init_train_state(params, pstate.make_optimizer(1e-1, grad_clip=1e9), True)
    step = pstate.make_train_step_frozen(loss_fn, ema_decay=0.5)
    W0 = W.clone()
    state, metrics = step(state, {"W": W}, x, None)
    g = 2 * (W0 @ x)
    assert state.step == 1 and torch.equal(W, W0)
    assert torch.allclose(metrics["grad_norm"], g.norm()) and float(metrics["extra"]) == 1.0
    assert torch.allclose(metrics["loss"], ((W0 @ x) ** 2).sum())
    assert torch.allclose(params["b"], -0.1 * torch.sign(g), atol=1e-6)   # Adam's first step
    assert torch.allclose(state.ema_params["b"], 0.5 * params["b"].detach())


# ---------------------------------------------------------------------------
# index sampler, helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,K,endpoints,jitter", [(21, 5, False, 0.5), (9, 3, False, 0.5),
                                                  (21, 5, True, 1.0), (8, 8, False, 0.9),
                                                  (21, 5, False, 0.0)])
def test_uniform_index_sampler_matches_jax(T, K, endpoints, jitter):
    from interpolated_diffusion_tpu.ops.keyframes import (
        sample_fixed_k_indices_uniform_batch as j_sample)
    from interpolated_diffusion_tpu_torch.ops.keyframes import (
        sample_fixed_k_indices_uniform_batch as p_sample)

    B = 16
    key = jax.random.PRNGKey(T + K)
    ref_idx, ref_mask = j_sample(key, B, T, K, ensure_endpoints=endpoints, jitter=jitter)
    rand = torch.tensor(np.asarray(jax.random.uniform(key, (B, K))))   # the draw JAX makes
    idx, mask = p_sample(B, T, K, ensure_endpoints=endpoints, jitter=jitter, rand=rand)
    assert np.array_equal(idx.numpy(), np.asarray(ref_idx))
    assert np.array_equal(mask.numpy(), np.asarray(ref_mask))
    assert bool((idx[:, 1:] > idx[:, :-1]).all())
    own, _ = p_sample(B, T, K, ensure_endpoints=endpoints, jitter=jitter,
                      generator=torch.Generator().manual_seed(0))
    assert own.shape == (B, K) and bool((own[:, 1:] > own[:, :-1]).all())


def test_midpoints_meanpool_and_video_interpolation_match_jax():
    from interpolated_diffusion_tpu.ops.video_keyframes import (
        interpolate_video_from_indices as j_interp)
    from interpolated_diffusion_tpu.train import wansynth_common as jcommon
    from interpolated_diffusion_tpu_torch.ops.video_keyframes import (
        interpolate_video_from_indices as p_interp)

    r = np.random.default_rng(8)
    B, T, N, D, K = 3, 12, 4, 6, 4
    tokens = r.normal(size=(B, T, N, D)).astype(np.float32)
    idx = np.array([[0, 1, 5, 11], [2, 3, 4, 9], [0, 6, 7, 8]], np.int32)   # gaps of 1 too
    assert np.array_equal(pcommon.midpoint_indices(torch.tensor(idx).long()).numpy(),
                          np.asarray(jcommon.midpoint_indices(jnp.asarray(idx))))
    ref = jcommon.meanpool_between_anchors(jnp.asarray(tokens), jnp.asarray(idx))
    got = pcommon.meanpool_between_anchors(torch.tensor(tokens), torch.tensor(idx).long())
    assert got.shape == (B, K - 1, N, D) and rel_err(got.numpy(), ref) <= 1e-6
    vals = r.normal(size=(B, K, D)).astype(np.float32)
    for mode in ("linear", "smooth"):
        ref = j_interp(jnp.asarray(idx), jnp.asarray(vals), T, mode=mode)
        got = p_interp(torch.tensor(idx).long(), torch.tensor(vals), T, mode=mode)
        assert rel_err(got.numpy(), ref) <= 1e-6, mode
        anchors = torch.gather(got, 1, torch.tensor(idx).long()[..., None].expand(B, K, D))
        assert torch.equal(anchors, torch.tensor(vals))   # anchors written back exactly
    # learned: the lerp refined by interp_fn, the anchors written back exactly
    ref = j_interp(jnp.asarray(idx), jnp.asarray(vals), T, mode="learned",
                   interp_fn=lambda z: jnp.tanh(2.0 * z) + 0.5)
    got = p_interp(torch.tensor(idx).long(), torch.tensor(vals), T, mode="learned",
                   interp_fn=lambda z: torch.tanh(2.0 * z) + 0.5)
    assert rel_err(got.numpy(), ref) <= 1e-6
    with pytest.raises(ValueError, match="interp_fn"):
        p_interp(torch.tensor(idx).long(), torch.tensor(vals), T, mode="learned")


# ---------------------------------------------------------------------------
# data copies, checkpoints
# ---------------------------------------------------------------------------

def test_data_copies_match_jax_package_exactly(tmp_path):
    from interpolated_diffusion_tpu.data import dataset as jds
    from interpolated_diffusion_tpu.data import wan_synth as jws
    from interpolated_diffusion_tpu_torch.data import dataset as pds
    from interpolated_diffusion_tpu_torch.data import wan_synth as pws

    kw = dict(n_samples=10, T=9, C=4, H=8, W=8, text_len=6, text_dim=16, seed=3)
    jd, pd = jws.SyntheticWanDataset(**kw), pws.SyntheticWanDataset(**kw)
    for i in (0, 7):
        a, b = jd.get(i), pd.get(i)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    jl = iter(jds.BatchLoader(jd, batch_size=2, seed=5, prefetch=0, start_batch=1))
    loader = pds.BatchLoader(pd, batch_size=2, seed=5, prefetch=2, start_batch=1)
    pl = iter(loader)
    for _ in range(3):
        a, b = next(jl), next(pl)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert loader.state["batches"] >= 4

    # tar shards: written by one copy, read by the other, same stream and state
    samples = [{"__key__": f"{s}_{i:03d}", "latents": jd.get(s * 5 + i)["latents"],
                "text_embed": jd.get(s * 5 + i)["text_embed"]} for s in range(2) for i in range(5)]
    root = str(tmp_path / "shards")
    jws.write_tar_shard(os.path.join(root, "shard_00000.tar"), samples[:5])
    pws.write_tar_shard(os.path.join(root, "shard_00001.tar"), samples[5:])
    read = [s["__key__"] for s in pws.iter_tar_samples(os.path.join(root, "shard_00000.tar"))]
    assert read == [s["__key__"] for s in samples[:5]]
    jt = jws.WanSynthTarDataset(root, T=9, seed=1, shuffle_buffer=4, process_split=False)
    pt = pws.WanSynthTarDataset(root, T=9, seed=1, shuffle_buffer=4)
    ji, pi = jt.batches(3), pt.batches(3)
    for _ in range(5):   # crosses an epoch boundary (10 samples, 3 per batch)
        a, b = next(ji), next(pi)
        assert a["__keys__"] == b["__keys__"] and np.array_equal(a["latents"], b["latents"])
        assert ji.state == pi.state
    resumed = pt.batches(3, state=pi.state)
    assert next(resumed)["__keys__"] == next(ji)["__keys__"]
    assert pws.split_by_process(["a", "b", "c"], 1, 2) == ["b"]
    joined = list(pws.key_join(iter([{"__key__": "x", "v": 1}, {"__key__": "y", "v": 2}]),
                               iter([{"__key__": "y", "a": 20}, {"__key__": "x", "a": 10}]),
                               fields=("a",)))
    assert [(j["v"], j["a"]) for j in joined] == [(1, 10), (2, 20)]
    with pytest.raises(pws.KeyJoinError):
        list(pws.key_join(iter([{"__key__": "x"}]), iter([]), fields=("a",)))


def test_checkpoint_save_load_latest_and_recovery(tmp_path):
    params = {"lora": {"blocks.0.attn1.to_q.lora_A": torch.randn(2, 4)},
              "frame_cond": {"out.weight": torch.randn(3, 2)}}
    opt = pstate.make_optimizer(1e-3)({"w": torch.zeros(2, requires_grad=True)})
    opt.update([torch.ones(2)])
    root = str(tmp_path / "run")
    meta = {"stage": "keypoints_wansynth", "use_wan": 1, "wan_head_mod": "t_emb",
            "data_state": {"batches": 7}}
    for step in (2, 10):
        pckpt.save_checkpoint(os.path.join(root, f"ckpt_{step}"), params, opt.state_dict(), step,
                              pema.ema_init(params), meta)
    latest = pckpt.latest_checkpoint(root)
    assert latest.endswith("ckpt_10") and pckpt.read_meta(latest) == (10, meta)
    assert sorted(os.listdir(latest)) == ["ema.pt", "meta.json", "opt_state.pt", "params.pt"]
    step, payload = pckpt.load_checkpoint(latest)
    assert step == 10 and payload["meta"] == meta and payload["opt_state"]["count"] == 1
    for tree in (payload["params"], payload["ema"]):
        flat, want = pstate.flatten_dict(tree), pstate.flatten_dict(params)
        assert flat.keys() == want.keys() and all(torch.equal(flat[k], want[k]) for k in flat)
    # overwrite in place; a save killed between its two renames is recovered
    pckpt.save_checkpoint(latest, params, None, 10, None, meta)
    assert sorted(os.listdir(latest)) == ["meta.json", "params.pt"]
    os.replace(latest, os.path.join(root, ".prev-ckpt_10"))
    assert pckpt.latest_checkpoint(root).endswith("ckpt_10")
    assert not [n for n in os.listdir(root) if n.startswith(".")]
    pcommon.check_wan_meta(meta)
    with pytest.raises(ValueError):
        pcommon.check_wan_meta({**meta, "wan_head_mod": "t_mod"})
    with pytest.warns(UserWarning):
        pcommon.check_wan_meta({"use_wan": 1})
