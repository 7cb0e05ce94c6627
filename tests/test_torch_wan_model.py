"""The port's WanDiT (interpolated_diffusion_tpu_torch.models.wan_dit) against
the JAX WanDiT on the same weights and inputs, in f32 on the CPU.

A tiny model (dim 48, 2 layers, 4 heads, text_dim 32; latents [2, 4, 3, 16, 16]
so L = 192; SLA block 32, top-k 0.5) with runtime LoRA rank 2, frame indices
(absolute-time RoPE) and extra context, and every zero-initialised leaf
(lora_B, sla/proj_l, frame_cond/out) made non-zero so that it acts. JAX runs
SLA through its reference (impl "xla", its CPU path) and int8 SLA in Pallas
interpret mode; weights cross through models/jax_import.wan_params_to_state_dict
in the loop and the scan layout.

Tolerances, as max|port - jax| / max|jax|:
  - 1e-4 where every value stays f32 (attn_mode dense at L < 2048);
  - 2^-8 (one bf16 step of the output scale) where attention runs through a
    kernel's bf16 contract in both packages (sla, sage_sla, flash): q/k/v and
    the attention output are rounded to bf16 there, and f32 values ~1e-7
    apart that straddle a rounding boundary land one bf16 ulp apart. A few
    such flips per layer (tests/test_torch_wan_kernels.py bounds them at 0.1%
    of the elements, one ulp each) reach the output as ~1e-3 of its scale.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from interpolated_diffusion_tpu.models.wan_dit import FrameCondProjector as JFrameCond
from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
from interpolated_diffusion_tpu_torch.models.wan_dit import FrameCondProjector, WanDiT

# the package's __init__ re-exports functions under the submodules' names
jbsa = importlib.import_module("interpolated_diffusion_tpu.kernels.block_sparse_attention")
TINY = dict(dim=48, n_layers=2, n_heads=4, ffn_dim=96, in_channels=4, out_channels=4,
            text_dim=32, sla_topk=0.5, sla_block=32, lora_rank=2, lora_alpha=8.0)
REL_TOL = 1e-4
BF16_TOL = 2.0 ** -8


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _nonzero_leaves(params, rng, scale=0.1):
    """Replace zero-initialised leaves (lora_B, proj_l, out) with noise."""
    flat = traverse_util.flatten_dict(params)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k[-1] == "lora_B" or "proj_l" in k or k[0] == "out" or not np.any(v):
            v = (rng.normal(size=v.shape) * scale).astype(np.float32)
        out[k] = v
    return traverse_util.unflatten_dict(out)


def _zeros(shapes):
    """numpy zeros for a tree of jax.eval_shape results (names and shapes only)."""
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)


def _inputs(seed, L_text=5, L_extra=3, T=3, H=16, W=16):
    r = np.random.default_rng(seed)
    lat = r.normal(size=(2, TINY["in_channels"], T, H, W)).astype(np.float32)
    t = np.array([999, 111], np.int32)
    ctx = r.normal(size=(2, L_text, TINY["text_dim"])).astype(np.float32)
    fi = np.array([[0, 7, 20], [2, 3, 15]], np.int32)[:, :T]
    extra = r.normal(size=(2, L_extra, TINY["text_dim"])).astype(np.float32)
    return lat, t, ctx, fi, extra


def _jax_model(attn_mode, layer_mode="loop", **over):
    cfg = dict(TINY, **over)
    return JWanDiT(attn_mode=attn_mode, layer_mode=layer_mode, dtype=jnp.float32, **cfg)


def _port_model(attn_mode, sd, **over):
    cfg = dict(TINY, **over)
    m = WanDiT(attn_mode=attn_mode, extra_context=True, **cfg).eval()
    m.load_state_dict(sd, strict=True)
    return m


def _run_pair(attn_mode, layer_mode, seed, **over):
    lat, t, ctx, fi, extra = _inputs(seed, **{k: v for k, v in over.items()
                                              if k in ("T", "H", "W")})
    model_over = {k: v for k, v in over.items() if k not in ("T", "H", "W")}
    jm = _jax_model(attn_mode, layer_mode, **model_over)
    args = tuple(map(jnp.asarray, (lat, t, ctx, fi, extra)))
    params = jm.init(jax.random.PRNGKey(seed), *args)["params"]
    params = _nonzero_leaves(params, np.random.default_rng(seed + 100))
    # op by op: under jit XLA may keep bf16 intermediates in f32 (excess
    # precision), which moves the rounding points the port reproduces
    ref = jm.apply({"params": params}, *args)
    sd, _ = wan_params_to_state_dict(params)
    pm = _port_model(attn_mode, sd, **model_over)
    with torch.inference_mode():
        out = pm(torch.tensor(lat), torch.tensor(t), torch.tensor(ctx), torch.tensor(fi),
                 torch.tensor(extra))
    return out, np.asarray(ref)


@pytest.mark.parametrize("attn_mode,tol", [("dense", REL_TOL), ("sla", BF16_TOL),
                                           ("sage_sla", BF16_TOL)])
def test_wan_dit_matches_jax(attn_mode, tol):
    out, ref = _run_pair(attn_mode, "loop", seed=1)
    assert out.shape == ref.shape == (2, 4, 3, 16, 16) and out.dtype == torch.float32
    assert rel_err(out, ref) <= tol, rel_err(out, ref)


def test_wan_dit_scan_layout_weights():
    """Weights from the trainer's default scan layout (blocks/block stacked on
    axis 0) convert to the same model as the loop layout (dense attention, so
    that the f32 tolerance holds)."""
    out, ref = _run_pair("dense", "scan", seed=2)
    assert rel_err(out, ref) <= REL_TOL, rel_err(out, ref)


def test_wan_dit_flash_dispatch(monkeypatch):
    """At L >= 2048 every attention (here self and cross, attn_mode dense)
    goes through flash_attention: the JAX side through the Pallas kernel in
    interpret mode (patched in for this test only), the port through its
    flash wrapper, whose CPU path is the plain twin. L = 1 x 32 x 64 = 2048."""
    monkeypatch.setattr(jbsa, "flash_attention",
                        functools.partial(jbsa.flash_attention, interpret=True))
    before = bsa.flash_attention.launches
    calls = []
    real = bsa.flash_attention_fwd
    monkeypatch.setattr(bsa, "flash_attention_fwd",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    out, ref = _run_pair("dense", "loop", seed=3, n_layers=1, lora_rank=0, T=1, H=64, W=128)
    assert calls == [(8, 2048, 12), (8, 2048, 12)]  # self- and cross-attention, B*H = 8
    assert bsa.flash_attention.launches == before   # CPU: the twin, no kernel launch
    assert rel_err(out, ref) <= BF16_TOL, rel_err(out, ref)


def test_frame_cond_projector_matches_jax():
    r = np.random.default_rng(4)
    feat = r.uniform(size=(2, 5, 5)).astype(np.float32)
    jm = JFrameCond(feat_dim=5, text_dim=32)
    params = _nonzero_leaves(jm.init(jax.random.PRNGKey(0), jnp.asarray(feat))["params"], r)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(feat)))
    wan_shapes = jax.eval_shape(_jax_model("dense").init, jax.random.PRNGKey(0),
                                *map(jnp.asarray, _inputs(0)))["params"]
    _, fc_sd = wan_params_to_state_dict(_zeros(wan_shapes), frame_cond=params)
    pm = FrameCondProjector(feat_dim=5, text_dim=32)
    pm.load_state_dict(fc_sd, strict=True)
    with torch.inference_mode():
        out = pm(torch.tensor(feat))
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_build_wan_matches_jax_build_and_lora_join():
    """train/wansynth_common.build_wan makes, from the trainers' argument
    names, the model whose state the JAX build_wan's parameters convert to
    (same names and shapes); the zero-initialised leaves are zero unless
    zero_init_scale > 0; the runtime-LoRA join restores the whole state."""
    import types

    from interpolated_diffusion_tpu.train.wansynth_common import build_wan as j_build_wan
    from interpolated_diffusion_tpu_torch.train.wansynth_common import (
        build_wan, merged_wan_params, split_lora_state_dict)

    args = types.SimpleNamespace(
        wan_dim=48, wan_layers=2, wan_heads=4, wan_ffn=96, latent_c=4, text_dim=32,
        attn_mode="sla", sla_topk=0.5, sla_block=32, lora_rank=2, lora_alpha=8.0,
        lora_form="runtime", lora_targets="attn,ffn", ffn_mode="dense", use_remat=0,
        layer_mode="loop", frame_cond=1, frame_cond_dim=5)
    lat, t, ctx, fi, extra = map(jnp.asarray, _inputs(0))
    shapes = jax.eval_shape(j_build_wan(args, bf16=False).init, jax.random.PRNGKey(0), lat, t,
                            ctx, fi, extra)["params"]
    ref_sd, _ = wan_params_to_state_dict(_zeros(shapes))
    for scale in (0.0, 0.01):
        model, fc = build_wan(args, bf16=False, generator=torch.Generator().manual_seed(0),
                              zero_init_scale=scale)
        sd = model.state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in ref_sd.items()}
        zero_leaves = [v for k, v in sd.items() if k.endswith(("lora_B", "proj_l.weight"))]
        zero_leaves += [fc.out.weight]
        assert all(bool((v == 0).all()) == (scale == 0) for v in zero_leaves)
    lora, base = split_lora_state_dict(sd)
    assert len(lora) == 2 * 10 * args.wan_layers  # A and B of 8 attention + 2 FFN Linears
    assert all(k.endswith(("lora_A", "lora_B")) for k in lora)
    merged = merged_wan_params({"lora": lora}, base, args)
    assert merged.keys() == sd.keys()
    model.load_state_dict(merged, strict=True)
