"""The port's video interpolators and selector against the JAX package, on the
CPU in f32, on weights converted from JAX params
(models/jax_import.module_tree_to_state_dict): the flow interpolator (with
the stride-2 "SAME" conv at 60x104 and at 9x9), the conv and token
straighteners, the Sinkhorn warp interpolator (golden `sk/`, the phase-
correlation shift, windows with tails in both directions and overlapping
windows, learned tau and dustbin, forward-backward confidence), the video
keyframe selector (the JAX fixture runs/wansynth_debug/flow is read in
tests/test_torch_jax_checkpoint.py).

Tolerances: models 1e-4 of the output's scale; the phase-correlation shifts
and the chosen angle are discrete and must be equal (inputs with one clear
peak: whole-token translations). The JAX params come from the modules' own
init shapes (`jax.eval_shape`, no init run) filled from a seeded numpy
generator, and the JAX side runs under one jit per model: op by op, flax
spends its time compiling every primitive (the Sinkhorn model ~30 s).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from interpolated_diffusion_tpu.models import flow_interpolator as jfi
from interpolated_diffusion_tpu.models import sinkhorn_warp as jsw
from interpolated_diffusion_tpu.models import straightener as jst
from interpolated_diffusion_tpu.models import video_selector as jvs
from interpolated_diffusion_tpu_torch.models import flow_interpolator as pfi
from interpolated_diffusion_tpu_torch.models import sinkhorn_warp as psw
from interpolated_diffusion_tpu_torch.models import straightener as pst
from interpolated_diffusion_tpu_torch.models import video_selector as pvs
from interpolated_diffusion_tpu_torch.models.jax_import import module_tree_to_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = 1e-4


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def jparams(jm, *args, seed=0, method=None, **kwargs):
    """Params of flax module `jm` in the shapes its init would make, drawn
    from numpy: Dense / Conv kernels N(0, 1/fan_in), LayerNorm scales
    1 + N(0, 0.1^2), every other leaf (biases, zero-initialised heads, tau,
    the dustbin, embeddings) N(0, 0.1^2), so that no leaf is zero. Arrays
    and dicts of them are traced; other arguments (T, a spatial shape) stay
    Python values."""
    traced = [i for i, a in enumerate(args) if isinstance(a, (np.ndarray, jax.Array, dict))]

    def init(key, *arrays):
        full = list(args)
        for i, a in zip(traced, arrays):
            full[i] = a
        return nn.Module.init(jm, key, *full, method=method, **kwargs)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *[args[i] for i in traced])["params"]
    r = np.random.default_rng(seed)
    out = {}
    for k, v in traverse_util.flatten_dict(shapes).items():
        x = r.normal(size=v.shape)
        if k[-1] == "kernel":
            x = x / np.sqrt(np.prod(v.shape[:-1]))
        elif k[-1] == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[k] = x.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def japply(jm, params, *args, method=None):
    """jm.apply under one jit (f32: the same arithmetic as op by op)."""
    fn = jax.jit(functools.partial(jm.apply, method=method))
    return fn({"params": params}, *map(jnp.asarray, args))


def port(model, params):
    model.load_state_dict(module_tree_to_state_dict(params), strict=True)
    return model.eval()


def test_same_padding_matches_flax():
    """flax's SAME on a 3x3 stride-2 conv pads (0, 1) on an even side and
    (1, 1) on an odd one; stride 1 pads (1, 1)."""
    assert pfi.same_pads(60, 3, 2) == (0, 1) and pfi.same_pads(104, 3, 2) == (0, 1)
    assert pfi.same_pads(9, 3, 2) == (1, 1) and pfi.same_pads(9, 3, 1) == (1, 1)


@pytest.mark.parametrize("hw,cv", [((60, 104), True), ((9, 9), False)])
def test_flow_predictor_stride2_matches_jax(hw, cv):
    """LatentFlowPredictor (enc2 is the stride-2 conv) at the Wan latent size
    and at an odd size: all five outputs."""
    r = np.random.default_rng(1)
    C = 4
    z0, z1 = (r.normal(size=(1, C, *hw)).astype(np.float32) for _ in range(2))
    gap = np.array([[3.0]], np.float32)
    jm = jfi.LatentFlowPredictor(in_channels=C, base_channels=4, cond_channels=1,
                                 time_mask=True, use_cost_volume=cv)
    params = jparams(jm, z0, z1, gap)
    ref = japply(jm, params, z0, z1, gap)
    pm = port(pfi.LatentFlowPredictor(C, 4, cond_channels=1, time_mask=True,
                                      use_cost_volume=cv), params)
    with torch.no_grad():
        out = pm(*map(torch.tensor, (z0, z1, gap)))
    for o, r_ in zip(out, ref):
        assert rel(o, r_) <= MODEL_TOL


@pytest.mark.parametrize("opts", [dict(time_mask=True, gap_cond=True, use_cost_volume=True),
                                  dict(residual_blocks=0)])
def test_flow_interpolator_matches_jax(opts):
    r = np.random.default_rng(2)
    lat = r.normal(size=(2, 7, 4, 8, 12)).astype(np.float32)
    idx = np.array([[0, 2, 6], [0, 5, 6]], np.int32)
    jm = jfi.LatentFlowInterpolator(in_channels=4, base_channels=8, **opts)
    params = jparams(jm, lat, idx)
    ref_out, ref_conf = japply(jm, params, lat, idx)
    pm = port(pfi.LatentFlowInterpolator(4, 8, **opts), params)
    with torch.no_grad():
        out, conf = pm(torch.tensor(lat), torch.tensor(idx).long())
    assert rel(out, ref_out) <= MODEL_TOL and rel(conf, ref_conf) <= MODEL_TOL
    assert torch.equal(out[0, 2], torch.tensor(lat[0, 2]))     # anchors exact


@pytest.mark.parametrize("arch", ["conv", "token"])
def test_straighteners_match_jax(arch):
    r = np.random.default_rng(5)
    z0, z1 = (r.normal(size=(2, 4, 8, 12)).astype(np.float32) for _ in range(2))
    alpha = np.array([0.25, 0.6], np.float32)
    if arch == "conv":
        jm = jst.LatentStraightener(in_channels=4, hidden_channels=8, blocks=2)
        pm = pst.LatentStraightener(4, 8, 2)
    else:
        jm = jst.LatentStraightenerTokenTransformer(in_channels=4, patch_size=2, d_model=32,
                                                    n_layers=2, n_heads=2, d_ff=64)
        pm = pst.LatentStraightenerTokenTransformer(4, 2, 32, 2, 2, 64)
    params = jparams(jm, z0)
    pm = port(pm, params)
    ref_z, ref_s = japply(jm, params, z0, z1, alpha, method="interpolate_pair")
    ref_ae = japply(jm, params, z0)
    with torch.no_grad():
        z, s = pm.interpolate_pair(*map(torch.tensor, (z0, z1, alpha)))
        ae = pm(torch.tensor(z0))
    assert max(rel(z, ref_z), rel(s, ref_s), rel(ae, ref_ae)) <= MODEL_TOL


def test_sinkhorn_log_matches_golden_and_jax():
    g = np.load(os.path.join(ROOT, "tests", "golden", "reference_golden.npz"))
    out = psw.sinkhorn_log(torch.tensor(g["sk/logits"]), 12)
    np.testing.assert_allclose(out.numpy(), g["sk/log_plan"], atol=1e-5)
    x = np.random.default_rng(7).normal(size=(3, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(psw.sinkhorn_log(torch.tensor(x), 5).numpy(),
                               np.asarray(jsw.sinkhorn_log(jnp.asarray(x), 5)), atol=1e-5)


def _rolled(T=5, C=4, H=8, W=10, patch=2, seed=8):
    """A pattern moving right one token (patch pixels) per frame."""
    base = np.random.default_rng(seed).normal(size=(C, H, W)).astype(np.float32)
    return np.stack([np.roll(base, patch * t, axis=2) for t in range(T)])[None]


def test_phasecorr_shift_and_global_se2_choices_are_jax():
    """The peak shift of a whole-token translation, and the angle chosen by
    _global_se2 over the default angle list, equal JAX's."""
    m = psw.SinkhornWarpInterpolator(in_channels=4, patch_size=2)
    f, hp, wp = m.token_features(torch.tensor(_rolled(H=12, W=16)[0]))
    f0, f1 = f[[0, 1]], f[[3, 4]]
    a, b = f0.permute(0, 3, 1, 2), f1.permute(0, 3, 1, 2)
    dx, dy, peak = psw._phasecorr_shift(a, b)
    jdx, jdy, jpeak = jax.jit(jsw._phasecorr_shift)(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    assert dx.tolist() == np.asarray(jdx).tolist() == [-3.0, -3.0]
    assert dy.tolist() == np.asarray(jdy).tolist() == [0.0, 0.0]
    np.testing.assert_allclose(peak.numpy(), np.asarray(jpeak), atol=1e-5)
    theta, gdx, gdy = m._global_se2(f0, f1)
    jmod = jsw.SinkhornWarpInterpolator(in_channels=4, patch_size=2)
    jt, jx, jy = japply(jmod, {}, f0.numpy(), f1.numpy(),
                        method=jsw.SinkhornWarpInterpolator._global_se2)
    assert theta.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(gdx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(gdy.numpy(), np.asarray(jy), atol=1e-6)


@pytest.mark.parametrize("opts", [
    dict(global_mode="phasecorr", angles_deg=(-5.0, 0.0, 5.0), fb_sigma=2.0, learn_tau=True,
         learn_dustbin=True),
    dict(win_stride=2, global_mode="none", spatial_gamma=0.1, spatial_radius=2, d_match=4)])
def test_sinkhorn_interpolator_matches_jax(opts):
    """4 x 5 tokens, window 3: a tail of 1 row, one of 2 columns and the
    corner; then overlapping windows (stride 2); learned tau and dustbin."""
    lat = _rolled()
    idx = np.array([[0, 2, 4]], np.int32)
    kw = dict(in_channels=4, patch_size=2, win_size=3, sinkhorn_iters=6, **opts)
    jm = jsw.SinkhornWarpInterpolator(**kw)
    params = jparams(jm, lat, idx) if opts.get("learn_tau") else {}
    ref_out, ref_conf = japply(jm, params, lat, idx)
    pm = psw.SinkhornWarpInterpolator(**kw)
    if params:
        pm = port(pm, params)
    with torch.no_grad():
        out, conf = pm(torch.tensor(lat), torch.tensor(idx).long())
    assert rel(out, ref_out) <= MODEL_TOL and rel(conf, ref_conf) <= MODEL_TOL


def test_video_selector_matches_jax():
    r = np.random.default_rng(10)
    text = r.normal(size=(3, 5, 16)).astype(np.float32)
    level = np.array([[0.2], [0.5], [1.0]], np.float32)
    jm = jvs.VideoKeyframeSelector(T=9, d_model=32, d_cond=24, n_layers=2, n_heads=4, d_ff=64,
                                   pos_dim=16, use_level=True)
    cond = {"text_embed": jnp.asarray(text), "level": jnp.asarray(level)}
    params = jparams(jm, cond)
    ref = jax.jit(jm.apply)({"params": params}, cond)
    pm = port(pvs.VideoKeyframeSelector(9, 16, 32, 24, 2, 4, 64, 16, use_level=True), params)
    with torch.no_grad():
        out = pm({"text_embed": torch.tensor(text), "level": torch.tensor(level)})
    assert out.shape == (3, 9) and rel(out, ref) <= MODEL_TOL
