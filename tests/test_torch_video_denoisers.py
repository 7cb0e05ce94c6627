"""The port's video token denoisers and text encoder
(models/video_denoisers.py, models/encoders.TextConditionEncoder) against the
original PyTorch reference's recordings (tests/golden/reference_models.npz,
groups vk/ and vi/) and against the JAX modules on converted weights, in f32
on the CPU. T*N = 24 tokens here, so the transformer dispatch takes the
block / packed kernels' plain twins under the "block" and "fused" policies
(as it would take the kernels on the card) and plain attention under
"dense"; each is held to JAX.

Tolerances as max|port - ref| / max|ref|: 1e-4 against JAX (the same f32
arithmetic, other sum order), the golden tests' 3e-5 + 1e-4 relative against
the reference recordings.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models.encoders import TextConditionEncoder as JText
from interpolated_diffusion_tpu.models.video_denoisers import (
    VideoTokenInterpLevelDenoiser as JInterp, VideoTokenKeypointDenoiser as JKeypoint)
from interpolated_diffusion_tpu_torch.models.encoders import TextConditionEncoder
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.models.video_denoisers import (
    VideoTokenInterpLevelDenoiser, VideoTokenKeypointDenoiser, sincos_2d)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_models.npz")
KW = dict(d_model=48, n_layers=2, n_heads=4, d_ff=96, d_cond=24, data_dim=20)
TOL = 1e-4


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def sd_of(g, prefix):
    p = f"{prefix}/sd/"
    return {k[len(p):]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith(p)}


def test_keypoint_denoiser_matches_the_reference_recording(g):
    model = VideoTokenKeypointDenoiser(**KW, text_dim=32).eval()
    model.load_state_dict(sd_of(g, "vk"), strict=True)
    with torch.no_grad():
        out = model(torch.tensor(g["vk/in/z"]), torch.tensor(g["vk/in/t"]),
                    torch.tensor(g["vk/in/idx"]), {"text_embed": torch.tensor(g["vk/in/text"])},
                    10, (2, 3))
    np.testing.assert_allclose(out.numpy(), g["vk/out"], atol=3e-5, rtol=1e-4)


def test_interp_denoiser_matches_the_reference_recording(g):
    model = VideoTokenInterpLevelDenoiser(**KW, text_dim=32, mask_channels=2).eval()
    model.load_state_dict(sd_of(g, "vi"), strict=True)
    with torch.no_grad():
        out = model(torch.tensor(g["vi/in/x"]), torch.tensor(g["vi/in/s"]),
                    torch.tensor(g["vi/in/mask"]), {"text_embed": torch.tensor(g["vk/in/text"])},
                    (2, 3))
    np.testing.assert_allclose(out.numpy(), g["vi/out"], atol=3e-5, rtol=1e-4)


def _nonzero_out(params, rng):
    """The zero-initialised head made non-zero, so that the output tests it."""
    params = jax.tree_util.tree_map(np.asarray, params)
    params["out"] = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
                     for k, v in params["out"].items()}
    return params


@pytest.mark.parametrize("policy", ["fused", "block", "dense"])
def test_keypoint_denoiser_matches_jax(policy):
    rng = np.random.default_rng(1)
    z = rng.normal(size=(3, 4, 6, 20)).astype(np.float32)
    t = np.array([3, 500, 999], np.int32)
    idx = np.array([[0, 3, 6, 9], [1, 2, 5, 9], [0, 4, 5, 8]], np.int32)
    text = rng.normal(size=(3, 7, 32)).astype(np.float32)
    jm = JKeypoint(**KW, use_start_goal=False)
    args = (jnp.asarray(z), jnp.asarray(t), jnp.asarray(idx), {"text_embed": jnp.asarray(text)},
            10, (2, 3))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), *args)["params"])
    ref = jm.apply({"params": params}, *args)
    pm = VideoTokenKeypointDenoiser(**KW, text_dim=32, attn_policy=policy).eval()
    pm.load_state_dict(params_to_state_dict(params, "video_keypoint"), strict=True)
    with torch.no_grad():
        out = pm(torch.tensor(z), torch.tensor(t), torch.tensor(idx),
                 {"text_embed": torch.tensor(text)}, 10, (2, 3))
    assert rel_err(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("policy", ["fused", "block", "dense"])
def test_interp_denoiser_matches_jax(policy):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 6, 20)).astype(np.float32)
    s = np.array([1, 2], np.int32)
    mask = (rng.uniform(size=(2, 5, 6, 3)) < 0.5).astype(np.float32)
    text = rng.normal(size=(2, 4, 32)).astype(np.float32)
    jm = JInterp(**KW, use_start_goal=False, mask_channels=3)
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(mask), {"text_embed": jnp.asarray(text)},
            (2, 3))
    params = _nonzero_out(jm.init(jax.random.PRNGKey(1), *args)["params"], rng)
    ref = jm.apply({"params": params}, *args)
    pm = VideoTokenInterpLevelDenoiser(**KW, text_dim=32, mask_channels=3,
                                       attn_policy=policy).eval()
    pm.load_state_dict(params_to_state_dict(params, "video_interp"), strict=True)
    with torch.no_grad():
        out = pm(torch.tensor(x), torch.tensor(s), torch.tensor(mask),
                 {"text_embed": torch.tensor(text)}, (2, 3))
    assert rel_err(out.numpy(), ref) <= TOL
    with pytest.raises(ValueError, match="channels"):
        pm(torch.tensor(x), torch.tensor(s), torch.tensor(mask[..., :2]), None, (2, 3))


def test_text_encoder_and_unconditioned_paths_match_jax():
    rng = np.random.default_rng(3)
    text = rng.normal(size=(2, 5, 16)).astype(np.float32)
    je = JText(d_cond=12)
    params = jax.tree_util.tree_map(np.asarray, je.init(jax.random.PRNGKey(2),
                                                        {"text_embed": jnp.asarray(text)})["params"])
    pe = TextConditionEncoder(16, 12)
    sd = {"proj.0.weight": params["fc1"]["kernel"].T, "proj.0.bias": params["fc1"]["bias"],
          "proj.2.weight": params["fc2"]["kernel"].T, "proj.2.bias": params["fc2"]["bias"]}
    pe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    for x in (text, text[:, 0]):       # [B, L, D] is pooled over L; [B, D] is taken as it is
        ref = je.apply({"params": params}, {"text_embed": jnp.asarray(x)})
        with torch.no_grad():
            assert rel_err(pe({"text_embed": torch.tensor(x)}).numpy(), ref) <= TOL
    with pytest.raises(ValueError, match="text_embed"):
        pe({})
    # no conditioning: a zero cond vector, as JAX's _cond_vec
    jm = JKeypoint(**KW, use_start_goal=False)
    z = rng.normal(size=(2, 3, 6, 20)).astype(np.float32)
    args = (jnp.asarray(z), jnp.asarray([1, 2]), jnp.asarray([[0, 2, 4], [1, 3, 4]]), None, 5,
            (2, 3))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), *args)["params"])
    pm = VideoTokenKeypointDenoiser(**KW).eval()
    pm.load_state_dict(params_to_state_dict(params, "video_keypoint"), strict=True)
    with torch.no_grad():
        out = pm(torch.tensor(z), torch.tensor([1, 2]), torch.tensor([[0, 2, 4], [1, 3, 4]]),
                 None, 5, (2, 3))
    assert rel_err(out.numpy(), jm.apply({"params": params}, *args)) <= TOL


@pytest.mark.parametrize("h,w,dim", [(2, 3, 48), (3, 4, 9)])
def test_sincos_2d_matches_jax(h, w, dim):
    from interpolated_diffusion_tpu.models.video_denoisers import sincos_2d as jsincos

    assert rel_err(sincos_2d(h, w, dim).numpy(), jsincos(h, w, dim)) <= 1e-6
