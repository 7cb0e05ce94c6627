"""The port's frame VAEs against the JAX package on the CPU, in f32:
models/sd_vae.py (SDVAE, its parts, the diffusers conversion and the
safetensors loader) and models/frame_vae.py (FrameVAE; TorchFrameVAE's
ImportError without diffusers).

The JAX params come from the modules' own init shapes, drawn from a seeded
numpy generator (test_torch_interpolators.jparams), and reach the port
through the diffusers layout (sd_vae.export_sd_vae_state_dict) or the flax
names (jax_import.module_tree_to_state_dict). The SDVAE is narrow (two
levels of 32 channels) so that the JAX side compiles in seconds; a
ResnetBlock with a channel change and a GroupNorm of 64 channels (2 per
group) cover what a 32-channel GroupNorm and equal widths do not.

Tolerances: 1e-4 of the output's scale (max|port - jax| / max|jax|) for
forwards; conversions exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from interpolated_diffusion_tpu.models import frame_vae as jfv
from interpolated_diffusion_tpu.models import sd_vae as jsd
from interpolated_diffusion_tpu_torch.models import frame_vae as pfv
from interpolated_diffusion_tpu_torch.models import sd_vae as psd
from interpolated_diffusion_tpu_torch.models.jax_import import (module_tree_to_state_dict,
                                                                sd_vae_params_to_state_dict)
from interpolated_diffusion_tpu_torch.utils.safetensors import write_safetensors
from test_torch_interpolators import japply, jparams, rel

NARROW = dict(block_out=(32, 32), layers_per_block=2, latent_channels=4)
TOL = 1e-4


def _frames(seed, B=1, T=2, hw=16):
    return np.random.default_rng(seed).uniform(size=(B, T, 3, hw, hw)).astype(np.float32)


@pytest.fixture(scope="module")
def narrow():
    frames = _frames(0)
    jm = jsd.SDVAE(**NARROW)
    params = jparams(jm, frames, seed=1)
    pm = psd.SDVAE(**NARROW)
    pm.load_state_dict(sd_vae_params_to_state_dict(params), strict=True)
    return jm, params, pm.eval(), frames


def test_group_norm_matches_flax():
    """32 groups of 2 channels, eps 1e-6, flax's E[x^2] - mu^2 variance; a
    large mean makes a two-pass variance differ visibly."""
    x = (np.random.default_rng(2).normal(size=(2, 5, 7, 64)) * 3 + 20).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=32, epsilon=1e-6)
    params = jparams(jm, x)
    ref = japply(jm, params, x)
    pm = psd.GroupNorm(64)
    pm.load_state_dict({"weight": torch.tensor(params["scale"]),
                        "bias": torch.tensor(params["bias"])})
    with torch.no_grad():
        out = pm(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert rel(out, ref) <= TOL


def _part_state_dict(part, params):
    """One part's flax params -> its diffusers-named state dict."""
    conv = lambda p: (p["kernel"].transpose(3, 2, 0, 1), p["bias"])
    sd = {}
    if part == "resnet":
        for n in ("norm1", "norm2"):
            sd[f"{n}.weight"], sd[f"{n}.bias"] = params[n]["scale"], params[n]["bias"]
        for n in ("conv1", "conv2", "conv_shortcut"):
            sd[f"{n}.weight"], sd[f"{n}.bias"] = conv(params[n])
    elif part == "attn":
        sd["group_norm.weight"] = params["group_norm"]["scale"]
        sd["group_norm.bias"] = params["group_norm"]["bias"]
        for n, m in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
            sd[f"{m}.weight"], sd[f"{m}.bias"] = params[n]["kernel"].T, params[n]["bias"]
    else:
        sd["conv.weight"], sd["conv.bias"] = conv(params["conv"])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("part", ["resnet", "attn", "down", "up"])
def test_sd_vae_parts_match_jax(part):
    """ResnetBlock 32 -> 64 (conv_shortcut), the mid-block attention, the
    (0, 1, 0, 1)-padded VALID stride-2 conv, and the nearest 2x upsample."""
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 32)).astype(np.float32)
    jm, pm = {"resnet": (jsd.ResnetBlock(64), psd.ResnetBlock(32, 64)),
              "attn": (jsd.AttnBlock(), psd.AttnBlock(32)),
              "down": (jsd.Downsample(32), psd.Downsample(32)),
              "up": (jsd.Upsample(32), psd.Upsample(32))}[part]
    params = jparams(jm, x, seed=4)
    ref = japply(jm, params, x)
    pm.load_state_dict(_part_state_dict(part, params), strict=True)
    with torch.no_grad():
        out = pm(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape and rel(out, ref) <= TOL


def test_sd_vae_matches_jax_encode_decode(narrow):
    """Encode (the mean, and a sample on JAX's own normal draw) and decode of
    the narrow SDVAE: 16x16 frames -> 8x8 latents (two levels, one
    downsample)."""
    jm, params, pm, frames = narrow
    key = jax.random.PRNGKey(5)
    z_mean = japply(jm, params, frames, method=jsd.SDVAE.encode)
    z_samp = jax.jit(lambda p, f: jm.apply({"params": p}, f, key, method=jsd.SDVAE.encode))(
        params, jnp.asarray(frames))
    B, T, C, h, w = z_mean.shape
    noise = np.asarray(jax.random.normal(key, (B * T, h, w, C)))     # NHWC, as JAX draws it
    with torch.no_grad():
        ft = torch.tensor(frames)
        p_mean = pm.encode(ft)
        p_samp = pm.encode(ft, noise=torch.tensor(noise).permute(0, 3, 1, 2))
        p_dec = pm.decode(torch.tensor(np.asarray(z_mean)))
    ref_dec = japply(jm, params, np.asarray(z_mean), method=jsd.SDVAE.decode)
    assert p_mean.shape == (1, 2, 4, 8, 8) and p_dec.shape == frames.shape
    assert rel(p_mean, z_mean) <= TOL and rel(p_samp, z_samp) <= TOL
    assert rel(p_dec, ref_dec) <= TOL
    assert not torch.allclose(p_mean, p_samp)
    assert float(p_dec.min()) >= 0.0 and float(p_dec.max()) <= 1.0


def test_sd_vae_conversion_round_trips_and_legacy_layout_loads(narrow, tmp_path):
    """convert(export(params)) is params exactly, as the JAX functions give
    it; the legacy 1x1-conv attention (query/key/value/proj_attn) gives the
    same state dict; a diffusers-named safetensors file loads with no
    renaming (extra keys dropped)."""
    _, params, pm, _ = narrow
    params_np = jax.tree_util.tree_map(np.asarray, params)
    sd = psd.export_sd_vae_state_dict(params_np)
    jsd_sd = jsd.export_sd_vae_state_dict(params_np)
    assert sd.keys() == jsd_sd.keys() and all(np.array_equal(sd[k], jsd_sd[k]) for k in sd)
    back = psd.convert_sd_vae_state_dict(sd, block_out=NARROW["block_out"])
    flat_a, flat_b = (traverse_util.flatten_dict(t) for t in (params_np, back))
    assert flat_a.keys() == flat_b.keys()
    assert all(np.array_equal(flat_a[k], flat_b[k]) for k in flat_a)
    assert set(sd) == set(pm.state_dict())                 # the module's own names
    legacy = {}
    for k, v in sd.items():
        m = k.replace(".to_q.", ".query.").replace(".to_k.", ".key.") \
             .replace(".to_v.", ".value.").replace(".to_out.0.", ".proj_attn.")
        legacy[m] = v[:, :, None, None] if (m != k and m.endswith(".weight")) else v
    canon = psd.canonical_state_dict(legacy, block_out=NARROW["block_out"])
    assert all(torch.equal(canon[k], torch.tensor(sd[k])) for k in sd)
    path = str(tmp_path / "vae.safetensors")
    write_safetensors(path, {**{k: torch.tensor(v) for k, v in legacy.items()},
                             "extra.unused": torch.zeros(2)})
    loaded = psd.load_sd_vae_safetensors(path, block_out=NARROW["block_out"])
    pm2 = psd.SDVAE(**NARROW)
    pm2.load_state_dict(loaded, strict=True)
    assert all(torch.equal(a, b) for a, b in zip(pm2.state_dict().values(),
                                                 pm.state_dict().values()))


def test_frame_vae_matches_jax():
    """FrameVAE: the stride-2 "SAME" convs (pad (0, 1) on even sides), the
    nearest 2x upsample, encode (mean and an injected draw) and decode."""
    frames = _frames(6, B=2, T=1, hw=16)
    jm = jfv.FrameVAE(base_ch=8)
    params = jparams(jm, frames, seed=7)
    pm = pfv.FrameVAE(base_ch=8)
    pm.load_state_dict(module_tree_to_state_dict(params), strict=True)
    key = jax.random.PRNGKey(8)
    z_mean = japply(jm, params, frames, method=jfv.FrameVAE.encode)
    z_samp = jax.jit(lambda p, f: jm.apply({"params": p}, f, key, method=jfv.FrameVAE.encode))(
        params, jnp.asarray(frames))
    dec = japply(jm, params, np.asarray(z_mean), method=jfv.FrameVAE.decode)
    B, T, C, h, w = z_mean.shape
    noise = np.asarray(jax.random.normal(key, (B * T, h, w, C)))
    with torch.no_grad():
        p_mean = pm.encode(torch.tensor(frames))
        p_samp = pm.encode(torch.tensor(frames), noise=torch.tensor(noise).permute(0, 3, 1, 2))
        p_dec = pm.decode(torch.tensor(np.asarray(z_mean)))
    assert p_mean.shape == (2, 1, 4, 2, 2) and p_dec.shape == frames.shape
    assert rel(p_mean, z_mean) <= TOL and rel(p_samp, z_samp) <= TOL and rel(p_dec, dec) <= TOL


def test_torch_frame_vae_needs_diffusers():
    try:
        import diffusers  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="diffusers"):
            pfv.TorchFrameVAE()
    else:
        pytest.skip("diffusers is installed: the wrapper would download weights")
