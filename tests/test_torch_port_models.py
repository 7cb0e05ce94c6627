"""Port models (interpolated_diffusion_tpu_torch.models) against the JAX
flax modules on the same weights, and against the reference goldens.

JAX params go to the port through models/jax_import.params_to_state_dict;
the JAX package's convert_state_dict takes them back. The JAX block policy is
set the way the JAX package reads it (ID_TPU_SMALL_ATTN); on the CPU its
kernels run their XLA twins. Tolerance: f32 atol 2e-5 / rtol 1e-4 (the
golden tolerance of tests/test_torch_import.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.models import encoders as jenc
from interpolated_diffusion_tpu.models import transformer as jtr
from interpolated_diffusion_tpu.models.torch_import import convert_state_dict
from interpolated_diffusion_tpu_torch.models import denoisers, jax_import, transformer
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_models.npz")
JAX_POLICY = {"fused": "fused", "block": "block", "dense": "none"}

KW = dict(d_model=64, n_layers=2, n_heads=8, d_ff=128, d_cond=32, data_dim=2,
          maze_channels=(8, 16))
B, T_, K, G = 3, 64, 8, 11


def close(a, b, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def _np_tree(t):
    return jax.tree.map(lambda a: np.asarray(a), t)


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    inner = np.stack([np.sort(r.choice(np.arange(1, T_ - 1), K - 2, replace=False))
                      for _ in range(B)])
    idx = np.concatenate([np.zeros((B, 1), int), inner, np.full((B, 1), T_ - 1)], 1)
    return dict(
        z=r.normal(size=(B, K, 2)).astype(np.float32), t=np.array([99, 40, 3]),
        idx=idx, known=r.uniform(size=(B, K, 2)) < 0.3,
        occ=(r.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32),
        sg=r.uniform(size=(B, 4)).astype(np.float32),
        x=r.normal(size=(B, T_, 2)).astype(np.float32), s=np.array([3, 2, 1]),
        mask=(r.uniform(size=(B, T_, 2)) < 0.4).astype(np.float32))


def _jax_models(inp, seed=0):
    kp = jden.KeypointDenoiser(**KW)
    it = jden.InterpLevelDenoiser(**KW, mask_channels=2)
    cond = {"occ": jnp.asarray(inp["occ"]), "start_goal": jnp.asarray(inp["sg"])}
    kp_p = kp.init(jax.random.PRNGKey(seed), jnp.asarray(inp["z"]), jnp.asarray(inp["t"]),
                   jnp.asarray(inp["idx"]), jnp.asarray(inp["known"]), cond, T_)["params"]
    it_p = it.init(jax.random.PRNGKey(seed + 1), jnp.asarray(inp["x"]), jnp.asarray(inp["s"]),
                   jnp.asarray(inp["mask"]), cond)["params"]
    it_p = _np_tree(it_p)
    # a nonzero Stage-2 head (its zero init would hide the transformer)
    it_p["out"]["kernel"] = np.random.default_rng(seed).normal(
        size=it_p["out"]["kernel"].shape).astype(np.float32) * 0.1
    return kp, _np_tree(kp_p), it, it_p, cond


def _port(cls, sd, **kw):
    m = build_model(cls, generator=torch.Generator().manual_seed(0), **kw)
    m.load_state_dict(sd, strict=True)
    return m.eval()


def _torch_cond(inp):
    return {"occ": torch.tensor(inp["occ"]), "start_goal": torch.tensor(inp["sg"])}


def test_maze_condition_encoder():
    inp = _inputs()
    kp, kp_p, _, _, cond = _jax_models(inp)
    enc = jenc.MazeConditionEncoder(d_cond=KW["d_cond"], maze_channels=KW["maze_channels"])
    ref = enc.apply({"params": kp_p["cond_enc"]}, cond)
    port = _port(denoisers.KeypointDenoiser, params_to_state_dict(kp_p, "keypoint"), **KW)
    with torch.no_grad():
        close(port.cond_enc(_torch_cond(inp)), ref)


def _block_sd(p):
    sd = {}
    jax_import._block(sd, "", p)
    return sd


@pytest.mark.parametrize("policy", ["fused", "block", "dense"])
@pytest.mark.parametrize("film", [True, False])
def test_transformer_block_policies(policy, film, monkeypatch):
    """H*L = 8*64 = 512 > 256, so "fused" reaches small_mha_packed."""
    r = np.random.default_rng(1)
    x = r.normal(size=(4, 64, 64)).astype(np.float32)
    cond = r.normal(size=(4, 32)).astype(np.float32) if film else None
    blk = jtr.TransformerBlock(d_model=64, n_heads=8, d_ff=128, use_film=film)
    p = _np_tree(blk.init(jax.random.PRNGKey(2), jnp.asarray(x),
                          None if cond is None else jnp.asarray(cond))["params"])
    monkeypatch.setenv("ID_TPU_SMALL_ATTN", JAX_POLICY[policy])
    ref = blk.apply({"params": p}, jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    port = transformer.TransformerBlock(64, 8, 128, d_cond=32, use_film=film,
                                        attn_policy=policy)
    port.load_state_dict(_block_sd(p), strict=True)
    with torch.no_grad():
        out = port(torch.tensor(x), None if cond is None else torch.tensor(cond))
    close(out, ref)


@pytest.mark.parametrize("policy", ["fused", "block"])
def test_keypoint_denoiser(policy, monkeypatch):
    inp = _inputs(2)
    kp, kp_p, _, _, cond = _jax_models(inp, seed=2)
    monkeypatch.setenv("ID_TPU_SMALL_ATTN", JAX_POLICY[policy])
    ref = kp.apply({"params": kp_p}, jnp.asarray(inp["z"]), jnp.asarray(inp["t"]),
                   jnp.asarray(inp["idx"]), jnp.asarray(inp["known"]), cond, T_)
    port = _port(denoisers.KeypointDenoiser, params_to_state_dict(kp_p, "keypoint"),
                 attn_policy=policy, **KW)
    with torch.no_grad():
        out = port(torch.tensor(inp["z"]), torch.tensor(inp["t"]), torch.tensor(inp["idx"]),
                   torch.tensor(inp["known"]), _torch_cond(inp), T_)
    assert out.dtype == torch.float32
    close(out, ref)


@pytest.mark.parametrize("policy", ["fused", "block"])
def test_interp_level_denoiser(policy, monkeypatch):
    inp = _inputs(3)
    _, _, it, it_p, cond = _jax_models(inp, seed=3)
    monkeypatch.setenv("ID_TPU_SMALL_ATTN", JAX_POLICY[policy])
    ref = it.apply({"params": it_p}, jnp.asarray(inp["x"]), jnp.asarray(inp["s"]),
                   jnp.asarray(inp["mask"]), cond)
    port = _port(denoisers.InterpLevelDenoiser, params_to_state_dict(it_p, "interp"),
                 mask_channels=2, attn_policy=policy, **KW)
    with torch.no_grad():
        out = port(torch.tensor(inp["x"]), torch.tensor(inp["s"]), torch.tensor(inp["mask"]),
                   _torch_cond(inp))
        # a hoisted cond_vec gives the same output as the in-model encoder
        c = dict(_torch_cond(inp), cond_vec=port.cond_enc(_torch_cond(inp)))
        out2 = port(torch.tensor(inp["x"]), torch.tensor(inp["s"]), torch.tensor(inp["mask"]), c)
    close(out, ref)
    assert torch.equal(out, out2)


@pytest.mark.parametrize("kind", ["keypoint", "interp"])
def test_state_dict_round_trip_is_exact(kind):
    inp = _inputs()
    _, kp_p, _, it_p, _ = _jax_models(inp)
    p = kp_p if kind == "keypoint" else it_p
    back = convert_state_dict(params_to_state_dict(p, kind), kind)
    la, ta = jax.tree.flatten(back)
    lb, tb = jax.tree.flatten(p)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("model golden file missing (run scripts/make_golden_reference.py)")
    return np.load(GOLDEN)


def _sd(g, prefix):
    p = f"{prefix}/sd/"
    return {k[len(p):]: torch.tensor(g[k]) for k in g.files if k.startswith(p)}


GOLD_KW = dict(d_model=64, n_layers=2, n_heads=4, d_ff=128, d_cond=32, data_dim=2,
               maze_channels=(8, 16))


def test_golden_keypoint_denoiser(golden):
    g = golden
    port = _port(denoisers.KeypointDenoiser, _sd(g, "kp"), kp_feat_dim=3, **GOLD_KW)
    with torch.no_grad():
        eps = port(torch.tensor(g["kp/in/z_t"]), torch.tensor(g["kp/in/t"]),
                   torch.tensor(g["kp/in/idx"]), torch.tensor(g["kp/in/known"]),
                   {"occ": torch.tensor(g["kp/in/occ"]),
                    "start_goal": torch.tensor(g["kp/in/start_goal"]),
                    "kp_feat": torch.tensor(g["kp/in/kp_feat"])}, 24)
    close(eps, g["kp/out"])


def test_golden_interp_denoiser(golden):
    g = golden
    port = _port(denoisers.InterpLevelDenoiser, _sd(g, "it"), mask_channels=2, **GOLD_KW)
    with torch.no_grad():
        out = port(torch.tensor(g["it/in/x_s"]), torch.tensor(g["it/in/s"]),
                   torch.tensor(g["it/in/mask"]),
                   {"occ": torch.tensor(g["kp/in/occ"]),
                    "start_goal": torch.tensor(g["kp/in/start_goal"])})
    close(out, g["it/out"])


def test_build_model_is_seeded_and_leaves_global_rng():
    state = torch.get_rng_state()
    a = build_model(denoisers.InterpLevelDenoiser, generator=torch.Generator().manual_seed(5),
                    mask_channels=2, **KW)
    b = build_model(denoisers.InterpLevelDenoiser, generator=torch.Generator().manual_seed(5),
                    mask_channels=2, **KW)
    assert torch.equal(torch.get_rng_state(), state)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not a.out.weight.any()  # zero-init Stage-2 head, as in JAX
    ln = a.transformer.layers[0].norm1
    assert torch.equal(ln.weight, torch.ones_like(ln.weight)) and not ln.bias.any()
    with pytest.raises(ValueError):
        a.set_attn_policy("full")
