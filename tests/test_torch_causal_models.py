"""The port's causal transformer (models/transformer.py, models/denoisers.py)
against the JAX package's on the same weights, on the CPU in f32.

JAX computes causal attention three ways, all the same function: per head
(`dense_attention(causal=True)`), and packed as block-diagonal groups of G
heads under a kron(eye(G), tril) mask (`dense_attention_blockdiag`: all
heads under its "fused" / "full" policy at H*L <= 256, G = 2 under "group",
and its "block" policy falls through to the grouped pack, since its block
and packed kernels take no causal mask). The port computes per-head causal
attention under each of its policies. Tolerances: attention 3e-5 / 1e-4;
blocks, encoders and denoisers 2e-5 / 1e-4 (the golden tolerance of
tests/test_torch_import.py), also against the golden `itc/` recording of the
reference's causal denoiser.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.models import transformer as jtr
from interpolated_diffusion_tpu_torch.models import denoisers, jax_import, transformer
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_models.npz")
JAX_POLICY = {"fused": "fused", "block": "block", "dense": "none", "group": "group"}
KW = dict(d_model=64, n_layers=2, n_heads=4, d_ff=128, d_cond=32, data_dim=2,
          maze_channels=(8, 16))


def close(a, b, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


@pytest.mark.parametrize("jax_path", ["per_head", "blockdiag_all", "blockdiag_g2"])
def test_causal_dense_attention_matches_jax(jax_path):
    B, H, L, Dh = 3, 4, 16, 8
    r = np.random.default_rng(0)
    q, k, v = (r.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(3))
    if jax_path == "per_head":
        ref = jtr.dense_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    else:
        ref = jtr.dense_attention_blockdiag(*map(jnp.asarray, (q, k, v)), causal=True,
                                            group=None if jax_path == "blockdiag_all" else 2)
    packed = lambda a: torch.tensor(a).transpose(1, 2).reshape(B, L, H * Dh)
    out = transformer.dense_attention(packed(q), packed(k), packed(v), H, causal=True)
    close(out, np.asarray(ref).transpose(0, 2, 1, 3).reshape(B, L, H * Dh), atol=3e-5)
    # row 0 sees only key 0
    close(out[:, 0], packed(v)[:, 0], atol=3e-5)


def _block_sd(p):
    sd = {}
    jax_import._block(sd, "", p)
    return sd


@pytest.mark.parametrize("policy,jax_policy", [("fused", "fused"), ("block", "block"),
                                               ("dense", "dense"), ("fused", "group")])
def test_causal_block_and_encoder_match_jax(policy, jax_policy, monkeypatch):
    """H*L = 4*64 = 256: JAX packs all heads under fused, G = 2 under its
    group policy and under block (the block kernel refuses causal), per head
    under none."""
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 64, 64)).astype(np.float32)
    cond = r.normal(size=(2, 32)).astype(np.float32)
    blk = jtr.TransformerBlock(d_model=64, n_heads=4, d_ff=128, causal=True)
    p = _np_tree(blk.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(cond))["params"])
    enc = jtr.TransformerEncoder(d_model=64, n_layers=2, n_heads=4, d_ff=128, causal=True)
    pe = _np_tree(enc.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(cond))["params"])
    monkeypatch.setenv("ID_TPU_SMALL_ATTN", JAX_POLICY[jax_policy])
    ref_b = blk.apply({"params": p}, jnp.asarray(x), jnp.asarray(cond))
    ref_e = enc.apply({"params": pe}, jnp.asarray(x), jnp.asarray(cond))
    port_b = transformer.TransformerBlock(64, 4, 128, d_cond=32, attn_policy=policy, causal=True)
    port_b.load_state_dict(_block_sd(p), strict=True)
    port_e = transformer.TransformerEncoder(64, 2, 4, 128, d_cond=32, attn_policy=policy,
                                            causal=True)
    sd = {}
    jax_import._transformer(sd, pe)
    port_e.load_state_dict({k[len("transformer."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        close(port_b(torch.tensor(x), torch.tensor(cond)), ref_b)
        close(port_e(torch.tensor(x), torch.tensor(cond)), ref_e)


def _interp_pair(mc, seed):
    r = np.random.default_rng(seed)
    B, T, G = 3, 24, 9
    inp = dict(x=r.normal(size=(B, T, 2)).astype(np.float32), s=np.array([2, 1, 3]),
               mask=(r.uniform(size=(B, T, mc) if mc > 1 else (B, T)) < 0.4),
               occ=(r.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32),
               sg=r.uniform(size=(B, 4)).astype(np.float32))
    inp["mask"] = inp["mask"].astype(np.float32 if mc > 1 else bool)
    it = jden.InterpLevelDenoiser(**KW, mask_channels=mc, causal=True)
    cond = {"occ": jnp.asarray(inp["occ"]), "start_goal": jnp.asarray(inp["sg"])}
    p = _np_tree(it.init(jax.random.PRNGKey(seed), jnp.asarray(inp["x"]), jnp.asarray(inp["s"]),
                         jnp.asarray(inp["mask"]), cond)["params"])
    p["out"]["kernel"] = r.normal(size=p["out"]["kernel"].shape).astype(np.float32) * 0.1
    port = build_model(denoisers.InterpLevelDenoiser, generator=torch.Generator().manual_seed(0),
                       mask_channels=mc, causal=True, **KW).eval()
    port.load_state_dict(params_to_state_dict(p, "interp"), strict=True)
    return it, p, port, inp, cond


def _tcond(inp):
    return {"occ": torch.tensor(inp["occ"]), "start_goal": torch.tensor(inp["sg"])}


@pytest.mark.parametrize("mc", [2, 3])
@pytest.mark.parametrize("policy", ["fused", "block"])
def test_causal_interp_denoiser_matches_jax(mc, policy, monkeypatch):
    it, p, port, inp, cond = _interp_pair(mc, seed=mc)
    monkeypatch.setenv("ID_TPU_SMALL_ATTN", JAX_POLICY[policy])
    ref = it.apply({"params": p}, jnp.asarray(inp["x"]), jnp.asarray(inp["s"]),
                   jnp.asarray(inp["mask"]), cond)
    port.set_attn_policy(policy)
    with torch.no_grad():
        out = port(torch.tensor(inp["x"]), torch.tensor(inp["s"]), torch.tensor(inp["mask"]),
                   _tcond(inp))
    close(out, ref)


@pytest.mark.parametrize("policy", ["fused", "block", "dense"])
def test_causal_prefix_invariance(policy):
    """Changing frames after t (positions and mask channels) leaves every
    output row up to t as it was, bit for bit; the non-causal model does
    see the change."""
    _, p, port, inp, _ = _interp_pair(2, seed=5)
    port.set_attn_policy(policy)
    t_cut = 10
    x2, m2 = inp["x"].copy(), inp["mask"].copy()
    x2[:, t_cut + 1:] += np.random.default_rng(6).normal(size=x2[:, t_cut + 1:].shape)
    m2[:, t_cut + 1:] = 1.0 - m2[:, t_cut + 1:]
    run = lambda m, x, mask: m(torch.tensor(x), torch.tensor(inp["s"]), torch.tensor(mask),
                               _tcond(inp))
    with torch.no_grad():
        a, b = run(port, inp["x"], inp["mask"]), run(port, x2, m2)
    assert torch.equal(a[:, :t_cut + 1], b[:, :t_cut + 1])
    assert not torch.allclose(a[:, t_cut + 1:], b[:, t_cut + 1:])
    full = build_model(denoisers.InterpLevelDenoiser, generator=torch.Generator().manual_seed(0),
                       mask_channels=2, **KW).eval()
    full.load_state_dict(params_to_state_dict(p, "interp"), strict=True)
    with torch.no_grad():
        assert not torch.allclose(run(full, inp["x"], inp["mask"])[:, :t_cut + 1],
                                  run(full, x2, m2)[:, :t_cut + 1])


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("model golden file missing (run scripts/make_golden_reference.py)")
    return np.load(GOLDEN)


@pytest.mark.parametrize("policy", ["fused", "block"])
def test_golden_causal_interp_denoiser(golden, policy):
    """The reference's causal Stage-2 denoiser (mask_channels 1) on its
    recorded inputs."""
    g = golden
    sd = {k[len("itc/sd/"):]: torch.tensor(g[k]) for k in g.files if k.startswith("itc/sd/")}
    port = build_model(denoisers.InterpLevelDenoiser, generator=torch.Generator().manual_seed(0),
                       mask_channels=1, causal=True, attn_policy=policy,
                       **KW).eval()
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(torch.tensor(g["it/in/x_s"]), torch.tensor(g["it/in/s"]),
                   torch.tensor(g["itc/in/mask"]),
                   {"occ": torch.tensor(g["kp/in/occ"]),
                    "start_goal": torch.tensor(g["kp/in/start_goal"])})
    close(out, g["itc/out"])
