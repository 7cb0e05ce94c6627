"""The port's sequence sharding (parallel/ring.py, parallel/ring_sla.py, the
denoisers' attn_impl "ring" and generate_causal's seq_group) on gloo process
groups of 2 and 4 CPU ranks (tests/torch_dist_workers.py), against the JAX
package on its 8-device CPU mesh, f32.

- ring_self_attention, causal and not, at worlds 2 and 4 (a ring of two
  cannot tell left from right): every rank's output chunk against JAX's
  ring_attention (1e-5 of the scale), and the gradients of sum(o * w) with
  respect to q, k, v (through the ppermute backward) against plain dense
  attention's (1e-5).
- The sequence-sharded causal Stage-2 denoiser (ring attention, global
  pos_frac) at world 4 against JAX's dense one on the same weights (1e-4),
  as tests/test_ring_causal_sampler.py holds JAX's own.
- Ring-SLA at world 4 (blocks of 8, BH 4, L 64, D 16): the global block map
  equals JAX's single-device get_block_map LUT exactly; the block-sparse hops
  (the SLA kernel's plain twin on every hop, sentinel blocks) under JAX's LUT
  against JAX's global block-sparse reference, the linear branch against
  JAX's _linear_attention and the host entry against JAX's ring_sla_attention
  (reference impl) (2e-5 absolute, as tests/test_ring_sla.py).
- make_causal_pipeline with Stage 2 sharded over two ranks against the same
  pipeline in one process (seeded port models, the same draws; 1e-5).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.kernels.sla import _linear_attention, get_block_map
from interpolated_diffusion_tpu.models.denoisers import InterpLevelDenoiser as JInterp
from interpolated_diffusion_tpu.parallel.ring import make_seq_mesh, ring_attention
from interpolated_diffusion_tpu.parallel.ring_sla import ring_sla_attention
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.models import denoisers
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.sample import generate_causal
from torch_dist_workers import spawn

jref = importlib.import_module("interpolated_diffusion_tpu.kernels.block_sparse_reference")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _dense_grads(q, k, v, w, causal):
    """Plain f32 attention [B, H, L, D]: output and d(sum(o * w)) / dq, dk, dv."""
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        L = q.shape[2]
        s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(), float("-inf"))
    o = torch.softmax(s, dim=-1) @ v
    (o * torch.tensor(w)).sum().backward()
    return [x.grad.numpy() for x in (q, k, v)]


RING_SLA = dict(block=8, topk=0.3)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    qkv = {n: r.normal(size=(2, 3, 32, 16)).astype(np.float32) for n in ("q", "k", "v", "w")}
    sla = {n: r.normal(size=(4, 64, 16)).astype(np.float32) for n in ("q", "k", "v")}
    _, lut, _ = get_block_map(jnp.asarray(sla["q"]), jnp.asarray(sla["k"]), RING_SLA["topk"],
                              RING_SLA["block"], RING_SLA["block"])
    sla.update(RING_SLA, lut=np.asarray(lut))
    return qkv, sla


def _denoiser_case():
    """JAX's causal Stage-2 denoiser, its params (+ 0.02, the head is zero
    at init), inputs, the hoisted cond vector and the dense output."""
    from interpolated_diffusion_tpu.sample.generate import hoist_cond_vec

    B, T, D, C = 2, 64, 2, 2
    kw = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, d_cond=16, data_dim=D,
              mask_channels=C, causal=True, maze_channels=(4,))
    dense = JInterp(**kw)
    cond = {"occ": jnp.zeros((B, 1, 8, 8)), "start_goal": jnp.zeros((B, 4))}
    shapes = jax.eval_shape(dense.init, jax.random.PRNGKey(0), jnp.zeros((B, T, D)),
                            jnp.zeros((B,), jnp.int32), jnp.zeros((B, T, C)), cond)["params"]
    r = np.random.default_rng(1)
    params = jax.tree.map(lambda s: (0.2 * r.normal(size=s.shape) / np.sqrt(s.shape[0])
                                     + 0.02).astype(np.float32), shapes)
    x = r.normal(size=(B, T, D)).astype(np.float32)
    s = np.full((B,), 2, np.int32)
    mask = (r.uniform(size=(B, T, C)) > 0.8).astype(np.float32)
    ref = jax.jit(dense.apply)({"params": params}, x, s, mask, cond)
    cv = hoist_cond_vec(dense, params, cond)["cond_vec"]
    sd = {k: v.numpy() for k, v in params_to_state_dict(params, "interp").items()}
    return {"kw": kw, "sd": sd, "x": x, "s": s, "mask": mask,
            "cond_vec": np.asarray(cv)}, np.asarray(ref)


def _pipeline_case():
    """Seeded port models and the causal pipeline in one process."""
    KW = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, d_cond=16, maze_channels=(8, 8))
    kp_kw, it_kw = dict(KW, data_dim=2), dict(KW, data_dim=2, mask_channels=3, causal=True)
    g = torch.Generator().manual_seed(0)
    kp = build_model(denoisers.KeypointDenoiser, generator=g, **kp_kw).eval()
    it = build_model(denoisers.InterpLevelDenoiser, generator=g, zero_init_scale=0.05,
                     **it_kw).eval()
    r = np.random.default_rng(2)
    cond = {"occ": (r.uniform(size=(4, 1, 9, 9)) < 0.2).astype(np.float32),
            "start_goal": r.uniform(0.05, 0.95, size=(4, 4)).astype(np.float32)}
    kw = dict(T=32, K_min=3, levels=2, chunk=8, ddim_steps=3, data_dim=2, mask_channels=3)
    draws = generate_causal.make_causal_draws(32, 3, 8, 4, 2, torch.Generator().manual_seed(3))
    pipe = generate_causal.make_causal_pipeline(kp, it, make_schedule("linear", 100), **kw)
    with torch.no_grad():
        ref = pipe({k: torch.tensor(v) for k, v in cond.items()}, draws=draws).numpy()
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    return {"kp_kw": kp_kw, "it_kw": it_kw, "kp_sd": sd(kp), "it_sd": sd(it), "cond": cond,
            "kw": kw, "draws": draws}, ref


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_and_ring_sla_match_jax(world, data, tmp_path):
    qkv, sla = data
    jobs = [("ring", qkv)]
    if world == 4:
        den_payload, den_ref = _denoiser_case()
        jobs += [("ring_sla", sla), ("causal_denoiser", den_payload)]
    else:
        pipe_payload, pipe_ref = _pipeline_case()
        jobs += [("causal_pipeline", pipe_payload)]
    ranks = spawn(jobs, world, tmp_path)

    mesh = make_seq_mesh(world)
    for causal in (False, True):
        want = np.asarray(jax.jit(lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=causal))(*(jnp.asarray(qkv[n]) for n in ("q", "k", "v"))))
        grads = _dense_grads(qkv["q"], qkv["k"], qkv["v"], qkv["w"], causal)
        got = {n: np.concatenate([r[0][causal][n] for r in ranks], axis=2)
               for n in ("o", "dq", "dk", "dv")}
        assert rel(got["o"], want) <= 1e-5, causal
        for n, g in zip(("dq", "dk", "dv"), grads):
            assert rel(got[n], g) <= 1e-5, (causal, n)

    if world == 2:
        out = ranks[0][1]
        assert np.array_equal(out, ranks[1][1])          # every rank gathers the whole
        assert rel(out, pipe_ref) <= 1e-5
        return
    b = sla["block"]
    q, k, v = (jnp.asarray(sla[n]) for n in ("q", "k", "v"))
    lut = np.concatenate([r[1]["lut"] for r in ranks], axis=1)
    np.testing.assert_array_equal(lut, sla["lut"])
    o_ref, _ = jref.block_sparse_attention_reference(q, k, v, jnp.asarray(sla["lut"]), b, b)
    o_sparse = np.concatenate([r[1]["o_sparse"] for r in ranks], axis=1)
    np.testing.assert_allclose(o_sparse, np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    o_lin = np.concatenate([r[1]["o_linear"] for r in ranks], axis=1)
    np.testing.assert_allclose(o_lin, np.asarray(_linear_attention(q, k, v, "softmax")),
                               rtol=2e-5, atol=2e-5)
    o_host = ring_sla_attention(q, k, v, mesh, topk_ratio=sla["topk"], block_m=b, block_n=b,
                                impl="reference")
    for r in ranks:
        np.testing.assert_allclose(r[1]["o_host"], np.asarray(o_host), rtol=2e-5, atol=2e-5)
    den = ranks[0][2]
    assert den.shape == den_ref.shape and rel(den, den_ref) <= 1e-4, rel(den, den_ref)
