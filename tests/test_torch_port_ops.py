"""Port ops (interpolated_diffusion_tpu_torch.ops / .train.batches) against
their JAX counterparts and the reference goldens.

Inputs come from numpy seeds and go through both packages as numpy arrays.
Tolerances: the golden ones are tests/test_golden_parity.py's; against JAX,
f32 atol 2e-5 / rtol 1e-4 (same f32 math, possibly another op order), and
exact equality where the result is integer or boolean.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.ops import clamp as jclamp
from interpolated_diffusion_tpu.ops import ddpm as jddpm
from interpolated_diffusion_tpu.ops import keyframes as jkf
from interpolated_diffusion_tpu.ops import schedules as jsched
from interpolated_diffusion_tpu.train import batches as jbatches
from interpolated_diffusion_tpu_torch.ops import clamp, ddpm, keyframes, schedules
from interpolated_diffusion_tpu_torch.train import batches

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_golden.npz")
N_TRAIN = 100


@pytest.fixture(scope="module")
def g():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden file missing (run scripts/make_golden_reference.py)")
    return np.load(GOLDEN)


def close(a, b, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def T(a):
    return torch.from_numpy(np.array(a))


def _idx(rng, B, T_, K):
    inner = np.stack([rng.choice(np.arange(1, T_ - 1), K - 2, replace=False)
                      for _ in range(B)])
    return np.sort(np.concatenate([np.zeros((B, 1), int), inner,
                                   np.full((B, 1), T_ - 1)], axis=1), axis=1)


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_schedule_tables(g, name):
    ours = schedules.make_schedule(name, N_TRAIN)
    ref = jsched.make_schedule(name, N_TRAIN)
    for field in ("betas", "alphas", "alpha_bar", "sqrt_alpha_bar", "sqrt_one_minus_alpha_bar"):
        close(getattr(ours, field), g[f"sched/{name}/{field}"], atol=2e-6, rtol=1e-5)
        close(getattr(ours, field), getattr(ref, field), atol=2e-6, rtol=1e-5)
    assert ours.n_timesteps == N_TRAIN and ours.betas.dtype == torch.float32


def test_x0_from_eps_and_ddim_step(g):
    s, js = schedules.make_schedule("linear", N_TRAIN), jsched.make_schedule("linear", N_TRAIN)
    xt, eps, t, tp = g["ddpm/q_sample"], g["ddpm/eps_hat"], g["ddpm/t"], g["ddpm/t_prev"]
    x0 = ddpm.predict_x0_from_eps(T(xt), T(eps), T(t), s)
    close(x0, g["ddpm/x0_from_eps"], atol=1e-4, rtol=1e-5)
    close(x0, jddpm.predict_x0_from_eps(jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(t), js))
    out = ddpm.ddim_step(T(xt), T(eps), T(t), T(tp), s)
    close(out, g["ddpm/ddim_step"], atol=1e-4, rtol=1e-5)
    close(out, jddpm.ddim_step(jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(t),
                               jnp.asarray(tp), js))
    # per-token timesteps [B, T]
    t_tok = g["ddpm/t_tok"]
    close(ddpm.predict_x0_from_eps(T(xt), T(eps), T(t_tok), s),
          jddpm.predict_x0_from_eps(jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(t_tok), js))


def test_ddim_step_x0_clip():
    rng = np.random.default_rng(0)
    xt, eps = rng.normal(size=(3, 8, 2)).astype(np.float32), rng.normal(size=(3, 8, 2)).astype(np.float32)
    t, tp = np.array([99, 50, 10]), np.array([80, 30, 0])
    for name in ("linear", "cosine"):
        s, js = schedules.make_schedule(name, N_TRAIN), jsched.make_schedule(name, N_TRAIN)
        out = ddpm.ddim_step(T(xt), T(eps), T(t), T(tp), s, x0_clip=0.5)
        ref = jddpm.ddim_step(jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(t),
                              jnp.asarray(tp), js, x0_clip=0.5)
        close(out, ref)


@pytest.mark.parametrize("sch", ["linear", "quadratic", "sqrt"])
def test_timestep_subsequencing(g, sch):
    for steps in (5, 20, 99, 150):
        ours = ddpm.make_timesteps(N_TRAIN, steps, schedule=sch)
        np.testing.assert_array_equal(ours.astype(np.int64), g[f"ddpm/timesteps/{sch}/{steps}"])
        np.testing.assert_array_equal(ours, jddpm.make_timesteps(N_TRAIN, steps, schedule=sch))
    assert len(ddpm.make_timesteps(N_TRAIN, 20)) == 20  # bench: 19 model evaluations


@pytest.mark.parametrize("x0_clip", [None, 1.0])
def test_ddim_scan_matches_jax(x0_clip):
    """A fixed eps function stands in for the model; post() clamps a slot."""
    rng = np.random.default_rng(1)
    z0 = rng.normal(size=(4, 8, 2)).astype(np.float32)
    W = rng.normal(size=(2, 2)).astype(np.float32) * 0.3
    known = np.zeros((4, 8, 2), bool)
    known[:, 0] = True
    times = ddpm.make_timesteps(N_TRAIN, 6)
    s, js = schedules.make_schedule("cosine", N_TRAIN), jsched.make_schedule("cosine", N_TRAIN)

    eps_t = lambda z, t: torch.tanh(z @ T(W)) + t.float()[:, None, None] / N_TRAIN
    eps_j = lambda z, t: jnp.tanh(z @ W) + t.astype(jnp.float32)[:, None, None] / N_TRAIN
    post_t = lambda z: torch.where(T(known), torch.zeros_like(z), z)
    post_j = lambda z: jnp.where(known, 0.0, z)
    out = ddpm.run_solver("ddim", eps_t, T(z0), times, s, post=post_t, x0_clip=x0_clip)
    ref, _ = jddpm.run_solver("ddim", eps_j, jnp.asarray(z0), jnp.asarray(times), js,
                              post=post_j, x0_clip=x0_clip)
    close(out, ref)


@pytest.mark.parametrize("sch", ["doubling", "linear", "geom"])
def test_k_schedule(g, sch):
    kw = {"geom_gamma": 1.7} if sch == "geom" else {}
    ours = keyframes.compute_k_schedule(64, 8, 3, schedule=sch, **kw)
    np.testing.assert_array_equal(np.asarray(ours, np.int64), g[f"interp/k_schedule/{sch}"])
    assert ours == jkf.compute_k_schedule(64, 8, 3, schedule=sch, **kw)


def test_interpolate_from_indices_golden(g):
    idx, vals = T(g["interp/idx"]), T(g["interp/vals4"])
    close(keyframes.interpolate_from_indices(idx, vals, 32), g["interp/out"], atol=1e-6, rtol=1e-5)
    close(keyframes.interpolate_from_indices(idx, vals, 32, recompute_velocity=True),
          g["interp/out_vel"], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("B,T_,K,D", [(5, 64, 8, 2), (3, 32, 5, 4), (2, 16, 2, 3)])
def test_interpolate_from_indices_matches_jax(B, T_, K, D):
    rng = np.random.default_rng(B * 100 + K)
    idx = _idx(rng, B, T_, K)
    vals = rng.normal(size=(B, K, D)).astype(np.float32)
    for vel in (False, True):
        out = keyframes.interpolate_from_indices(T(idx), T(vals), T_, recompute_velocity=vel)
        ref = jkf.interpolate_from_indices(jnp.asarray(idx, jnp.int32), jnp.asarray(vals), T_,
                                           recompute_velocity=vel)
        close(out, ref)
        # anchors preserved exactly
        got = torch.gather(out, 1, T(idx)[..., None].expand(B, K, D))
        if not (vel and D == 4):
            assert torch.equal(got, T(vals))


def test_recompute_velocity_channels():
    y = np.random.default_rng(2).normal(size=(2, 16, 4)).astype(np.float32)
    close(keyframes.recompute_velocity_channels(T(y), 16),
          jkf.recompute_velocity_channels(jnp.asarray(y), 16))


@pytest.mark.parametrize("k_schedule", ["doubling", "linear"])
def test_nested_masks_from_base_with_jax_draw(k_schedule):
    """Fed JAX's own uniform draw, the port builds the same nested masks."""
    B, T_, K, levels = 6, 64, 8, 3
    idx = _idx(np.random.default_rng(3), B, T_, K)
    key = jax.random.PRNGKey(7)
    masks_j, idx_j = jkf.build_nested_masks_from_base(key, jnp.asarray(idx, jnp.int32), T_,
                                                      levels, k_schedule=k_schedule)
    rand = np.asarray(jax.random.uniform(key, (B, T_)))
    masks, idx_l = keyframes.build_nested_masks_from_base(T(idx), T_, levels, k_schedule=k_schedule,
                                                          rand=T(rand))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(masks_j))
    for a, b in zip(idx_l, idx_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # nested, coarsest level = the base anchors
    m = masks.numpy()
    assert (m[:, 1:] <= m[:, :-1]).all()
    np.testing.assert_array_equal(idx_l[levels].numpy(), idx)
    np.testing.assert_array_equal(keyframes._mask_from_idx(T(idx), T_).numpy(),
                                  np.asarray(jkf._mask_from_idx(jnp.asarray(idx), T_)))


def test_nested_masks_from_base_generator():
    idx = T(_idx(np.random.default_rng(4), 3, 32, 4))
    a, _ = keyframes.build_nested_masks_from_base(idx, 32, 2, generator=torch.Generator().manual_seed(0))
    b, _ = keyframes.build_nested_masks_from_base(idx, 32, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        keyframes.build_nested_masks_from_base(idx, 32, 2)


@pytest.mark.parametrize("dims", ["pos", "all"])
def test_apply_clamp(g, dims):
    x_hat, x_ref, mask = g["clamp/x_hat"], g["clamp/x_ref"], g["clamp/mask"]
    out = clamp.apply_clamp(T(x_hat), T(x_ref), T(mask), dims)
    close(out, g[f"clamp/hard_{dims}"], atol=1e-7, rtol=1e-5)
    close(out, jclamp.apply_clamp(jnp.asarray(x_hat), jnp.asarray(x_ref), jnp.asarray(mask), dims))
    assert clamp.apply_clamp(T(x_hat), T(x_ref), None, dims) is not None


@pytest.mark.parametrize("clamp_endpoints", [True, False])
def test_known_mask_values_and_gather(clamp_endpoints):
    rng = np.random.default_rng(5)
    B, T_, K, D = 4, 32, 6, 4
    idx = _idx(rng, B, T_, K)
    sg = rng.uniform(size=(B, 4)).astype(np.float32)
    m, v = batches.build_known_mask_values(T(idx), {"start_goal": T(sg)}, D, T_, clamp_endpoints)
    mj, vj = jbatches.build_known_mask_values(jnp.asarray(idx), {"start_goal": jnp.asarray(sg)},
                                              D, T_, clamp_endpoints)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))
    x0 = rng.normal(size=(B, T_, D)).astype(np.float32)
    np.testing.assert_array_equal(batches.gather_keypoints(T(x0), T(idx)).numpy(),
                                  np.asarray(jbatches.gather_keypoints(jnp.asarray(x0),
                                                                       jnp.asarray(idx))))
