"""The port's reverse-scan solvers (ops/ddpm.py: PFDiff, DPM-Solver++(2M),
DDIM with FORA block caching, run_solver) and rectified flow
(ops/rectified_flow.py) against the JAX package, on fixed eps / velocity
functions and on a tiny KeypointDenoiser with its FORA hooks, plus the
properties tests/test_diffusion.py holds the JAX solvers to.

Inputs come from numpy seeds. Tolerances: a fixed function, f32 atol 2e-5 /
rtol 1e-4 (`close` of tests/test_torch_port_ops.py: the same f32 math in
another op order); through the denoiser, atol 1e-4 / rtol 1e-3 (the
pipeline test's: each model output feeds the next step, and the x0-from-eps
divide amplifies per-module rounding); the exactness properties at the
tolerances of tests/test_diffusion.py; integer timesteps and evaluation
counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.ops import ddpm as jddpm
from interpolated_diffusion_tpu.ops import rectified_flow as jrf
from interpolated_diffusion_tpu.ops import schedules as jsched
from interpolated_diffusion_tpu_torch.models import denoisers
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.ops import ddpm, rectified_flow, schedules

N_TRAIN = 100


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def close(a, b, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def T(a):
    return torch.from_numpy(np.array(a))


def _fixed(seed=1, d_model=6):
    """A state-dependent eps with a FORA-style 'block stack' in both
    frameworks: h_in = z W1, the stack adds tanh(h_in) (or the cached
    residual), the head maps back with W2."""
    r = np.random.default_rng(seed)
    W1 = (r.normal(size=(2, d_model)) * 0.5).astype(np.float32)
    W2 = (r.normal(size=(d_model, 2)) * 0.5).astype(np.float32)

    def eps_t(z, t, blocks_delta=None, return_delta=False):
        h_in = z @ T(W1) + t.float()[:, None, None] / N_TRAIN
        h = h_in + (blocks_delta if blocks_delta is not None else torch.tanh(h_in))
        out = h @ T(W2)
        return (out, h - h_in) if return_delta else out

    def eps_j(z, t, blocks_delta=None, return_delta=False):
        h_in = z @ W1 + t.astype(jnp.float32)[:, None, None] / N_TRAIN
        h = h_in + (blocks_delta if blocks_delta is not None else jnp.tanh(h_in))
        out = h @ W2
        return (out, h - h_in) if return_delta else out

    return eps_t, eps_j


def _state(seed=2, B=3, K=8):
    r = np.random.default_rng(seed)
    z0 = r.normal(size=(B, K, 2)).astype(np.float32)
    known = np.zeros((B, K, 2), bool)
    known[:, 0] = True
    return z0, known


@pytest.mark.parametrize("solver,interval", [("pfdiff", 1), ("dpm", 1), ("ddim", 2)])
def test_solver_matches_jax(solver, interval):
    """Each solver against JAX run_solver on a fixed eps,
    with post() clamping a slot, an x0 clip and the collected states."""
    eps_t, eps_j = _fixed()
    z0, known = _state()
    s, js = schedules.make_schedule("linear", N_TRAIN), jsched.make_schedule("linear", N_TRAIN)
    times = ddpm.make_timesteps(N_TRAIN, 8)
    post_t = lambda z: torch.where(T(known), torch.zeros_like(z), z)
    post_j = lambda z: jnp.where(known, 0.0, z)
    delta0 = np.zeros((3, 8, 6), np.float32)
    for x0_clip in (None, 1.5):
        out, steps = ddpm.run_solver(solver, eps_t, T(z0), times, s, post=post_t, collect=True,
                                     cache_interval=interval, delta0=T(delta0), x0_clip=x0_clip)
        ref, ref_steps = jddpm.run_solver(solver, eps_j, jnp.asarray(z0), jnp.asarray(times), js,
                                          post=post_j, collect=True, cache_interval=interval,
                                          delta0=jnp.asarray(delta0), x0_clip=x0_clip)
        close(out, ref)
        assert steps.shape == ref_steps.shape
        close(steps, ref_steps)
        # without collect: the final state alone
        again = ddpm.run_solver(solver, eps_t, T(z0), times, s, post=post_t,
                                cache_interval=interval, delta0=T(delta0), x0_clip=x0_clip)
        assert torch.equal(again, out)


@pytest.mark.parametrize("solver", ["pfdiff", "dpm"])
def test_pfdiff_and_dpm_refuse_fora_caching(solver):
    s = schedules.make_schedule("linear", N_TRAIN)
    with pytest.raises(ValueError, match="cache_interval"):
        ddpm.run_solver(solver, lambda z, t: z, torch.zeros(1, 2, 2),
                        ddpm.make_timesteps(N_TRAIN, 5), s, cache_interval=2)
    with pytest.raises(ValueError, match="delta0"):
        ddpm.run_solver("ddim", lambda z, t: z, torch.zeros(1, 2, 2),
                        ddpm.make_timesteps(N_TRAIN, 5), s, cache_interval=2)


@pytest.mark.parametrize("steps", [2, 3, 6, 7, 20])
def test_collected_states_and_evaluations_per_solver(steps):
    """Per solver, the count of collected states equals JAX's (pfdiff: one per
    springboard group plus the odd tail, None without a group; dpm: the states
    after the first transition), and the count of model evaluations is
    ddim S, pfdiff 1 + ceil((S - 1) / 2), dpm S, FORA ceil(S / interval) full
    stack evaluations and the rest cached."""
    eps_t, eps_j = _fixed(3)
    z0, _ = _state(4)
    s, js = schedules.make_schedule("linear", N_TRAIN), jsched.make_schedule("linear", N_TRAIN)
    times = ddpm.make_timesteps(N_TRAIN, steps)
    S = len(times) - 1
    delta0 = np.zeros((3, 8, 6), np.float32)
    for solver, interval in (("ddim", 1), ("pfdiff", 1), ("dpm", 1), ("ddim", 2), ("ddim", 3)):
        calls = {"full": 0, "cached": 0}

        def counted(z, t, blocks_delta=None, return_delta=False):
            calls["cached" if blocks_delta is not None else "full"] += 1
            return eps_t(z, t, blocks_delta, return_delta)

        _, ys = ddpm.run_solver(solver, counted, T(z0), times, s, collect=True,
                                cache_interval=interval, delta0=T(delta0))
        _, ys_j = jddpm.run_solver(solver, eps_j, jnp.asarray(z0), jnp.asarray(times), js,
                                   collect=True, cache_interval=interval,
                                   delta0=jnp.asarray(delta0))
        assert (ys is None) == (ys_j is None), (solver, steps)
        if ys is not None:
            assert ys.shape == ys_j.shape, (solver, interval, steps)
        want = {"ddim": S, "dpm": S, "pfdiff": S if S < 2 else 1 + -(-(S - 1) // 2)}[solver]
        if interval > 1:
            full = -(-S // interval)
            assert calls == {"full": full, "cached": S - full}, (interval, steps, calls)
        else:
            assert calls == {"full": want, "cached": 0}, (solver, steps, calls)


def test_bench_grid_evaluation_counts():
    """DDIM-20 (20 timesteps, 19 transitions): ddim 19, dpm 19 (9 at 10
    steps), pfdiff 1 + 9 = 10, FORA interval 2 10 full stack evaluations."""
    def count(solver, steps, interval=1):
        n = {"full": 0}

        def fn(z, t, blocks_delta=None, return_delta=False):
            n["full"] += blocks_delta is None
            return (z * 0.1, z) if return_delta else z * 0.1

        ddpm.run_solver(solver, fn, torch.zeros(1, 8, 2), ddpm.make_timesteps(N_TRAIN, steps),
                        schedules.make_schedule("linear", N_TRAIN), cache_interval=interval,
                        delta0=torch.zeros(1, 8, 2))
        return n["full"]

    assert count("ddim", 20) == 19 and count("dpm", 20) == 19 and count("dpm", 10) == 9
    assert count("pfdiff", 20) == 10 and count("ddim", 20, 2) == 10


@pytest.mark.parametrize("steps", [6, 7])
def test_pfdiff_exact_match_for_static_eps(steps):
    """DDIM is transitive in its x0 parameterization: for an eps that does
    not depend on (x, t), PFDiff reproduces plain DDIM on the same grid."""
    r = np.random.default_rng(5)
    eps_const = T(r.normal(size=(2, 6, 2)).astype(np.float32))
    z0 = T(r.normal(size=(2, 6, 2)).astype(np.float32))
    s = schedules.make_schedule("linear", N_TRAIN)
    times = ddpm.make_timesteps(N_TRAIN, steps)
    fn = lambda z, t: eps_const
    np.testing.assert_allclose(ddpm.pfdiff_scan(fn, z0, times, s).numpy(),
                               ddpm.ddim_scan(fn, z0, times, s).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("steps", [5, 9])
def test_dpm_solver_pp_exact_for_static_x0(steps):
    """For an eps consistent with a fixed x0 the 2M correction vanishes and
    DPM-Solver++ reproduces DDIM on the same grid."""
    r = np.random.default_rng(6)
    x0_const = T((r.normal(size=(2, 6, 2)) * 0.3).astype(np.float32))
    z0 = T(r.normal(size=(2, 6, 2)).astype(np.float32))
    s = schedules.make_schedule("linear", N_TRAIN)
    ab = s.alpha_bar

    def fn(z, t):
        return (z - torch.sqrt(ab[t[0]]) * x0_const) / torch.sqrt(1.0 - ab[t[0]])

    times = ddpm.make_timesteps(N_TRAIN, steps)
    np.testing.assert_allclose(ddpm.dpm_solver_pp_scan(fn, z0, times, s).numpy(),
                               ddpm.ddim_scan(fn, z0, times, s).numpy(), rtol=2e-4, atol=2e-5)


def test_dpm_solver_pp_second_order_beats_ddim_at_low_nfe():
    """On a smooth state-dependent score, 10-step DPM++(2M) lands closer to a
    200-step DDIM reference than 10-step DDIM does."""
    r = np.random.default_rng(7)
    w = T((r.normal(size=(2, 2)) * 0.4).astype(np.float32))
    fn = lambda z, t: torch.tanh(z @ w)
    z0 = T(r.normal(size=(2, 6, 2)).astype(np.float32))
    s = schedules.make_schedule("linear", 1000)
    ref = ddpm.ddim_scan(fn, z0, ddpm.make_timesteps(1000, 200), s)
    times = ddpm.make_timesteps(1000, 10)
    err_ddim = (ddpm.ddim_scan(fn, z0, times, s) - ref).abs().mean()
    err_dpm = (ddpm.dpm_solver_pp_scan(fn, z0, times, s) - ref).abs().mean()
    assert err_dpm < err_ddim, (float(err_dpm), float(err_ddim))


# --- the KeypointDenoiser's FORA hooks -----------------------------------------------

KW = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, d_cond=16, data_dim=2,
          maze_channels=(8, 8))


@pytest.fixture(scope="module")
def kp():
    r = np.random.default_rng(8)
    B, K, Tn, G = 3, 8, 32, 9
    inner = np.stack([np.sort(r.choice(np.arange(1, Tn - 1), K - 2, replace=False))
                      for _ in range(B)])
    idx = np.concatenate([np.zeros((B, 1), int), inner, np.full((B, 1), Tn - 1)], 1)
    cond = {"occ": (r.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32),
            "start_goal": r.uniform(size=(B, 4)).astype(np.float32)}
    known = np.zeros((B, K, 2), bool)
    known[:, 0] = known[:, -1] = True
    jm = jden.KeypointDenoiser(**KW)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, K, 2)), jnp.zeros((1,), jnp.int32),
        jnp.asarray(idx[:1], jnp.int32), jnp.zeros((1, K, 2), bool),
        {k: jnp.asarray(v[:1]) for k, v in cond.items()}, Tn)["params"])
    pm = build_model(denoisers.KeypointDenoiser, generator=torch.Generator().manual_seed(0), **KW)
    pm.load_state_dict(params_to_state_dict(params, "keypoint"), strict=True)
    return dict(jm=jm, params=params, pm=pm.eval(), idx=idx, cond=cond, known=known, T=Tn,
                z0=r.normal(size=(B, K, 2)).astype(np.float32))


def _kp_fns(m):
    jcond = {k: jnp.asarray(v) for k, v in m["cond"].items()}
    tcond = {k: T(v) for k, v in m["cond"].items()}
    eps_j = lambda z, t, **kw: m["jm"].apply({"params": m["params"]}, z, t,
                                             jnp.asarray(m["idx"], jnp.int32),
                                             jnp.asarray(m["known"]), jcond, m["T"], **kw)
    eps_t = lambda z, t, **kw: m["pm"](z, t, T(m["idx"]), T(m["known"]), tcond, m["T"], **kw)
    return eps_t, eps_j


def test_keypoint_denoiser_fora_hooks_match_jax(kp):
    """return_delta gives (eps, h - h_in); blocks_delta skips the stack."""
    eps_t, eps_j = _kp_fns(kp)
    t = np.array([90, 40, 5])
    with torch.no_grad():
        out, delta = eps_t(T(kp["z0"]), T(t), return_delta=True)
        cached = eps_t(T(kp["z0"]) * 0.5, T(t), blocks_delta=delta)
    ref, ref_delta = eps_j(jnp.asarray(kp["z0"]), jnp.asarray(t, jnp.int32), return_delta=True)
    close(out, ref)
    assert delta.shape == (3, 8, KW["d_model"])
    close(delta, ref_delta)
    close(cached, eps_j(jnp.asarray(kp["z0"]) * 0.5, jnp.asarray(t, jnp.int32),
                        blocks_delta=ref_delta))
    # the stack's residual reused at the same input is the full evaluation
    with torch.no_grad():
        close(eps_t(T(kp["z0"]), T(t), blocks_delta=delta), out, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("solver,interval", [("ddim", 2), ("ddim", 3), ("pfdiff", 1), ("dpm", 1)])
def test_solvers_through_the_denoiser_match_jax(kp, solver, interval):
    eps_t, eps_j = _kp_fns(kp)
    s, js = schedules.make_schedule("linear", N_TRAIN), jsched.make_schedule("linear", N_TRAIN)
    times = ddpm.make_timesteps(N_TRAIN, 7)
    delta0 = np.zeros((3, 8, KW["d_model"]), np.float32)
    with torch.no_grad():
        out = ddpm.run_solver(solver, eps_t, T(kp["z0"]), times, s, cache_interval=interval,
                              delta0=T(delta0))
    ref, _ = jddpm.run_solver(solver, eps_j, jnp.asarray(kp["z0"]), jnp.asarray(times), js,
                              cache_interval=interval, delta0=jnp.asarray(delta0))
    close(out, ref, atol=1e-4, rtol=1e-3)


# --- rectified flow -----------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3, 7, 10, 20, 33, 50, 99])
def test_rf_time_grid_matches_jax_linspace(steps):
    """The grid of the compiled linspace (the JAX samplers run under jit;
    op by op JAX divides, and some points differ by an ulp)."""
    grid = rectified_flow.rf_time_grid(steps)
    ref = np.asarray(jax.jit(lambda: jnp.linspace(1.0, 0.0, steps + 1))())
    assert grid.dtype == np.float32
    np.testing.assert_array_equal(grid, ref)


@pytest.mark.parametrize("method", ["euler", "midpoint"])
@pytest.mark.parametrize("steps,n_tr", [(20, 100), (7, 1000), (33, 100)])
def test_rf_integrate_matches_jax(method, steps, n_tr):
    """rf_integrate with post(), and the integer timesteps the samplers embed,
    (t * (n_tr - 1)) truncated, equal the jitted JAX sampler's at every
    evaluation (at 33 steps and n_tr 100, t * 99 is an integer at every grid
    point: an ulp low would truncate to the integer below)."""
    r = np.random.default_rng(9)
    W = (r.normal(size=(2, 2)) * 0.5).astype(np.float32)
    z0, known = _state(10)
    seen_t, seen_j = [], []

    def vel_t(z, t):
        t_emb = (t * (n_tr - 1)).to(torch.int32)
        seen_t.append(t_emb.numpy())
        return torch.tanh(z @ T(W)) + t_emb.float()[:, None, None] / n_tr

    def vel_j(z, t):
        t_emb = (t * (n_tr - 1)).astype(jnp.int32)
        jax.debug.callback(lambda e: seen_j.append(np.asarray(e)), t_emb, ordered=True)
        return jnp.tanh(z @ W) + t_emb.astype(jnp.float32)[:, None, None] / n_tr

    post_t = lambda z: torch.where(T(known), torch.zeros_like(z), z)
    post_j = lambda z: jnp.where(known, 0.0, z)
    out = rectified_flow.rf_integrate(vel_t, T(z0), steps, method, post=post_t)
    ref = jax.jit(lambda z: jrf.rf_integrate(vel_j, z, steps, method, post=post_j))(
        jnp.asarray(z0))
    jax.effects_barrier()
    close(out, ref)
    assert len(seen_t) == len(seen_j) == steps * (2 if method == "midpoint" else 1)
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_rf_interpolate_loss_sample_and_reflow_pair_match_jax():
    r = np.random.default_rng(11)
    x0, noise = r.normal(size=(2, 4, 8, 2)).astype(np.float32)
    v_pred = r.normal(size=(4, 8, 2)).astype(np.float32)
    t = r.uniform(size=(4,)).astype(np.float32)
    mask = r.uniform(size=(4, 8)) < 0.6
    for a, b in zip(rectified_flow.rf_interpolate(T(x0), T(t), T(noise)),
                    jrf.rf_interpolate(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))):
        close(a, b)
    for m in (None, mask, mask[..., None]):
        close(rectified_flow.rf_loss(T(v_pred), T(x0), T(noise), None if m is None else T(m)),
              jrf.rf_loss(jnp.asarray(v_pred), jnp.asarray(x0), jnp.asarray(noise),
                          None if m is None else jnp.asarray(m)))
    W = (r.normal(size=(2, 2)) * 0.5).astype(np.float32)
    vel_t = lambda z, t: torch.tanh(z @ T(W)) * t[:, None, None]
    vel_j = lambda z, t: jnp.tanh(z @ W) * t[:, None, None]
    key = jax.random.PRNGKey(12)
    j_noise, j_x = jrf.reflow_pair(vel_j, key, (4, 8, 2), steps=6)
    # the noise JAX drew, injected
    p_noise, p_x = rectified_flow.reflow_pair(vel_t, (4, 8, 2), steps=6,
                                              noise=T(np.asarray(jax.random.normal(key, (4, 8, 2)))))
    close(p_noise, j_noise)
    close(p_x, j_x)
    keep = np.zeros((4, 8), bool)
    keep[:, 0] = True
    j_s = jrf.rf_sample(vel_j, key, (4, 8, 2), steps=5, method="midpoint",
                        keep_mask=jnp.asarray(keep))
    p_s = rectified_flow.rf_sample(vel_t, (4, 8, 2), steps=5, method="midpoint",
                                   keep_mask=T(keep), noise=T(np.asarray(
                                       jax.random.normal(key, (4, 8, 2)))))
    close(p_s, j_s)
    assert torch.equal(p_s[:, 0], torch.zeros(4, 2))
    g = lambda: torch.Generator().manual_seed(0)
    assert torch.equal(rectified_flow.reflow_pair(vel_t, (4, 8, 2), 3, generator=g())[1],
                       rectified_flow.reflow_pair(vel_t, (4, 8, 2), 3, generator=g())[1])
    with pytest.raises(ValueError):
        rectified_flow.rf_sample(vel_t, (4, 8, 2))
