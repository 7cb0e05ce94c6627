"""The maze trainers' ops, batch functions, train steps and dataset against the
JAX package, on the CPU in f32.

JAX's own random draws are injected into the port: each test recomputes them
with the key-split order of the JAX function (train/batches.py
corrupt_from_anchors :160, build_interp_level_batch :279,
build_interp_adjacent_batch :340) and hands them over as numpy arrays.
Integer outputs must be equal; float outputs agree to 1e-6 (the same f32
arithmetic in another library). The numpy dataset must be bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import dataset as jdata
from interpolated_diffusion_tpu.ops import ddpm as jddpm
from interpolated_diffusion_tpu.ops import keyframes as jkf
from interpolated_diffusion_tpu.ops import normalize as jnorm
from interpolated_diffusion_tpu.ops import schedules as jsched
from interpolated_diffusion_tpu.ops.video_keyframes import distance_alpha as j_distance_alpha
from interpolated_diffusion_tpu.train import batches as jbat
from interpolated_diffusion_tpu.train import common as jcommon
from interpolated_diffusion_tpu.train import state as jstate
from interpolated_diffusion_tpu_torch.data import dataset as pdata
from interpolated_diffusion_tpu_torch.ops import ddpm, keyframes, normalize, schedules
from interpolated_diffusion_tpu_torch.ops.video_keyframes import distance_alpha
from interpolated_diffusion_tpu_torch.train import batches, common, state


def close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=tol, rtol=tol)


def t(a):
    return torch.tensor(np.array(a))


B, T, D, K = 6, 32, 4, 5


def _traj(seed=0, d=D):
    r = np.random.default_rng(seed)
    return r.uniform(size=(B, T, d)).astype(np.float32)


# --- ops -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_q_sample_matches_jax(name):
    r = np.random.default_rng(0)
    x0, noise = _traj(), r.normal(size=(B, T, D)).astype(np.float32)
    tt = r.integers(0, 50, size=(B,))
    xt, eps = ddpm.q_sample(t(x0), t(tt), schedules.make_schedule(name, 50), noise=t(noise))
    ref, _ = jddpm.q_sample(jnp.asarray(x0), jnp.asarray(tt), jsched.make_schedule(name, 50),
                            noise=jnp.asarray(noise))
    close(xt, ref)
    assert torch.equal(eps, t(noise))
    g = torch.Generator().manual_seed(1)
    xt2, eps2 = ddpm.q_sample(t(x0), t(tt), schedules.make_schedule(name, 50), generator=g)
    assert eps2.shape == xt2.shape == (B, T, D) and eps2.std() > 0.5
    with pytest.raises(ValueError):
        ddpm.q_sample(t(x0), t(tt), schedules.make_schedule(name, 50))


def test_logit_and_sigmoid_pos_match_jax():
    x = _traj(1)
    x[0, 0, 0], x[0, 1, 1] = 0.0, 1.0     # clipped at eps
    close(normalize.logit_pos(t(x), 1e-5), jnorm.logit_pos(jnp.asarray(x), 1e-5), tol=1e-5)
    z = (x - 0.5) * 8
    close(normalize.sigmoid_pos(t(z)), jnorm.sigmoid_pos(jnp.asarray(z)))
    one = t(x[..., :1])
    assert normalize.logit_pos(one) is one and normalize.sigmoid_pos(one) is one


@pytest.mark.parametrize("ends,k", [(True, K), (True, 2), (False, K)])
def test_sample_fixed_k_indices_batch_matches_jax(ends, k):
    key = jax.random.PRNGKey(3)
    rand = np.asarray(jax.random.uniform(key, (B, T - 2 if ends else T)))
    idx, mask = keyframes.sample_fixed_k_indices_batch(B, T, k, ensure_endpoints=ends,
                                                       rand=t(rand))
    ridx, rmask = jkf.sample_fixed_k_indices_batch(key, B, T, k, ensure_endpoints=ends)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(mask.numpy(), np.asarray(rmask))
    gidx, _ = keyframes.sample_fixed_k_indices_batch(
        B, T, k, ensure_endpoints=ends, generator=torch.Generator().manual_seed(0))
    assert gidx.shape == (B, k) and bool((gidx[:, 1:] > gidx[:, :-1]).all())


@pytest.mark.parametrize("sched", ["doubling", "linear", "geom"])
def test_build_nested_masks_batch_matches_jax(sched):
    key = jax.random.PRNGKey(4)
    rand = np.asarray(jax.random.uniform(key, (B, T - 2)))
    masks, idxs = keyframes.build_nested_masks_batch(B, T, 4, 2, k_schedule=sched, rand=t(rand))
    rmasks, ridxs = jkf.build_nested_masks_batch(key, B, T, 4, 2, k_schedule=sched)
    assert np.array_equal(masks.numpy(), np.asarray(rmasks))
    for a, b in zip(idxs, ridxs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert bool((masks[:, 2] <= masks[:, 1]).all() and (masks[:, 1] <= masks[:, 0]).all())


def test_distance_alpha_matches_jax():
    idx, _ = jkf.sample_fixed_k_indices_batch(jax.random.PRNGKey(5), B, T, K)
    close(distance_alpha(t(idx), T), j_distance_alpha(idx, T))


# --- batch functions ----------------------------------------------------------

def _cond(seed=0):
    r = np.random.default_rng(seed)
    return {"occ": np.zeros((B, 1, 5, 5), np.float32),
            "start_goal": r.uniform(size=(B, 4)).astype(np.float32)}


@pytest.mark.parametrize("logit,override", [(False, False), (True, False), (False, True)])
def test_build_keypoint_batch_matches_jax(logit, override):
    key = jax.random.PRNGKey(6)
    x0, cond = _traj(2), _cond()
    ov = np.sort(np.random.default_rng(0).choice(T, (B, K)), axis=1) if override else None
    out = batches.build_keypoint_batch(
        {"idx_rand": t(jax.random.uniform(key, (B, T - 2)))}, t(x0), K,
        {k: t(v) for k, v in cond.items()}, logit_space=logit,
        idx_override=None if ov is None else t(ov))
    ref = jbat.build_keypoint_batch(key, jnp.asarray(x0), K,
                                    {k: jnp.asarray(v) for k, v in cond.items()},
                                    logit_space=logit,
                                    idx_override=None if ov is None else jnp.asarray(ov))
    for a, b in zip(out, ref):
        close(a, b, tol=1e-5 if logit else 1e-6)


@pytest.mark.parametrize("args", [(8, 4, 0.1, 0.01, 1.0), (16, 4, 0.1, 0.05, 0.5),
                                  (4, 4, 0.0, 0.0, 1.0), (32, 8, 0.2, 0.0, 2.0)])
def test_level_schedules_match_jax(args):
    assert batches.compute_sigma_for_level(*args) == jbat.compute_sigma_for_level(*args)
    ja = (args[0], args[1], 3, args[4])
    assert batches.compute_jitter_for_level(*ja) == jbat.compute_jitter_for_level(*ja)
    assert batches.parse_policy_mix("dp:2, uniform:1,random:1") == \
        jbat.parse_policy_mix("dp:2, uniform:1,random:1")
    assert batches.parse_policy_mix("") == []
    with pytest.raises(ValueError):
        batches.parse_policy_mix("dp")


def _corrupt_draws(key, Bn, Kn, Tn, jitter):
    """The draws of JAX's corrupt_from_anchors(key, ...), in its split order."""
    k_jit, k_use, k_anchor, k_noise = jax.random.split(key, 4)
    return {"jit": t(jax.random.randint(k_jit, (Bn, Kn), -jitter, jitter + 1)) if jitter else None,
            "use": t(jax.random.uniform(k_use, (Bn, Kn))),
            "anchor": t(jax.random.normal(k_anchor, (Bn, Kn, 2))),
            "noise": t(jax.random.normal(k_noise, (Bn, Tn, 2)))}


@pytest.mark.parametrize("mode,jitter,clamp,recompute,d", [
    ("dist", 2, True, True, 4), ("gauss", 0, False, False, 2), ("dist", 3, False, True, 4),
    ("gauss", 1, True, False, 4)])
def test_corrupt_from_anchors_matches_jax(mode, jitter, clamp, recompute, d):
    key = jax.random.PRNGKey(7)
    x0 = _traj(3, d)
    idx, _ = jkf.sample_fixed_k_indices_batch(jax.random.PRNGKey(8), B, T, K)
    kw = dict(T=T, sigma=0.05, anchor_sigma=0.02, index_jitter=jitter, index_jitter_prob=0.6,
              mode=mode, clamp_endpoints=clamp, recompute_velocity=recompute,
              return_prenoise=True)
    out = batches.corrupt_from_anchors(_corrupt_draws(key, B, K, T, jitter), t(x0), t(idx), **kw)
    ref = jbat.corrupt_from_anchors(key, jnp.asarray(x0), idx, **kw)
    for a, b in zip(out, ref):
        close(a, b)


CORR = dict(corrupt_mode="dist", corrupt_sigma_max=0.08, corrupt_sigma_min=0.01,
            corrupt_sigma_pow=1.0, corrupt_anchor_frac=0.5, corrupt_index_jitter_max=2,
            corrupt_index_jitter_prob=0.5, corrupt_index_jitter_pow=1.0, clamp_endpoints=True,
            pos_clip=True, pos_clip_min=0.05, pos_clip_max=0.95)


def _level_draws(key, K_min, levels, Kn_of):
    """The draws of build_interp_{level,adjacent}_batch(key, ...): k_masks,
    k_s, k_lvls = split(key, 3); per level s the corruption draws of
    split(k_lvls, levels + 1)[s]."""
    k_masks, k_s, k_lvls = jax.random.split(key, 3)
    lvl_keys = jax.random.split(k_lvls, levels + 1)
    return {"mask_rand": t(jax.random.uniform(k_masks, (B, T - 2))),
            "s_idx": t(jax.random.randint(k_s, (B,), 1, levels + 1)),
            "levels": [_corrupt_draws(lvl_keys[s], B, Kn_of[s], T,
                                      batches.compute_jitter_for_level(
                                          Kn_of[s], K_min, CORR["corrupt_index_jitter_max"], 1.0))
                       for s in range(levels + 1)]}


@pytest.mark.parametrize("corr,vel,d,recompute", [
    (CORR, False, 4, True), (dict(CORR, corrupt_mode="none"), False, 4, True),
    (CORR, True, 4, True), (dict(CORR, corrupt_mode="gauss", pos_clip=False), False, 2, False)])
def test_build_interp_level_batch_matches_jax(corr, vel, d, recompute):
    key = jax.random.PRNGKey(9)
    K_min, levels = 4, 2
    kn = keyframes.compute_k_schedule(T, K_min, levels)
    x0 = _traj(4, d)
    out = batches.build_interp_level_batch(_level_draws(key, K_min, levels, kn), t(x0), K_min,
                                           levels, recompute_velocity=recompute,
                                           corrupt_vel=vel, **corr)
    ref = jbat.build_interp_level_batch(key, jnp.asarray(x0), K_min, levels,
                                        recompute_velocity=recompute, corrupt_vel=vel, **corr)
    for a, b in zip(out[:4], ref[:4]):
        close(a, b)
    for a, b in zip(out[4], ref[4]):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("corr,clean,override", [
    (CORR, True, False), (CORR, False, False), (dict(CORR, corrupt_mode="none"), True, True),
    (dict(CORR, corrupt_vel=True), True, True)])
def test_build_interp_adjacent_batch_matches_jax(corr, clean, override):
    key = jax.random.PRNGKey(10)
    K_min, levels = 4, 2
    kn = keyframes.compute_k_schedule(T, K_min, levels)
    x0 = _traj(5)
    ov = _traj(6) if override else None
    out = batches.build_interp_adjacent_batch(
        _level_draws(key, K_min, levels, kn), t(x0), K_min, levels, recompute_velocity=True,
        x0_override=None if ov is None else t(ov), clean_target=clean, **corr)
    ref = jbat.build_interp_adjacent_batch(
        key, jnp.asarray(x0), K_min, levels, recompute_velocity=True,
        x0_override=None if ov is None else jnp.asarray(ov), clean_target=clean, **corr)
    for a, b in zip(out[:6], ref[:6]):
        close(a, b)
    for a, b in zip(out[6], ref[6]):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_batch_functions_draw_from_a_generator():
    """With a torch.Generator instead of injected draws: shapes, nested
    masks, anchors of the clean target preserved, and reproducibility."""
    x0 = t(_traj(7))
    run = lambda: batches.build_interp_adjacent_batch(
        torch.Generator().manual_seed(5), x0, 4, 2, recompute_velocity=False,
        **dict(CORR, pos_clip=False))
    a, b = run(), run()
    for u, v in zip(a[:5], b[:5]):
        assert torch.equal(u, v)
    x_s, x_prev, mask_s, mask_prev, s_idx = a[:5]
    assert x_s.shape == x_prev.shape == (B, T, D) and mask_s.shape == (B, T)
    assert bool((mask_s <= mask_prev).all()) and bool(((s_idx >= 1) & (s_idx <= 2)).all())
    assert torch.allclose(x_prev[mask_prev], x0[mask_prev])   # clean target keeps its anchors


# --- dataset and host policies -------------------------------------------------

def jax_native_ready() -> bool:
    """The JAX package's C++ generator, loaded (its "auto" builds it on first
    use and falls back to numpy when the load fails, e.g. while another test
    process is still writing the library)."""
    import shutil
    import time

    from interpolated_diffusion_tpu.data import native as jnative

    if shutil.which("g++") is None:
        return False
    for _ in range(5):
        if jnative.load_native() is not None:
            return True
        time.sleep(1.0)
    return False


@pytest.mark.parametrize("vel,sdf", [(False, False), (True, True)])
def test_particle_maze_dataset_is_bit_identical(vel, sdf, tmp_path):
    """At the default flags ("auto": the C++ generator, or numpy when SDFs
    are asked for) and under "never" (numpy), the port's dataset is the JAX
    package's bit for bit; "always" takes the C++ generator unless SDFs are
    asked for, as in JAX."""
    if not sdf and not jax_native_ready():
        pytest.skip("g++ is not available: no C++ maze generator to compare")
    kw = dict(num_samples=40, h=9, w=9, T=16, with_velocity=vel, use_sdf=sdf, shard_size=16,
              seed=11)
    idx = np.array([0, 39, 17, 16, 3, 3])
    for mode in ("auto", "never", "always"):
        cache = str(tmp_path / mode)
        ref = jdata.ParticleMazeDataset(use_native=mode, **kw)
        ds = pdata.ParticleMazeDataset(cache_dir=cache, use_native=mode, **kw)
        a, b = ds.get_batch(idx), ref.get_batch(idx)
        assert a.keys() == b.keys() and ds.data_dim == ref.data_dim == (4 if vel else 2)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (mode, k)
        # the shard cache on disk serves a second dataset the same arrays
        again = pdata.ParticleMazeDataset(cache_dir=cache, use_native=mode, **kw).get_batch(idx)
        assert all(np.array_equal(a[k], again[k]) for k in a)
        assert np.array_equal(ds.get(17)["x"], b["x"][2])
    # the default is "auto"
    default = pdata.ParticleMazeDataset(**kw).get_batch(idx)
    assert all(np.array_equal(default[k], a[k]) for k in a)


def test_prepared_dataset_and_loader_match_jax(tmp_path):
    r = np.random.default_rng(0)
    path = str(tmp_path / "prep.npz")
    np.savez(path, x=r.uniform(size=(20, 8, 2)).astype(np.float32),
             start_goal=r.uniform(size=(20, 4)).astype(np.float32),
             kp_idx=np.sort(r.integers(0, 8, size=(20, 4)), axis=1))
    ds, ref = pdata.PreparedTrajectoryDataset(path), jdata.PreparedTrajectoryDataset(path)
    assert (len(ds), ds.T, ds.data_dim) == (len(ref), ref.T, ref.data_dim)
    la = iter(pdata.BatchLoader(ds, 5, seed=3, prefetch=0))
    lb = iter(jdata.BatchLoader(ref, 5, seed=3, prefetch=0))
    for _ in range(3):
        a, b = next(la), next(lb)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    with pytest.raises(ValueError):
        np.savez(str(tmp_path / "bad.npz"), y=np.zeros(3))
        pdata.PreparedTrajectoryDataset(str(tmp_path / "bad.npz"))


@pytest.mark.parametrize("mix", ["random:1.0", "uniform:1.0", "dp:0.5,uniform:0.3,random:0.2"])
def test_sample_idx_policy_matches_jax(mix):
    kp = np.sort(np.random.default_rng(1).integers(0, T, size=(B, K)), axis=1)
    a = common.sample_idx_policy(np.random.RandomState(5), mix, B, T, K, kp, 0.5)
    b = jcommon.sample_idx_policy(np.random.RandomState(5), mix, B, T, K, kp, 0.5)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_trainer_flags_match_jax_defaults():
    """Every flag of the JAX trainers exists in the port with the same
    default; the port adds --device and --attn_policy."""
    from interpolated_diffusion_tpu.train import train_interp_levels as js2
    from interpolated_diffusion_tpu.train import train_keypoints as js1
    from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2
    from interpolated_diffusion_tpu_torch.train import train_keypoints as ps1

    for jmod, pmod in ((js1, ps1), (js2, ps2)):
        want = vars(jmod.build_argparser().parse_args([]))
        got = vars(pmod.build_argparser().parse_args([]))
        assert {k: got[k] for k in want} == want
        assert set(got) - set(want) == {"device", "attn_policy"}
        assert got["device"] == "cuda" and got["attn_policy"] == "fused"


# --- train steps ---------------------------------------------------------------

def _toy():
    """A toy regression whose loss uses the step's noise draw."""
    r = np.random.default_rng(0)
    params = {"w": r.normal(size=(3, 2)).astype(np.float32),
              "b": r.normal(size=(2,)).astype(np.float32)}
    batches_ = [{"x": r.normal(size=(8, 3)).astype(np.float32),
                 "y": r.normal(size=(8, 2)).astype(np.float32),
                 "scale": np.float32(0.5 + i)} for i in range(2)]
    return params, batches_


def _jax_toy_loss(p, b, rng):
    noise = jax.random.normal(rng, b["y"].shape)
    pred = b["x"] @ p["w"] + p["b"]
    loss = jnp.mean((pred - b["y"] - 0.1 * noise) ** 2) * b["scale"]
    return loss, {"mean_pred": pred.mean()}


def _torch_toy_loss(p, b, rng):
    pred = b["x"] @ p["w"] + p["b"]
    loss = torch.mean((pred - b["y"] - 0.1 * rng["noise"]) ** 2) * b["scale"]
    return loss, {"mean_pred": pred.mean().detach()}


def _port_state(params, tx_kw):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    return state.init_train_state(p, state.make_optimizer(**tx_kw), use_ema=True)


TX = dict(lr=1e-2, weight_decay=1e-2, grad_clip=0.5)


def _check_state(st, ref, tol=1e-6):
    assert int(st.step) == int(ref.step)
    for k in ref.params:
        close(st.params[k].detach(), ref.params[k], tol)
        close(st.ema_params[k], ref.ema_params[k], tol)


def test_make_train_step_grad_accum_matches_jax():
    """grad_accum 2: loss, gradients and aux are microbatch means; the
    microbatch rngs are split(rng, 2) in JAX, injected here."""
    params, (b0, _) = _toy()
    tx = jstate.make_optimizer(**TX)
    jst = jstate.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jstate.make_train_step(_jax_toy_loss, tx, 0.9, grad_accum=2, donate=False)
    st = _port_state(params, TX)
    step = state.make_train_step(_torch_toy_loss, 0.9, grad_accum=2)
    tb = {k: torch.as_tensor(v) for k, v in b0.items()}
    for i in range(2):
        rng = jax.random.PRNGKey(20 + i)
        draws = [{"noise": t(jax.random.normal(r, (4, 2)))} for r in jax.random.split(rng, 2)]
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b0.items()}, rng)
        st, m = step(st, tb, draws)
        for k in ("loss", "grad_norm", "mean_pred"):
            close(m[k], jm[k])
        _check_state(st, jst)


def test_make_train_multi_step_matches_jax():
    """2 steps per call over a stacked superbatch: metrics of the last step;
    the per-step rngs are split(rng, 2) in JAX, injected here."""
    params, bs = _toy()
    tx = jstate.make_optimizer(**TX)
    jst = jstate.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jstate.make_train_multi_step(_jax_toy_loss, tx, 0.9, 1, 2, donate=False)
    st = _port_state(params, TX)
    step = state.make_train_multi_step(_torch_toy_loss, 0.9, 1, 2)
    sup = state.stack_batches(bs)
    jsup = jstate.stack_batches(bs)
    assert all(np.array_equal(sup[k], jsup[k]) for k in jsup)
    rng = jax.random.PRNGKey(30)
    draws = [{"noise": t(jax.random.normal(r, (8, 2)))} for r in jax.random.split(rng, 2)]
    jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in jsup.items()}, rng)
    st, m = step(st, {k: torch.as_tensor(v) for k, v in sup.items()}, draws)
    for k in ("loss", "grad_norm", "mean_pred"):
        close(m[k], jm[k])
    _check_state(st, jst)
    # a short superbatch takes as many steps as it holds
    st, _ = step(st, {k: torch.as_tensor(v[:1]) for k, v in sup.items()}, draws)
    assert st.step == 3
    # steps_per_call 1 is the plain step
    one = state.make_train_multi_step(_torch_toy_loss, 0.9, 1, 1)
    st, _ = one(st, {k: torch.as_tensor(v) for k, v in bs[0].items()}, draws[0])
    assert st.step == 4


def test_train_step_gives_unreached_leaves_zero_gradients():
    p = {"w": torch.ones(2, requires_grad=True), "unused": torch.ones(2, requires_grad=True)}
    st = state.init_train_state(p, state.make_optimizer(lr=0.1, weight_decay=0.0), use_ema=False)
    step = state.make_train_step(lambda prm, b, r: ((prm["w"] * b["x"]).sum(), {}))
    st, m = step(st, {"x": torch.tensor([1.0, 2.0])}, None)
    assert torch.equal(p["unused"].detach(), torch.ones(2)) and float(m["grad_norm"]) > 0
    assert not torch.equal(p["w"].detach(), torch.ones(2)) and st.ema_params is None
