"""The port's selection ops (ops/selection.py, ops/oracle_segment_cost.py, the
per-level nested masks of ops/keyframes.py, select_topk_indices) and its C++
maze generator (data/native.py) against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port, and
both are held to the goldens `sel/` (15 arrays) and `oracle/` (2) of
tests/golden/reference_golden.npz. Tolerances: f32 arithmetic in another
order, atol 1e-6 for features and weights, 1e-5 / rtol 1e-4 for costs (the
goldens' own tolerances in tests/test_golden_parity.py); the DP, top-k and
mask choices are discrete and must be identical, ties included.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import native as jnative
from interpolated_diffusion_tpu.models import selector as jselm
from interpolated_diffusion_tpu.ops import keyframes as jkf
from interpolated_diffusion_tpu.ops import oracle_segment_cost as jor
from interpolated_diffusion_tpu.ops import selection as jsel
from interpolated_diffusion_tpu_torch.data import dataset as pdata
from interpolated_diffusion_tpu_torch.data import native as pnative
from interpolated_diffusion_tpu_torch.models.selector import select_topk_indices
from interpolated_diffusion_tpu_torch.ops import keyframes as pkf
from interpolated_diffusion_tpu_torch.ops import oracle_segment_cost as por
from interpolated_diffusion_tpu_torch.ops import selection as psel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "reference_golden.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def close(a, b, atol=0.0, rtol=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


def test_snr_weights_and_log_snr_steps(g):
    snr, w = psel.build_snr_weights("linear", 100, 0.05, 20.0, 0.5)
    close(snr, g["sel/snr"], rtol=1e-4)
    close(w, g["sel/snr_weights"], rtol=1e-4)
    np.testing.assert_array_equal(psel.sample_timesteps_log_snr(snr, 12), g["sel/log_snr_steps"])
    # the trainers' defaults, against JAX: the same steps and weight scale
    jsnr, jw = jsel.build_snr_weights("cosine", 1000, 0.1, 10.0, 1.0)
    snr, w = psel.build_snr_weights("cosine", 1000, 0.1, 10.0, 1.0)
    # alpha_bar near 1 makes snr = alpha_bar / (1 - alpha_bar) amplify the
    # cumprod's f32 rounding (~3e-4 relative at the first steps); the clipped
    # weights the trainers use agree to 1e-5
    close(snr, jsnr, rtol=1e-3)
    close(w, jw, rtol=1e-5)
    t_idx = psel.sample_timesteps_log_snr(snr, 16)
    np.testing.assert_array_equal(t_idx, jsel.sample_timesteps_log_snr(jsnr, 16))
    np.testing.assert_allclose(psel.snr_weight_scale(w, t_idx),
                               float(np.asarray(jw)[t_idx].sum()), rtol=1e-5)


def test_segment_precompute_features_and_costs(g):
    pre = psel.build_segment_precompute(24, 4)
    jpre = jsel.build_segment_precompute(24, 4)
    for name in ("seg_i", "seg_j", "seg_len", "t_idx", "seg_id"):
        np.testing.assert_array_equal(getattr(pre, name).numpy(), np.asarray(getattr(jpre, name)))
    for name in ("seg_i", "seg_j", "t_idx"):
        np.testing.assert_array_equal(getattr(pre, name).numpy(), g[f"sel/{name}"])
    close(pre.alpha, g["sel/alpha"], atol=1e-6)
    close(pre.weight, g["sel/weight"], atol=1e-6)
    close(psel.build_segment_features(24, pre.seg_i, pre.seg_j), g["sel/seg_feat"], atol=1e-6)
    idx = torch.as_tensor(g["interp/idx"])
    close(psel.build_segment_features_from_idx(idx, 32, seg_feat_dim=5), g["sel/seg_feat_idx"],
          atol=1e-6)
    for dim in (2, 3):
        close(psel.build_segment_features_from_idx(idx, 32, dim),
              jsel.build_segment_features_from_idx(jnp.asarray(g["interp/idx"]), 32, dim),
              atol=1e-6)
    cost = psel.compute_segment_costs_batch(torch.as_tensor(g["sel/x_pos"]), pre, 1.0)
    close(cost, g["sel/cost_seg"], atol=1e-5, rtol=1e-4)
    x = np.random.default_rng(0).uniform(size=(3, 24, 4)).astype(np.float32)
    close(psel.compute_segment_costs_batch(torch.as_tensor(x), pre, 2.5),
          jsel.compute_segment_costs_batch(jnp.asarray(x), jpre, 2.5), atol=1e-5, rtol=1e-4)


def _straight(B, T):
    t = np.linspace(0.0, 1.0, T, dtype=np.float32)
    return np.broadcast_to(np.stack([t, 0.5 * t], -1), (B, T, 2)).copy()


@pytest.mark.parametrize("case", ["golden", "random", "straight_line", "uniform_costs"])
def test_dp_select_indices_matches_jax_ties_included(case, g):
    """The DP against JAX on the same cost matrix: the golden trajectories,
    random ones, and two cases made of ties (a straight line, whose every
    interp cost is 0, and one constant cost for every segment), where the
    first-index argmin decides every parent."""
    T, K = 24, 6
    pre, jpre = psel.build_segment_precompute(T, 4), jsel.build_segment_precompute(T, 4)
    x = {"golden": g["sel/x_pos"],
         "random": np.random.default_rng(1).uniform(size=(5, T, 2)).astype(np.float32),
         "straight_line": _straight(3, T), "uniform_costs": _straight(3, T)}[case]
    cost = psel.compute_segment_costs_batch(torch.as_tensor(x), pre)
    if case == "uniform_costs":
        cost = torch.full_like(cost, 0.25)
    C = psel.build_cost_matrix_from_segments(cost, pre, T)
    jC = jsel.build_cost_matrix_from_segments(jnp.asarray(cost.numpy()), jpre, T)
    np.testing.assert_array_equal(C.numpy(), np.asarray(jC))
    for k in (2, 3, K, T):
        idx = psel.dp_select_indices_batch(C, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jsel.dp_select_indices_batch(jC, k)))
        assert bool((idx[:, 0] == 0).all()) and bool((idx[:, -1] == T - 1).all())
        assert bool((idx[:, 1:] > idx[:, :-1]).all())
    if case == "golden":
        np.testing.assert_array_equal(psel.dp_select_indices_batch(C, K).numpy(), g["sel/dp_idx"])
    # the single-sample variant and the [S] -> [T, T] matrix
    C1 = psel.build_cost_matrix_from_segments(cost[0], pre, T)
    assert torch.equal(C1, C[0])
    assert torch.equal(psel.dp_select_indices(C1, K), psel.dp_select_indices_batch(C, K)[0])


def test_kp_feat_matches_jax(g):
    idx = g["interp/idx"]
    close(psel.build_kp_feat_batch(torch.as_tensor(idx), 32), g["sel/kp_feat"], atol=1e-6)
    close(psel.build_kp_feat(torch.as_tensor(idx[0]), 32),
          jsel.build_kp_feat(jnp.asarray(idx[0]), 32), atol=1e-6)
    cost = np.random.default_rng(2).normal(size=(idx.shape[0], idx.shape[1] - 1)).astype(np.float32)
    for dim in (2, 3, 5, 7):
        for seg in (None, cost):
            want = jsel.build_kp_feat_full(jnp.asarray(idx), 32, dim,
                                           None if seg is None else jnp.asarray(seg))
            got = psel.build_kp_feat_full(torch.as_tensor(idx), 32, dim,
                                          None if seg is None else torch.as_tensor(seg))
            close(got, want, atol=1e-6)


def test_oracle_segment_cost_matches_jax(g):
    z = g["oracle/z_vid"]  # [B, T, C, H, W]
    B, T = z.shape[:2]
    pre, jpre = por.build_oracle_seg_precompute(T), jor.build_oracle_seg_precompute(T)
    for name in ("alpha", "member", "count"):
        close(getattr(pre, name), getattr(jpre, name), atol=1e-7)
    z_flat = z.reshape(B, T, -1)
    close(por.compute_oracle_cost_seg_mse(torch.as_tensor(z_flat), pre, normalize=False),
          g["oracle/cost"], atol=1e-4, rtol=1e-4)
    close(por.compute_oracle_cost_seg_mse(torch.as_tensor(z_flat), pre),
          jor.compute_oracle_cost_seg_mse(jnp.asarray(z_flat), jpre), atol=1e-5, rtol=1e-4)


def test_nested_masks_from_level_logits_match_jax():
    """Per-level logits with ties (rounded to a coarse grid) and the K
    schedules the trainers use."""
    r = np.random.default_rng(3)
    for T, K_min, levels, sched in ((32, 4, 2, "doubling"), (24, 3, 3, "geom"),
                                    (20, 4, 2, "linear")):
        logits = np.round(r.normal(size=(4, levels + 1, T)), 1).astype(np.float32)
        m, idx = pkf.build_nested_masks_from_level_logits(torch.as_tensor(logits), K_min, levels,
                                                          k_schedule=sched)
        jm, jidx = jkf.build_nested_masks_from_level_logits(jnp.asarray(logits), K_min, levels,
                                                            k_schedule=sched)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        for a, b in zip(idx, jidx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_select_topk_indices_matches_jax():
    """Deterministic top-k with tied logits, and the stochastic top-k on
    JAX's own Gumbel draw."""
    r = np.random.default_rng(4)
    logits = np.round(r.normal(size=(5, 16)), 1).astype(np.float32)
    for K in (2, 3, 6, 16):
        got = select_topk_indices(torch.as_tensor(logits), K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jselm.select_topk_indices(jnp.asarray(logits), K)))
    key = jax.random.PRNGKey(7)
    want = jselm.select_topk_indices(jnp.asarray(logits), 6, True, 0.5, key)
    gumbel = torch.as_tensor(np.array(jax.random.gumbel(key, (5, 14))))
    got = select_topk_indices(torch.as_tensor(logits), 6, True, 0.5, gumbel=gumbel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a generator's draw is reproducible, and a stochastic call needs a draw
    a = select_topk_indices(torch.as_tensor(logits), 6, True,
                            generator=torch.Generator().manual_seed(0))
    b = select_topk_indices(torch.as_tensor(logits), 6, True,
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gumbel"):
        select_topk_indices(torch.as_tensor(logits), 6, True)


# --- the C++ maze generator ---------------------------------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not available")


@needs_gxx
def test_native_generator_matches_jax_and_builds_outside_the_jax_package(tmp_path, monkeypatch):
    """A fresh build of the port's copy of maze_gen.cpp goes to the port's
    build tree (here a temporary one), never into the JAX package, and its
    shards equal the JAX library's bit for bit."""
    jax_data = os.path.join(ROOT, "interpolated_diffusion_tpu", "data")
    before = sorted(os.listdir(jax_data))
    monkeypatch.setattr(pnative, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(pnative, "_lib", None)
    lib = pnative.library_path()
    assert not lib.exists() and str(tmp_path) in str(lib)
    assert pnative.native_available() and lib.is_file()
    assert sorted(os.listdir(jax_data)) == before
    assert "interpolated_diffusion_tpu/" not in str(pnative.library_path()).replace(
        "interpolated_diffusion_tpu_torch/", "")
    for _ in range(5):
        if jnative.load_native() is not None:
            break
    for vel in (False, True):
        got = pnative.generate_maze_batch_native(12345, 7, 11, 13, 0.15, 0.3, 20, vel)
        want = jnative.generate_maze_batch_native(12345, 7, 11, 13, 0.15, 0.3, 20, vel)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # two calls are the same bit for bit
    again = pnative.generate_maze_batch_native(12345, 7, 11, 13, 0.15, 0.3, 20, True)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


def test_native_always_raises_only_when_the_build_fails(tmp_path, monkeypatch):
    """"always" builds and takes the C++ generator; when the build fails it
    raises, while "auto" then builds the shard with numpy (the "never"
    arrays)."""
    kw = dict(num_samples=24, h=9, w=9, T=16, shard_size=12, seed=5)
    idx = np.arange(24)
    if shutil.which("g++") is not None:
        native = pdata.ParticleMazeDataset(use_native="always", **kw).get_batch(idx)
        assert native["x"].shape == (24, 16, 2)
    never = pdata.ParticleMazeDataset(use_native="never", **kw).get_batch(idx)
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "SOURCE", tmp_path / "missing.cpp")
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "BUILD_ROOT", tmp_path / "native")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        pdata.ParticleMazeDataset(use_native="always", **kw).get_batch(idx)
    auto = pdata.ParticleMazeDataset(use_native="auto", **kw).get_batch(idx)
    assert all(np.array_equal(auto[k], never[k]) for k in never)
