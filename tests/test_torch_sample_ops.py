"""The sampler's remaining ops against the JAX package and the reference
goldens: the soft anchor clamp (ops/clamp.py), nested masks from selector
logits (ops/keyframes.py), trajectory metrics (eval/metrics.py), the best-of
anchor search (ops/anchor_search.py), and the run provenance files
(utils/run_config.py).

Inputs come from numpy seeds. Tolerances: the goldens at
tests/test_golden_parity.py's (clamp/soft atol 1e-6; metrics atol 1e-5 /
rtol 1e-4); against JAX, f32 atol 2e-5 / rtol 1e-4 (`close` of
tests/test_torch_port_ops.py), and exact equality where the result is
integer, boolean or a selection.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.eval import metrics as jmetrics
from interpolated_diffusion_tpu.ops import anchor_search as jsearch
from interpolated_diffusion_tpu.ops import clamp as jclamp
from interpolated_diffusion_tpu.ops import keyframes as jkf
from interpolated_diffusion_tpu_torch.eval import metrics
from interpolated_diffusion_tpu_torch.ops import anchor_search, clamp, keyframes
from interpolated_diffusion_tpu_torch.utils import run_config

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_golden.npz")


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


def test_soft_clamp_golden_and_jax(g):
    x_hat, x_ref, conf = g["clamp/x_hat"], g["clamp/x_ref"], g["clamp/conf"]
    out = clamp.apply_soft_clamp(T(x_hat), T(x_ref), T(conf), 0.35, "pos")
    close(out, g["clamp/soft"], atol=1e-6, rtol=0)
    for dims in ("pos", "all"):
        for c, lam in ((conf, 0.35), (conf[..., None], 0.8), (None, 0.5), (conf, 0.0)):
            got = clamp.apply_soft_clamp(T(x_hat), T(x_ref), None if c is None else T(c), lam,
                                         dims)
            want = jclamp.apply_soft_clamp(jnp.asarray(x_hat), jnp.asarray(x_ref),
                                           None if c is None else jnp.asarray(c), lam, dims)
            close(got, want)


@pytest.mark.parametrize("sched,levels,K_min", [("doubling", 3, 8), ("linear", 2, 4),
                                                ("geom", 3, 2)])
def test_build_nested_masks_from_logits_matches_jax(sched, levels, K_min):
    r = np.random.default_rng(0)
    logits = r.normal(size=(5, 32)).astype(np.float32)
    logits[0, 5:9] = 0.25          # ties: ranked by position, as the stable sort does
    masks, idx = keyframes.build_nested_masks_from_logits(T(logits), K_min, levels,
                                                          k_schedule=sched)
    jm, jidx = jkf.build_nested_masks_from_logits(jnp.asarray(logits), K_min, levels,
                                                  k_schedule=sched)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jm))
    for a, b in zip(idx, jidx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert masks[:, :, 0].all() and masks[:, :, -1].all()
    with pytest.raises(ValueError):
        keyframes.build_nested_masks_from_logits(T(logits[0]), K_min, levels)


def test_compute_metrics_golden_and_jax(g):
    args = [g[f"metrics/{k}"] for k in ("occ", "traj", "goal", "gt")]
    got = metrics.compute_metrics_batch(*[T(a) for a in args])
    want = jmetrics.compute_metrics_batch(*[jnp.asarray(a) for a in args])
    assert set(got) == set(want) == {"collision_rate", "goal_dist", "success", "path_length",
                                     "smoothness", "mse_to_gt"}
    for k in got:
        close(got[k], g[f"metrics/{k}"], atol=1e-5, rtol=1e-4)
        close(got[k], want[k])
    one = metrics.compute_metrics(*[T(a[0]) for a in args])
    assert one == pytest.approx({k: float(v[0]) for k, v in got.items()})


def test_compute_metrics_edges_match_jax():
    """[B, 1, h, w] grids, out-of-bounds positions, cells at x.5 (rounded half
    to even in both), T < 3 and no ground truth."""
    r = np.random.default_rng(1)
    occ = (r.uniform(size=(4, 1, 9, 7)) < 0.3).astype(np.float32)
    traj = r.uniform(-0.2, 1.2, size=(4, 12, 4)).astype(np.float32)
    traj[0, :, 0] = np.arange(12) / 12.0             # x * 6 = k / 2: on the half cells
    traj[1, :, 1] = (np.arange(12) + 0.5) / 8.0
    goal = r.uniform(size=(4, 2)).astype(np.float32)
    for tr in (traj, traj[:, :2]):
        got = metrics.compute_metrics_batch(T(occ), T(tr), T(goal))
        want = jmetrics.compute_metrics_batch(jnp.asarray(occ), jnp.asarray(tr),
                                              jnp.asarray(goal))
        assert "mse_to_gt" not in got
        for k in got:
            close(got[k], want[k])
    i, j, oob = metrics._pos_to_cell(T(traj[..., :2]), 9, 7)
    ji, jj, joob = jmetrics._pos_to_cell(jnp.asarray(traj[..., :2]), 9, 7)
    for a, b in ((i, ji), (j, jj), (oob, joob)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _cands(seed, N=5, B=6, K=6, D=4, T_=32, G=9):
    r = np.random.default_rng(seed)
    z = r.uniform(-0.1, 1.1, size=(N, B, K, D)).astype(np.float32)
    inner = np.stack([np.sort(r.choice(np.arange(1, T_ - 1), K - 2, replace=False))
                      for _ in range(B)])
    idx = np.concatenate([np.zeros((B, 1), int), inner, np.full((B, 1), T_ - 1)], 1)
    occ = (r.uniform(size=(B, G, G)) < 0.35).astype(np.float32)
    return z, idx, occ, T_


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collision_score_and_dp_mix_anchors_match_jax(seed):
    z, idx, occ, T_ = _cands(seed)
    x = np.asarray(jkf.interpolate_from_indices(jnp.asarray(idx), jnp.asarray(z[0]), T_))
    close(anchor_search.collision_score(T(x), T(occ)),
          jsearch.collision_score(jnp.asarray(x), jnp.asarray(occ)))
    mixed = anchor_search.dp_mix_anchors(T(z), T(idx), T(occ), T_)
    want = jsearch.dp_mix_anchors(jnp.asarray(z), jnp.asarray(idx), jnp.asarray(occ), T_)
    np.testing.assert_array_equal(mixed.numpy(), np.asarray(want))
    # every anchor of the mix is one of the candidates' at that slot, and the
    # mix collides no more than the best whole candidate set
    assert all(any(np.array_equal(mixed[b, k].numpy(), z[n, b, k]) for n in range(len(z)))
               for b in range(z.shape[1]) for k in range(z.shape[2]))
    xs = [keyframes.interpolate_from_indices(T(idx), T(zn), T_) for zn in z]
    best = torch.stack([anchor_search.collision_score(xn, T(occ)) for xn in xs]).amin(0)
    x_mix = keyframes.interpolate_from_indices(T(idx), mixed, T_)
    assert bool((anchor_search.collision_score(x_mix, T(occ)) <= best + 1e-6).all())


def test_dp_mix_anchors_tie_goes_to_the_first_candidate():
    """A free grid: every candidate costs 0, so JAX's argmin takes candidate 0."""
    z, idx, occ, T_ = _cands(3)
    z = np.clip(z, 0.0, 1.0)
    occ = np.zeros_like(occ)
    mixed = anchor_search.dp_mix_anchors(T(z), T(idx), T(occ), T_)
    assert torch.equal(mixed, T(z[0]))


def test_run_config_and_evidence(tmp_path, monkeypatch):
    class Args:
        pass

    args = Args()
    args.batch, args.device = 4, "cpu"
    path = run_config.write_run_config(str(tmp_path / "out"), args, extra={"note": 1})
    with open(path) as f:
        payload = json.load(f)
    assert payload["args"] == {"batch": 4, "device": "cpu"} and payload["note"] == 1
    assert {"argv", "timestamp", "torch_version", "backend", "devices", "git"} <= set(payload)
    # under pytest and outside runs/ nothing is archived, unless forced
    with open(tmp_path / "out" / "summary.json", "w") as f:
        f.write("{}")
    assert run_config.archive_evidence(str(tmp_path / "out"), repo_dir=str(tmp_path)) is None
    monkeypatch.setenv("ID_TPU_FORCE_EVIDENCE", "1")
    dest = run_config.archive_evidence(str(tmp_path / "out"), repo_dir=str(tmp_path))
    assert sorted(os.listdir(dest)) == ["run_config.json", "summary.json"]
    monkeypatch.setenv("ID_TPU_NO_EVIDENCE", "1")
    assert run_config.archive_evidence(str(tmp_path / "out"), repo_dir=str(tmp_path)) is None
