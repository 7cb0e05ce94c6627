"""The port's Stage-1-only sampler (sample/sample_keypoints.make_sampler)
against the numbers the JAX package's CLI (sample/sample_keypoints.main)
saves, on the CPU in f32.

JAX's main samples whatever its loader returns: here a tiny KeypointDenoiser
with JAX's seeded weights, every leaf moved off flax's zero init, and a meta
that sets the knob under test (objective rf, logit space, kp_feat with the
D_phi cost channels). The port samples the same weights, converted, through
make_sampler, on the same dataset batches and anchor indices (the host
RandomState, replayed) and from the initial noise JAX drew: key =
PRNGKey(sample_seed), then per batch key, k_b = split(key) and
normal(k_b, (B, K, D)). The saved keypoints and trajectories are held to
atol 1e-4 / rtol 1e-3, as tests/test_torch_port_pipeline.py's: the solvers
feed each model output back in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.models import loading as jloading
from interpolated_diffusion_tpu.models import selector as jsel
from interpolated_diffusion_tpu.ops.selection import (
    build_segment_features_from_idx as j_seg_feat)
from interpolated_diffusion_tpu.sample import sample_keypoints as jsk
from interpolated_diffusion_tpu.train.common import make_dataset, sample_idx_policy
from interpolated_diffusion_tpu_torch.models import denoisers
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import (params_to_state_dict,
                                                                segment_cost_to_state_dict)
from interpolated_diffusion_tpu_torch.models.selector import SegmentCostPredictor
from interpolated_diffusion_tpu_torch.ops.selection import build_segment_features_from_idx
from interpolated_diffusion_tpu_torch.sample import sample_keypoints

KW = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, d_cond=16, maze_channels=(8, 8))
T, K, G, SEED = 32, 6, 9, 1234
FLAGS = ["--kp_ckpt", "unused", "--num_batches", "2", "--batch", "5", "--num_samples", "64",
         "--maze_h", str(G), "--maze_w", str(G), "--bf16", "0", "--plots", "0",
         "--ddim_steps", "5", "--kp_index_mode", "random", "--sample_seed", str(SEED)]
META = dict(stage="keypoints", T=T, K=K, schedule="linear", N_train=100, clamp_endpoints=1,
            use_sdf=0)

# Each case sets knobs that act on different parts of make_sampler: the three
# solvers, the three time spacings, pos_clip on and off (over data_dim 2 and
# 4), the rf branch's integer timestep, logit space, and kp_feat with D_phi.
CASES = {
    "ddim-quadratic-pos_clip": ([], {}),
    "pfdiff-linear-no_pos_clip": (["--solver", "pfdiff", "--time_spacing", "linear",
                                   "--pos_clip", "0"], {}),
    "dpm-sqrt-D4": (["--solver", "dpm", "--time_spacing", "sqrt", "--with_velocity", "1"], {}),
    "rf": ([], dict(objective="rf")),
    "logit_space-kp_feat-dphi": (["--dphi_ckpt", "unused"],
                                 dict(logit_space=1, use_kp_feat=1, kp_feat_dim=5,
                                      kp_feat_dphi=1)),
}


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def _noisy(params, seed, scale=0.05):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + scale * r.normal(size=p.shape).astype(
        np.float32), params)


def _models(D, kp_feat_dim):
    """(JAX module, its params, the port's model with those weights)."""
    cond1 = {"occ": jnp.zeros((1, 1, G, G)), "start_goal": jnp.zeros((1, 4))}
    if kp_feat_dim:
        cond1["kp_feat"] = jnp.zeros((1, K, kp_feat_dim))
    jm = jden.KeypointDenoiser(**KW, data_dim=D, kp_feat_dim=kp_feat_dim)
    params = _noisy(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, K, D)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, K), jnp.int32),
                            jnp.zeros((1, K, D), bool), cond1, T)["params"], 2)
    pm = build_model(denoisers.KeypointDenoiser, generator=torch.Generator().manual_seed(0),
                     **KW, data_dim=D, kp_feat_dim=kp_feat_dim)
    pm.load_state_dict(params_to_state_dict(params, "keypoint"), strict=True)
    return jm, params, pm.eval()


def _dphi_fns():
    """D_phi with JAX's seeded weights: JAX's seg_cost_fn (as
    models/loading.make_dphi_seg_cost_fn builds it) and the port's."""
    jm = jsel.SegmentCostPredictor(d_cond=16, hidden_dim=24, maze_channels=(4, 8))
    cond1 = {"occ": jnp.zeros((1, 1, G, G)), "start_goal": jnp.zeros((1, 4))}
    params = _noisy(jm.init(jax.random.PRNGKey(3), cond1, jnp.zeros((1, 3)))["params"], 4)
    pm = build_model(SegmentCostPredictor, generator=torch.Generator().manual_seed(0),
                     d_cond=16, hidden_dim=24, maze_channels=(4, 8))
    pm.load_state_dict(segment_cost_to_state_dict(params), strict=True)
    pm.eval()
    return (lambda c, idx: jm.apply({"params": params}, c, j_seg_feat(idx, T, 3)),
            lambda c, idx: pm(c, build_segment_features_from_idx(idx, T, 3)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_sampler_matches_the_jax_cli_on_its_draws(case, tmp_path, monkeypatch):
    flags, knobs = CASES[case]
    argv = FLAGS + flags + ["--out_dir", str(tmp_path)]
    D = 4 if "--with_velocity" in flags else 2
    meta = dict(META, data_dim=D, **knobs)
    kfd = int(meta.get("kp_feat_dim", 0))
    jm, params, pm = _models(D, kfd)
    j_dphi, p_dphi = _dphi_fns() if kfd else (None, None)
    monkeypatch.setattr(jsk, "load_keypoint_model", lambda *a: (jm, params, meta))
    monkeypatch.setattr(jloading, "make_dphi_seg_cost_fn", lambda *a, **k: (j_dphi, {}))
    jsk.main(argv)
    with np.load(tmp_path / "samples.npz") as f:
        ref = {k: f[k] for k in f.files}

    args = sample_keypoints.build_argparser().parse_args(argv + ["--device", "cpu"])
    sample = sample_keypoints.make_sampler(pm, meta, args, torch.device("cpu"), p_dphi)
    args.T = T
    ds, data_dim = make_dataset(args)
    assert data_dim == D
    host_rng = np.random.RandomState(SEED)
    key = jax.random.PRNGKey(SEED)
    got = {"keypoints": [], "interp": [], "idx": [], "gt": []}
    for _ in range(args.num_batches):
        batch = ds.get_batch(host_rng.randint(0, len(ds), size=args.batch))
        idx = sample_idx_policy(host_rng, f"{args.kp_index_mode}:1.0", args.batch, T, K)
        key, k_b = jax.random.split(key)
        z0 = torch.tensor(np.asarray(jax.random.normal(k_b, (args.batch, K, D))))
        cond = {"occ": torch.tensor(batch["occ"]), "start_goal": torch.tensor(batch["start_goal"])}
        z, x = sample(z0, torch.tensor(idx).long(), cond)
        for name, v in (("keypoints", z.numpy()), ("interp", x.numpy()), ("idx", idx),
                        ("gt", batch["x"])):
            got[name].append(v)
    got = {k: np.concatenate(v) for k, v in got.items()}
    for k in ("idx", "gt"):          # the replay saw JAX's batches and anchors
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["keypoints"].shape == (10, K, D) and np.isfinite(got["interp"]).all()
    for k in ("keypoints", "interp"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=1e-3, err_msg=k)
    if "--pos_clip" not in flags and not meta.get("logit_space"):
        assert got["keypoints"][..., :2].min() >= 0.0 and got["keypoints"][..., :2].max() <= 1.0
