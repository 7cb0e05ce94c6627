"""The port's causal sampler (sample/generate_causal.py) against the JAX
package's, and both its CLIs (that and sample/sample_keypoints.py) against
the JAX CLIs' files, on the CPU in f32. The Stage-1-only sampler's numbers
are held to JAX's in tests/test_torch_sample_keypoints.py.

make_causal_pipeline: small models (d 32, 2 layers, 4 heads), T=32, chunk 8
(four chunks, the last of 7 frames), K_min 3, DDIM-5, a causal Stage 2 with
a nonzero head, and the draws JAX made injected into the port: per chunk
key, k_idx, k_s1 = split(key, 3); uniform(k_idx, (B, L - 1)); normal(k_s1,
(B, K_local, D)), or normal(split(k_s1, N)[n], ...) under best-of-N. The JAX
pipeline runs under jax.jit, as its CLI runs it. Tolerance atol 1e-4 / rtol
1e-3, as tests/test_torch_port_pipeline.py's: each chunk's DDIM steps feed
the model output back in, and each chunk starts from the last one's output.

The CLIs: JAX's own trainers write a tiny Stage-1 and a tiny causal Stage-2
checkpoint (one step each); the port's loaders read them (utils/jax_checkpoint)
and give the JAX loaders' forward (3e-5 / 1e-4), and the port's CLIs must
write the JAX CLIs' files: the same flags, metrics.csv columns,
summary.json keys and dataset batches. The CLIs draw their noise each from
its own package's generator, so their samples are checked for shape,
finiteness and the endpoints here, not against each other.
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.models import selector as jsel
from interpolated_diffusion_tpu.ops.schedules import make_schedule as jmake_schedule
from interpolated_diffusion_tpu.ops.selection import (
    build_segment_features_from_idx as j_seg_feat)
from interpolated_diffusion_tpu.sample import generate_causal as jgc
from interpolated_diffusion_tpu.sample import sample_keypoints as jsk
from interpolated_diffusion_tpu_torch.models import denoisers
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import (params_to_state_dict,
                                                                segment_cost_to_state_dict)
from interpolated_diffusion_tpu_torch.models.selector import SegmentCostPredictor
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.ops.selection import build_segment_features_from_idx
from interpolated_diffusion_tpu_torch.sample import generate_causal, sample_keypoints

KW = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, d_cond=16, maze_channels=(8, 8))
B, T, CHUNK, K_MIN, LEVELS, G, STEPS = 4, 32, 8, 3, 2, 9, 5


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def _port(cls, params, kind, **kw):
    m = build_model(cls, generator=torch.Generator().manual_seed(0), **KW, **kw)
    m.load_state_dict(params_to_state_dict(params, kind), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def setup():
    r = np.random.default_rng(0)
    occ = (r.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32)
    sg = r.uniform(0.05, 0.95, size=(B, 4)).astype(np.float32)
    cond = {"occ": jnp.asarray(occ), "start_goal": jnp.asarray(sg)}
    cond1 = {k: v[:1] for k, v in cond.items()}
    models = {}

    def pair(D=2, mc=1, kp_feat_dim=0):
        if (D, mc, kp_feat_dim) not in models:
            kp = jden.KeypointDenoiser(**KW, data_dim=D, kp_feat_dim=kp_feat_dim)
            c1 = dict(cond1, kp_feat=jnp.zeros((1, 3, kp_feat_dim))) if kp_feat_dim else cond1
            kp_p = jax.tree.map(np.asarray, kp.init(
                jax.random.PRNGKey(1), jnp.zeros((1, 3, D)), jnp.zeros((1,), jnp.int32),
                jnp.asarray([[0, 3, 8]], jnp.int32), jnp.zeros((1, 3, D), bool), c1, 9)["params"])
            it = jden.InterpLevelDenoiser(**KW, data_dim=D, mask_channels=mc, causal=True)
            it_p = jax.tree.map(np.asarray, it.init(
                jax.random.PRNGKey(2), jnp.zeros((1, T, D)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, T, mc)) if mc > 1 else jnp.zeros((1, T), bool), cond1)["params"])
            rr = np.random.default_rng(mc + 10 * D)
            it_p["out"]["kernel"] = (rr.normal(size=it_p["out"]["kernel"].shape)
                                     * 0.05).astype(np.float32)
            it_p["out"]["bias"] = (rr.normal(size=it_p["out"]["bias"].shape)
                                   * 0.01).astype(np.float32)
            models[(D, mc, kp_feat_dim)] = (
                kp, kp_p, it, it_p,
                _port(denoisers.KeypointDenoiser, kp_p, "keypoint", data_dim=D,
                      kp_feat_dim=kp_feat_dim),
                _port(denoisers.InterpLevelDenoiser, it_p, "interp", data_dim=D,
                      mask_channels=mc, causal=True))
        return models[(D, mc, kp_feat_dim)]

    # D_phi for the kp_feat cost channels: JAX's seeded weights, converted
    dphi = jsel.SegmentCostPredictor(d_cond=16, hidden_dim=24, maze_channels=(4, 8))
    dphi_p = jax.tree.map(np.asarray, dphi.init(jax.random.PRNGKey(3), cond1,
                                                jnp.zeros((1, 3)))["params"])
    dphi_t = build_model(SegmentCostPredictor, generator=torch.Generator().manual_seed(0),
                         d_cond=16, hidden_dim=24, maze_channels=(4, 8))
    dphi_t.load_state_dict(segment_cost_to_state_dict(dphi_p), strict=True)
    dphi_fns = (lambda c, idx: dphi.apply({"params": dphi_p}, c, j_seg_feat(idx, T, 3)),
                lambda c, idx: dphi_t.eval()(c, build_segment_features_from_idx(idx, T, 3)))
    return dict(occ=occ, sg=sg, cond=cond, pair=pair, dphi_fns=dphi_fns)


def _jax_draws(key, D, best_of):
    """The JAX pipeline's draws, chunk by chunk, in the port's layout."""
    draws = []
    for cur, end in generate_causal.chunk_plan(T, CHUNK):
        local_T = end - cur + 2
        K_local = min(K_MIN, local_T)
        key, k_idx, k_s1 = jax.random.split(key, 3)
        d = {}
        if local_T > 2 and K_local > 2:
            d["idx_rand"] = torch.tensor(np.asarray(jax.random.uniform(k_idx, (B, local_T - 2))))
        if best_of > 1:
            z = np.stack([np.asarray(jax.random.normal(k, (B, K_local, D)))
                          for k in jax.random.split(k_s1, best_of)])
        else:
            z = np.asarray(jax.random.normal(k_s1, (B, K_local, D)))
        d["z"] = torch.tensor(z)
        draws.append(d)
    return draws


# Each case sets knobs that act on different parts of the path, so that the
# cases together cover every solver, both best-of modes, the three clamp
# policies, both clamp dims, data_dim 4 with the velocity recompute, logit
# space, kp_feat with D_phi, collect_chunks and the mask-channel adapter (3
# channels, and 2 in the data_dim 4 case). Two model pairs in all: building
# a JAX model costs more than a case.
CASES = {
    "ddim-endpoints-pos": {},
    "pfdiff-all_anchors-all": dict(stage1_solver="pfdiff", clamp_policy="all_anchors",
                                   clamp_dims="all"),
    "dpm-none": dict(stage1_solver="dpm", clamp_policy="none"),
    "fora2-logit_space": dict(stage1_cache_interval=2, logit_space=True, logit_eps=1e-4),
    "best_of3-set-collect_chunks": dict(stage1_best_of=3, stage1_best_of_mode="set",
                                        collect_chunks=True),
    "best_of3-dp": dict(stage1_best_of=3, stage1_best_of_mode="dp"),
    "D4-recompute_vel-kp_feat-dphi": dict(data_dim=4, recompute_vel=True, clamp_dims="all",
                                          mask_channels=2, kp_feat_dim=5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_causal_pipeline_matches_jax(setup, case):
    kw = dict(T=T, K_min=K_MIN, levels=LEVELS, chunk=CHUNK, ddim_steps=STEPS, data_dim=2,
              logit_space=False, logit_eps=1e-5, clamp_endpoints=True,
              clamp_policy="endpoints", clamp_dims="pos", recompute_vel=False)
    kw.update(CASES[case])
    kw.setdefault("mask_channels", 3)
    D, mc, kfd = kw["data_dim"], kw["mask_channels"], kw.get("kp_feat_dim", 0)
    kp, kp_p, it, it_p, kp_t, it_t = setup["pair"](D, mc, kfd)
    j_dphi, p_dphi = setup["dphi_fns"] if kfd else (None, None)
    jpipe = jax.jit(jgc.make_causal_pipeline(kp, it, jmake_schedule("linear", 100),
                                             dphi_fn=j_dphi, **kw))
    key = jax.random.PRNGKey(7)
    ref = jpipe(kp_p, it_p, key, setup["cond"])
    pipe = generate_causal.make_causal_pipeline(kp_t, it_t, make_schedule("linear", 100),
                                                dphi_fn=p_dphi, **kw)
    out = pipe({"occ": torch.tensor(setup["occ"]), "start_goal": torch.tensor(setup["sg"])},
               draws=_jax_draws(key, D, kw.get("stage1_best_of", 1)))
    if kw.get("collect_chunks"):
        assert out[1].shape == (4, B, T, D)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-4, rtol=1e-3)
        out, ref = out[0], ref[0]
    assert out.shape == (B, T, D) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
    # the endpoints are start and goal; every frame was generated
    assert torch.equal(out[:, 0, :2], torch.tensor(setup["sg"][:, :2]))
    if kw["clamp_policy"] != "none":
        assert torch.allclose(out[:, -1, :2], torch.tensor(setup["sg"][:, 2:]), atol=1e-6)


# --- the CLIs on checkpoints that JAX's trainers wrote ---------------------------

TRAIN = ["--T", "32", "--batch", "8", "--num_samples", "64", "--d_model", "32", "--n_layers",
         "2", "--n_heads", "2", "--d_ff", "64", "--maze_channels", "8,8", "--maze_h", "9",
         "--maze_w", "9", "--log_every", "1", "--bf16", "0", "--steps", "1", "--save_every", "1"]
SAMPLE = ["--num_batches", "2", "--batch", "6", "--num_samples", "64", "--maze_h", "9",
          "--maze_w", "9", "--bf16", "0"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """A Stage-1 and a causal Stage-2 checkpoint from the JAX trainers' CLIs."""
    from interpolated_diffusion_tpu.train import train_interp_levels_causal as jtc
    from interpolated_diffusion_tpu.train import train_keypoints as jtk

    root = tmp_path_factory.mktemp("causal_cli")
    jtk.main(TRAIN + ["--K", "4", "--out_dir", str(root / "kp")])
    jtc.main(TRAIN + ["--K_min", "3", "--levels", "2", "--out_dir", str(root / "il")])
    return root


def _files(out_dir):
    with open(os.path.join(out_dir, "metrics.csv")) as f:
        columns = next(csv.reader(f))
    with open(os.path.join(out_dir, "summary.json")) as f:
        keys = set(json.load(f))
    with np.load(os.path.join(out_dir, "samples.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    return columns, keys, arrays


def _native_loaded():
    """Both CLIs build their mazes with their package's C++ generator where
    g++ is; load the JAX library first, since its "auto" falls back to numpy
    on a failed load."""
    import shutil
    import time

    from interpolated_diffusion_tpu.data import native as jnative

    for _ in range(5):
        if shutil.which("g++") is None or jnative.load_native() is not None:
            return
        time.sleep(1.0)


def test_causal_cli_on_jax_checkpoints_matches_the_jax_cli(jax_runs):
    from interpolated_diffusion_tpu.utils.checkpoint import read_meta as j_read_meta

    ckpts = ["--kp_ckpt", str(jax_runs / "kp"), "--interp_ckpt", str(jax_runs / "il"),
             "--chunk", "8", "--K_min", "3", "--ddim_steps", "4", "--save_chunks", "1"]
    _, il_meta = j_read_meta(str(jax_runs / "il" / "ckpt_1"))
    assert il_meta["causal"] == 1 and il_meta["stage"] == "interp_levels"
    _native_loaded()
    j_dir, p_dir = str(jax_runs / "jax_gc"), str(jax_runs / "port_gc")
    j_summary = jgc.main(ckpts + SAMPLE + ["--out_dir", j_dir])
    summary = generate_causal.main(ckpts + SAMPLE + ["--device", "cpu", "--attn_policy",
                                                      "block", "--out_dir", p_dir])
    (jc, jk, ja), (pc, pk, pa) = _files(j_dir), _files(p_dir)
    assert pc == jc and pk == jk == set(j_summary) == set(summary)
    assert {"samples_per_sec", "sanity"} <= pk
    assert sorted(pa) == sorted(ja) and pa["chunks"].shape == ja["chunks"].shape == (4, 6, 32, 2)
    for k in ("gt", "occ", "start_goal"):      # the same dataset batches
        np.testing.assert_array_equal(pa[k], ja[k])
    assert np.isfinite(pa["x_gen"]).all()
    np.testing.assert_allclose(pa["x_gen"][:, 0], pa["start_goal"][:, :2], atol=1e-6)
    np.testing.assert_allclose(pa["x_gen"][:, -1], pa["start_goal"][:, 2:], atol=1e-5)
    assert sorted(os.listdir(os.path.join(p_dir, "chunks"))) == \
        sorted(os.listdir(os.path.join(j_dir, "chunks")))
    assert os.path.exists(os.path.join(p_dir, "run_config.json"))


def test_jax_trained_checkpoints_load_with_the_jax_forward(jax_runs):
    """The two checkpoints JAX's trainers wrote, through each package's
    loader (EMA weights): the same forward, 3e-5 / 1e-4."""
    from interpolated_diffusion_tpu.models import loading as jloading
    from interpolated_diffusion_tpu_torch.models import loading

    r = np.random.default_rng(5)
    occ = (r.uniform(size=(3, 1, 9, 9)) < 0.2).astype(np.float32)
    sg = r.uniform(size=(3, 4)).astype(np.float32)
    jc, pc = ({"occ": f(occ), "start_goal": f(sg)} for f in (jnp.asarray, torch.tensor))
    kp_in = (r.normal(size=(3, 4, 2)).astype(np.float32), np.array([3, 40, 90], np.int32),
             np.array([[0, 5, 20, 31]] * 3, np.int32), r.uniform(size=(3, 4, 2)) < 0.3)
    il_in = (r.normal(size=(3, 32, 2)).astype(np.float32), np.array([2, 1, 2], np.int32),
             (r.uniform(size=(3, 32, 2)) < 0.4).astype(np.float32))
    for name, jload, pload, inputs, extra in (
            ("kp", jloading.load_keypoint_model, loading.load_keypoint_model, kp_in, (32,)),
            ("il", jloading.load_interp_model, loading.load_interp_model, il_in, ())):
        jm, jp, meta = jload(str(jax_runs / name), False)
        ref = jm.apply({"params": jp}, *map(jnp.asarray, inputs), jc, *extra)
        pm, pmeta = pload(str(jax_runs / name), False, device="cpu")
        assert pmeta == meta
        with torch.no_grad():
            out = pm(*map(torch.tensor, inputs), pc, *extra)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    assert pm.causal


def test_sample_keypoints_cli_on_a_jax_checkpoint_matches_the_jax_cli(jax_runs):
    ckpt = ["--kp_ckpt", str(jax_runs / "kp"), "--ddim_steps", "4", "--kp_index_mode", "random"]
    _native_loaded()
    j_dir, p_dir = str(jax_runs / "jax_sk"), str(jax_runs / "port_sk")
    j_summary = jsk.main(ckpt + SAMPLE + ["--out_dir", j_dir])
    summary = sample_keypoints.main(ckpt + SAMPLE + ["--device", "cpu", "--solver", "ddim",
                                                     "--attn_policy", "block", "--out_dir", p_dir])
    (jc, jk, ja), (pc, pk, pa) = _files(j_dir), _files(p_dir)
    assert pc == jc and pk == jk == set(j_summary) == set(summary)
    assert sorted(pa) == sorted(ja) and pa["keypoints"].shape == ja["keypoints"].shape
    for k in ("idx", "gt"):      # the same batches and anchor indices (host RandomState)
        np.testing.assert_array_equal(pa[k], ja[k])
    assert np.isfinite(pa["interp"]).all()
    assert os.path.exists(os.path.join(p_dir, "samples.png"))


@pytest.mark.parametrize("module,jax_module,required", [
    (generate_causal, jgc, ["--kp_ckpt", "a", "--interp_ckpt", "b"]),
    (sample_keypoints, jsk, ["--kp_ckpt", "a"])], ids=["generate_causal", "sample_keypoints"])
def test_cli_flags_match_the_jax_cli(module, jax_module, required):
    """Every JAX flag exists with the JAX default; the port adds --device and
    --attn_policy (fused by default, as sample/generate.py's)."""
    ours = vars(module.build_argparser().parse_args(required))
    theirs = vars(jax_module.build_argparser().parse_args(required))
    assert set(ours) - set(theirs) == {"device", "attn_policy"} and set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs
    assert ours["device"] == "cuda" and ours["attn_policy"] == "fused"


def test_causal_cli_refuses_seq_shard_and_needs_a_gpu(tmp_path):
    base = ["--kp_ckpt", str(tmp_path), "--interp_ckpt", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="parallel/ring.py"):
        generate_causal.main(base + ["--seq_shard", "2"])
    if not torch.cuda.is_available():
        for module in (generate_causal, sample_keypoints):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                module.main(["--kp_ckpt", str(tmp_path)] + (
                    ["--interp_ckpt", str(tmp_path)] if module is generate_causal else []))
