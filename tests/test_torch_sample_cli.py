"""The port's sampling CLI (sample/generate.main) end to end on the CPU, on
checkpoints that the port's own trainer CLIs write (tiny: d 32, 2 layers,
T=32, K=4, 2 levels, 4 steps each; one Stage-1 checkpoint under --objective
rf), against the JAX CLI on the same weights.

The JAX CLI runs on JAX checkpoints holding the port's trained weights
(models/torch_import.convert_state_dict) and the same metas. Both CLIs draw
the same dataset batches and anchor indices (the host RandomState of
--sample_seed), so their files must have the same CSV columns and summary
keys, and the oracle-interp metrics, which involve no random draw, must
agree: f32 atol 1e-5 / rtol 1e-4 (the metrics golden tolerance of
tests/test_golden_parity.py).
"""
import csv
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import native as jnative
from interpolated_diffusion_tpu.models.torch_import import convert_state_dict
from interpolated_diffusion_tpu.sample import generate as jgen
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.sample import generate
from interpolated_diffusion_tpu_torch.train import train_interp_levels, train_keypoints
from interpolated_diffusion_tpu_torch.utils.checkpoint import load_checkpoint, read_meta

TRAIN = ["--device", "cpu", "--T", "32", "--batch", "16", "--num_samples", "64", "--d_model",
         "32", "--n_layers", "2", "--n_heads", "2", "--d_ff", "64", "--maze_channels", "8,8",
         "--maze_h", "9", "--maze_w", "9", "--log_every", "2", "--bf16", "0", "--steps", "4",
         "--save_every", "4"]
SAMPLE = ["--num_batches", "2", "--batch", "8", "--num_samples", "64", "--maze_h", "9",
          "--maze_w", "9", "--bf16", "0"]


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = {k: str(root / k) for k in ("kp", "kp_rf", "il")}
    train_keypoints.main(TRAIN + ["--K", "4", "--out_dir", out["kp"]])
    train_keypoints.main(TRAIN + ["--K", "4", "--objective", "rf", "--out_dir", out["kp_rf"]])
    train_interp_levels.main(TRAIN + ["--K_min", "4", "--levels", "2", "--anchor_conf", "1",
                                      "--out_dir", out["il"]])
    # the same weights and metas as JAX checkpoints
    for name, kind in (("kp", "keypoint"), ("il", "interp")):
        src = os.path.join(out[name], "ckpt_4")
        _, payload = load_checkpoint(src, with_opt_state=False)
        _, meta = read_meta(src)
        conv = lambda sd: jax.tree.map(jnp.asarray, convert_state_dict(
            {k: v.numpy() for k, v in sd.items()}, kind))
        jckpt.save_checkpoint(str(root / f"j_{name}" / "ckpt_4"), conv(payload["params"]), None,
                              4, conv(payload["ema"]), meta)
        out[f"j_{name}"] = str(root / f"j_{name}")
    out["root"] = root
    return out


def _run(runs, name, flags, kp="kp"):
    out_dir = str(runs["root"] / name)
    summary = generate.main(["--kp_ckpt", runs[kp], "--interp_ckpt", runs["il"], "--device", "cpu",
                             "--out_dir", out_dir] + SAMPLE + flags)
    for f in ("metrics.csv", "summary.json", "samples.npz", "run_config.json"):
        assert os.path.exists(os.path.join(out_dir, f)), f
    with np.load(os.path.join(out_dir, "samples.npz")) as f:
        samples = {k: f[k] for k in f.files}
    assert samples["refined"].shape == (16, 32, 2) and samples["keypoints"].shape == (16, 4, 2)
    for k in ("interp", "refined", "keypoints"):
        assert np.isfinite(samples[k]).all(), k
    # endpoints are clamped to start / goal
    np.testing.assert_allclose(samples["refined"][:, 0], samples["start_goal"][:, :2], atol=1e-6)
    return summary, samples, out_dir


def _columns(out_dir):
    with open(os.path.join(out_dir, "metrics.csv")) as f:
        return next(csv.reader(f))


def test_cli_matches_the_jax_cli_columns_keys_and_oracle_metrics(runs):
    summary, samples, out_dir = _run(runs, "ddim", ["--compare_oracle", "1"])
    j_dir = str(runs["root"] / "jax")
    # both CLIs build their mazes at the default flags (the C++ generator of
    # each package where g++ is, else numpy), so they draw the same mazes;
    # the JAX library is loaded first, since its "auto" would fall back to
    # numpy on a failed load
    for _ in range(5):
        if shutil.which("g++") is None or jnative.load_native() is not None:
            break
        time.sleep(1.0)
    j_summary = jgen.main(["--kp_ckpt", runs["j_kp"], "--interp_ckpt", runs["j_il"],
                           "--compare_oracle", "1", "--out_dir", j_dir] + SAMPLE)
    assert _columns(out_dir) == _columns(j_dir)
    assert set(summary) == set(j_summary)
    with open(os.path.join(out_dir, "summary.json")) as f:
        assert set(json.load(f)) == set(j_summary)
    with np.load(os.path.join(j_dir, "samples.npz")) as f:
        assert sorted(f.files) == sorted(samples)
        for k in ("idx", "gt", "occ", "start_goal"):
            np.testing.assert_array_equal(samples[k], f[k])
    for k in j_summary:
        if k.startswith("oracle_interp"):
            np.testing.assert_allclose(summary[k], j_summary[k], atol=1e-5, rtol=1e-4, err_msg=k)
    assert summary["oracle_interp_mse_to_gt"] <= summary["interp_mse_to_gt"] + 1e-6
    assert summary["samples_per_sec"] > 0 and summary["sanity"]["ok"] in (True, False)
    assert summary["refined_goal_dist"] < 1e-4


@pytest.mark.parametrize("flags", [
    ["--stage1_solver", "pfdiff"],
    ["--stage1_best_of", "3", "--stage1_best_of_mode", "dp", "--attn_policy", "block"],
    ["--stage1_cache_interval", "2", "--s2_noise_mode", "level", "--s2_noise_sigma", "0.05",
     "--s2_delta_smooth", "1", "--soft_anchor_clamp", "1", "--stage1_solver", "ddim"],
], ids=["pfdiff", "best_of-dp", "fora-level-noise-smooth-soft"])
def test_cli_sampling_knobs(runs, flags):
    summary, _, _ = _run(runs, "_".join(flags[1::2]), flags)
    assert all(np.isfinite(v) for k, v in summary.items() if k != "sanity")


def test_cli_stage1_cache_save_then_load(runs):
    cache = str(runs["root"] / "s1cache")
    _, saved, _ = _run(runs, "cache_save", ["--stage1_cache", cache,
                                            "--stage1_cache_mode", "save"])
    assert sorted(os.listdir(cache)) == ["stage1_0000.npz", "stage1_0001.npz"]
    # another Stage-1 solver on load: the anchors come from the cache all the same
    _, loaded, _ = _run(runs, "cache_load", ["--stage1_cache", cache, "--stage1_cache_mode",
                                             "load", "--stage1_solver", "dpm"])
    _, fresh, _ = _run(runs, "dpm", ["--stage1_solver", "dpm"])
    assert not np.array_equal(fresh["keypoints"], saved["keypoints"])
    np.testing.assert_array_equal(loaded["keypoints"], saved["keypoints"])
    np.testing.assert_array_equal(loaded["idx"], saved["idx"])
    # a cache written for other conditioning is refused
    with np.load(os.path.join(cache, "stage1_0000.npz")) as f:
        bad = {k: f[k] for k in f.files}
    bad["idx"][:, 0] = 0
    bad["z_pred"][:, 0, :2] += 0.5
    np.savez(os.path.join(cache, "stage1_0000.npz"), **bad)
    with pytest.raises(ValueError, match="endpoint mismatch"):
        _run(runs, "cache_bad", ["--stage1_cache", cache, "--stage1_cache_mode", "load"])


def test_cli_rf_checkpoint(runs):
    summary, samples, _ = _run(runs, "rf", [], kp="kp_rf")
    assert np.isfinite(summary["refined_collision_rate"])
    with pytest.raises(ValueError, match="rf checkpoints"):
        _run(runs, "rf_pfdiff", ["--stage1_solver", "pfdiff"], kp="kp_rf")


def test_cli_raises_without_a_gpu_and_names_what_is_missing(runs, tmp_path):
    base = ["--kp_ckpt", runs["kp"], "--interp_ckpt", runs["il"], "--out_dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate.main(base)
    # the selector modes need their checkpoint, and a Stage-1 checkpoint
    # trained with D_phi cost channels needs D_phi (JAX's refusals)
    for flags in (["--kp_index_mode", "selector"], ["--stage2_mask_policy", "selector"]):
        with pytest.raises(ValueError, match="--selector_ckpt"):
            generate.main(base + ["--device", "cpu"] + flags)
    with pytest.raises(FileNotFoundError):
        generate.main(base + ["--device", "cpu", "--dphi_ckpt", str(tmp_path / "none")])


def test_cli_flags_match_the_jax_cli():
    """Every JAX flag exists with the JAX default; the port adds --device and
    --attn_policy."""
    argv = ["--kp_ckpt", "a", "--interp_ckpt", "b"]
    ours = vars(generate.build_argparser().parse_args(argv))
    theirs = vars(jgen.build_argparser().parse_args(argv))
    assert set(ours) - set(theirs) == {"device", "attn_policy"} and set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs
    assert ours["device"] == "cuda" and ours["attn_policy"] == "fused"
