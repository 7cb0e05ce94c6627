"""--use_wan 0 of the Wan chain: the token transformers
(models/video_denoisers.py) in the Phase-1 and Phase-2 trainers' losses, the
anchor precompute and the Phase-2 evaluation, against the JAX package's own
trainers and CLIs on the CPU in f32.

The losses: each JAX trainer's main runs until its first step, whose loss_fn,
parameters, batch and key are captured (tests/test_torch_wan_phase2_loss.py);
JAX's draws come from that key and go to the port. The CLIs: JAX's trainers
write real checkpoints of one step each, and the port's precompute and
evaluation read those JAX checkpoints (models/jax_import) beside JAX's own
CLIs, with JAX's per-batch draws handed in.

Tolerance, as |port - jax| / |jax|: 1e-4 (the same f32 arithmetic, other sum
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import precompute_phase1_anchors as jprep
from interpolated_diffusion_tpu.diagnostics import eval_wansynth_stage2 as jeval
from interpolated_diffusion_tpu.train import train_interp_levels_wansynth as jp2
from interpolated_diffusion_tpu.train import train_keypoints_wansynth as jp1
from interpolated_diffusion_tpu_torch.data import make_synth_tars
from interpolated_diffusion_tpu_torch.data import precompute_phase1_anchors as prep
from interpolated_diffusion_tpu_torch.data.wan_synth import iter_tar_samples
from interpolated_diffusion_tpu_torch.diagnostics import eval_wansynth_stage2 as ev
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.train import train_interp_levels_wansynth as p2
from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1

from test_torch_wan_phase2_loss import _batch, _np, capture_jax_step, phase2_draws_from_key
from test_torch_wan_phase2_ops import rel_err

F32_TOL = 1e-4
DATA = ["--T", "8", "--latent_c", "4", "--latent_h", "8", "--latent_w", "8", "--text_len", "6",
        "--text_dim", "32"]
TOKEN_FLAGS = ["--use_wan", "0", "--d_model", "32", "--n_layers", "2", "--n_heads", "2",
               "--d_ff", "64", *DATA, "--bf16", "0", "--batch", "3", "--prefetch_depth", "0",
               "--cond_drop_prob", "0.5"]


@pytest.mark.parametrize("mode", ["adj", "x0"])
def test_phase2_token_model_loss_matches_jax(tmp_path, monkeypatch, mode):
    """--use_wan 0: the VideoTokenInterpLevelDenoiser's refinement loss, with
    its zero-initialised head made non-zero on both sides."""
    flags = TOKEN_FLAGS + ["--K_min", "3", "--levels", "2", "--mode", mode]
    got = capture_jax_step(monkeypatch, jp2.main, flags + ["--steps", "1",
                                                          "--out_dir", str(tmp_path)])
    params = _np(got["state"].params)
    r = np.random.default_rng(0)
    params["out"] = {k: (r.normal(size=v.shape) * 0.1).astype(np.float32)
                     for k, v in params["out"].items()}
    j_loss = got["loss_fn"](jax.tree_util.tree_map(jnp.asarray, params), None, got["batch"],
                            got["key"])[0]
    args = p2.build_argparser().parse_args(flags)
    model = p2.build_token_model(args, torch.device("cpu"), torch.Generator().manual_seed(0))
    model.load_state_dict(params_to_state_dict(params, "video_interp"), strict=True)
    batch = _batch(got)
    B, T, C, H, W = batch["latents"].shape
    draws = phase2_draws_from_key(got["key"], args, B, T, (H // 2) * (W // 2) * C * 4)
    with torch.no_grad():
        loss, _ = p2.phase2_loss(model, None, args, batch, draws)
    assert abs(loss.item() - float(j_loss)) <= F32_TOL * abs(float(j_loss))


def test_phase1_token_model_loss_matches_jax(tmp_path, monkeypatch):
    """--use_wan 0 of the Phase-1 trainer: the VideoTokenKeypointDenoiser's
    eps loss, JAX's four draws handed in."""
    flags = TOKEN_FLAGS + ["--K", "3", "--N_train", "50", "--phase1_input_mode", "short_anchors"]
    got = capture_jax_step(monkeypatch, jp1.main, flags + ["--steps", "1",
                                                          "--out_dir", str(tmp_path)])
    params = _np(got["state"].params)
    j_loss = got["loss_fn"](jax.tree_util.tree_map(jnp.asarray, params), None, got["batch"],
                            got["key"])[0]
    args = p1.build_argparser().parse_args(flags)
    model = p1.build_token_model(args, torch.device("cpu"), torch.Generator().manual_seed(0))
    model.load_state_dict(params_to_state_dict(params, "video_keypoint"), strict=True)
    batch = _batch(got)
    B = batch["latents"].shape[0]
    k_idx, k_t, k_eps, k_drop = jax.random.split(got["key"], 4)
    draws = {"idx_rand": torch.from_numpy(np.array(jax.random.uniform(k_idx, (B, 3)))),
             "t": torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, 50))),
             "eps": torch.from_numpy(np.array(jax.random.normal(k_eps, (B, 3, 16, 16)))),
             "drop_rand": torch.from_numpy(np.array(jax.random.uniform(k_drop, (B,))))}
    with torch.no_grad():
        loss, _ = p1.phase1_loss(model, None, args, make_schedule("linear", 50), batch, draws)
    assert abs(loss.item() - float(j_loss)) <= F32_TOL * abs(float(j_loss))


def test_token_model_precompute_and_eval_match_jax(tmp_path, monkeypatch):
    """JAX's trainers write one-step use_wan 0 checkpoints of both phases on
    the same tar shards; the port's precompute and evaluation read them and
    equal JAX's CLIs on them, JAX's per-batch draws handed in."""
    w = str(tmp_path)
    make_synth_tars.main(["--out_root", f"{w}/data", "--num_samples", "8", "--shard_size", "8",
                          *DATA[:-4], "--text_len", "6", "--text_dim", "32"])
    tar = ["--data", "tar", "--data_root", f"{w}/data"]
    jp1.main(TOKEN_FLAGS + ["--K", "3", "--N_train", "50", "--steps", "1", "--save_every", "1",
                            "--out_dir", f"{w}/p1", *tar])
    prep_argv = ["--ckpt", f"{w}/p1", "--batch", "4", "--ddim_steps", "3", "--bf16", "0", *tar]
    jprep.main(prep_argv + ["--out_root", f"{w}/jax_anchors"])
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(2):            # two batches of 4
        key, k_idx, k_s = jax.random.split(key, 3)
        draws.append({"idx_rand": torch.from_numpy(np.array(jax.random.uniform(k_idx, (4, 3)))),
                      "z": torch.from_numpy(np.array(jax.random.normal(k_s, (4, 3, 16, 16))))})
    monkeypatch.setattr(prep, "make_anchor_draws", lambda *a, **k: draws.pop(0))
    prep.main(prep_argv + ["--out_root", f"{w}/anchors", "--device", "cpu"])
    got = list(iter_tar_samples(f"{w}/anchors/shard_00000.tar"))
    ref = list(iter_tar_samples(f"{w}/jax_anchors/shard_00000.tar"))
    assert [s["__key__"] for s in got] == [s["__key__"] for s in ref]
    np.testing.assert_array_equal(np.stack([s["anchor_idx"] for s in got]),
                                  np.stack([s["anchor_idx"] for s in ref]))
    assert rel_err(np.stack([s["anchors"] for s in got]),
                   np.stack([s["anchors"] for s in ref])) <= F32_TOL

    jp2.main(TOKEN_FLAGS + ["--K_min", "3", "--levels", "2", "--steps", "1", "--save_every", "1",
                            "--out_dir", f"{w}/p2", "--anchors_root", f"{w}/anchors", *tar])
    ev_argv = ["--p2_ckpt", f"{w}/p2", "--data_root", f"{w}/data", "--anchors_root",
               f"{w}/anchors", "--T", "8", "--batch", "2", "--num_batches", "2", "--bf16", "0"]
    ref = jeval.main(ev_argv + ["--out_dir", f"{w}/jax_eval"])
    key, masks = jax.random.PRNGKey(0), []
    for _ in range(2):
        key, k_b = jax.random.split(key)
        masks.append({"mask_rand": torch.from_numpy(np.array(jax.random.uniform(k_b, (2, 8))))})
    monkeypatch.setattr(ev, "make_eval_draws", lambda *a, **k: masks.pop(0))
    got = ev.main(ev_argv + ["--out_dir", f"{w}/eval", "--device", "cpu"])
    for k in ev.MSE_KEYS:
        assert abs(got[k] - ref[k]) <= F32_TOL * abs(ref[k]), (k, got[k], ref[k])
    assert got["refined_gt_mse"] != got["lerp_gt_mse"]      # the one-step head acts
