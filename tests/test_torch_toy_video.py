"""The port's toy-video slice against the JAX package on the CPU, in f32: the
moving-shapes dataset and decode_latents (bit for bit), the temporal
interpolators (models/interpolators.py; golden `ti/`), the two toy trainers
and the video interpolator trainer (loss and every leaf's gradient on JAX's
own loss_fn, params, batch and draws), the toy sampler end to end on JAX
checkpoints, and the JAX CLIs' `--interpolator tiny` refused by both.

The JAX trainers run as they stand until their first step, whose loss_fn,
params, batch and key are captured (test_torch_interp_train.
capture_jax_step: the flax init is replaced by seeded params in its shapes).

Tolerances: interpolators 1e-5 of the output's scale (golden `ti/`: atol
2e-5, rtol 1e-4, as tests/test_torch_import.py); losses 1e-5 relative,
gradients 1e-4 of each leaf's largest JAX gradient; the sampler's four MSEs
1e-4 relative.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import toy_video as jtoy
from interpolated_diffusion_tpu.diagnostics import eval_interpolators as jeval
from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.models import interpolators as jint
from interpolated_diffusion_tpu.sample import sample_toy_video as jsample
from interpolated_diffusion_tpu.train import train_interp_levels_toy_video as jil
from interpolated_diffusion_tpu.train import train_keypoints_toy_video as jkp
from interpolated_diffusion_tpu.train import train_video_interpolator as jvi
from interpolated_diffusion_tpu_torch.data import toy_video as ptoy
from interpolated_diffusion_tpu_torch.diagnostics import eval_interpolators as peval
from interpolated_diffusion_tpu_torch.models import interpolators as pint
from interpolated_diffusion_tpu_torch.models import loading
from interpolated_diffusion_tpu_torch.models.jax_import import (module_tree_to_state_dict,
                                                                params_to_state_dict,
                                                                tiny_interpolator_to_state_dict)
from interpolated_diffusion_tpu_torch.sample import sample_toy_video as psample
from interpolated_diffusion_tpu_torch.train import train_interp_levels_toy_video as pil
from interpolated_diffusion_tpu_torch.train import train_keypoints_toy_video as pkp
from interpolated_diffusion_tpu_torch.train import train_video_interpolator as pvi
from interpolated_diffusion_tpu_torch.train import train_video_interpolator_wansynth as pviw

from test_torch_interp_train import capture_jax_step
from test_torch_interpolators import japply, jparams, rel
from test_torch_wan_phase2_ops import jax_draws

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_models.npz")
INTERP_TOL, LOSS_TOL, GRAD_TOL, MSE_TOL = 1e-5, 1e-5, 1e-4, 1e-4
TINY = ["--T", "8", "--latent_size", "4", "--num_samples", "16", "--batch", "4",
        "--d_model", "32", "--n_layers", "1", "--n_heads", "2", "--d_ff", "64", "--bf16", "0",
        "--steps", "1", "--save_every", "1", "--log_every", "1"]
CPU = torch.device("cpu")


def _t(x):
    return torch.tensor(np.asarray(x))


# --- data ------------------------------------------------------------------------------------

def test_dataset_and_decode_are_the_jax_ones_bit_for_bit():
    kw = dict(T=6, H=32, n_samples=20, seed=5, latent_size=8, n_objects_range=(1, 3))
    jd, pd = jtoy.MovingShapesVideoDataset(**kw), ptoy.MovingShapesVideoDataset(**kw)
    idx = np.array([0, 3, 7, 19])
    jb, pb = jd.get_batch(idx), pd.get_batch(idx)
    assert jb.keys() == pb.keys() and pd.data_dim == 192
    assert all(np.array_equal(jb[k], pb[k]) and jb[k].dtype == pb[k].dtype for k in jb)
    assert np.array_equal(jtoy.decode_latents(jb["x"], 20), ptoy.decode_latents(pb["x"], 20))
    assert np.array_equal(jtoy.decode_latents(jb["x"][0]), ptoy.decode_latents(pb["x"][0]))
    img = np.random.default_rng(0).normal(size=(2, 3, 9, 13))
    assert np.array_equal(jtoy.bilinear_resize(img, 5, 20), ptoy.bilinear_resize(img, 5, 20))
    assert ptoy.infer_latent_size(768) == 16
    with pytest.raises(ValueError):
        ptoy.infer_latent_size(100)


# --- interpolators ---------------------------------------------------------------------------

def test_tiny_temporal_interpolator_matches_golden_and_jax():
    if not os.path.exists(GOLDEN):
        pytest.skip("model golden file missing (run scripts/make_golden_reference.py)")
    g = np.load(GOLDEN)
    sd = {k[len("ti/sd/"):]: torch.tensor(g[k]) for k in g.files if k.startswith("ti/sd/")}
    pm = pint.TinyTemporalInterpolator(data_dim=12, kernel_size=3, n_layers=2)
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = pm(torch.tensor(g["ti/in/z"]))
    np.testing.assert_allclose(out.numpy(), g["ti/out"], atol=2e-5, rtol=1e-4)
    # against JAX on seeded params, kernel 5, three layers
    z = np.random.default_rng(1).normal(size=(2, 9, 6)).astype(np.float32)
    jm = jint.TinyTemporalInterpolator(data_dim=6, kernel_size=5, n_layers=3)
    params = jparams(jm, z)
    pm = pint.TinyTemporalInterpolator(6, 5, 3)
    pm.load_state_dict(tiny_interpolator_to_state_dict(params), strict=True)
    with torch.no_grad():
        assert rel(pm(torch.tensor(z)), japply(jm, params, z)) <= INTERP_TOL
    with pytest.raises(ValueError, match="odd"):
        pint.TinyTemporalInterpolator(6, 4)


@pytest.mark.parametrize("unc", [True, False])
def test_lerp_residual_interpolator_matches_jax_and_keeps_endpoints(unc):
    r = np.random.default_rng(2)
    z_a, z_b = (r.normal(size=(3, 5, 8)).astype(np.float32) for _ in range(2))
    alpha = np.concatenate([[0.0, 1.0], r.uniform(size=13)]).astype(np.float32).reshape(3, 5)
    jm = jint.LatentLerpResidualInterpolator(data_dim=8, hidden_dim=16, n_layers=3,
                                             with_uncertainty=unc)
    params = jparams(jm, z_a, z_b, alpha)               # res_out non-zero: the gate acts
    ref_z, ref_s = japply(jm, params, z_a, z_b, alpha)
    pm = pint.LatentLerpResidualInterpolator(8, 16, 3, with_uncertainty=unc)
    pm.load_state_dict(module_tree_to_state_dict(params), strict=True)
    with torch.no_grad():
        z, s = pm(torch.tensor(z_a), torch.tensor(z_b), torch.tensor(alpha))
    assert rel(z, ref_z) <= INTERP_TOL
    assert rel(s, ref_s) <= INTERP_TOL if unc else not s.any()
    assert torch.equal(z[0, 0], torch.tensor(z_a[0, 0]))         # alpha 0: exactly z_a
    assert torch.equal(z[0, 1], torch.tensor(z_b[0, 1]))         # alpha 1: exactly z_b
    fresh = pint.LatentLerpResidualInterpolator(8)               # zero-initialised residual
    assert not fresh.res_out.weight.any() and not fresh.res_out.bias.any()


# --- trainers --------------------------------------------------------------------------------

def _compare(jax_loss_fn, params, batch, key, model, port_loss_fn, draws, to_sd):
    """Loss and every leaf's gradient, JAX (one jit) against the port."""
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True))(
        params, batch, key)
    model.load_state_dict(to_sd(params), strict=True)
    leaves = dict(model.named_parameters())
    loss, _ = port_loss_fn({k: torch.tensor(v) for k, v in batch.items()}, draws)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(loss.item() - float(ref_loss)) <= LOSS_TOL * abs(float(ref_loss))
    want = to_sd(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert want.keys() == grads.keys()
    worst = max((np.abs(grads[k].numpy() - want[k].numpy()).max()
                 / max(np.abs(want[k].numpy()).max(), 1e-30), k) for k in want)
    assert worst[0] <= GRAD_TOL, worst


def test_keypoint_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch):
    flags = TINY + ["--K", "4"]
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jkp, jden.KeypointDenoiser, flags + ["--out_dir", str(tmp_path / "j")])
    B, D = batch["x"].shape[0], batch["x"].shape[-1]
    k_idx, k_t, k_eps = jax.random.split(key, 3)
    draws = {"idx_rand": _t(jax.random.uniform(k_idx, (B, 4))),
             "t": _t(jax.random.randint(k_t, (B,), 0, 100)),
             "eps": _t(jax.random.normal(k_eps, (B, 4, D)))}
    args = pkp.build_argparser().parse_args(flags + ["--device", "cpu"])
    state, _, model = pkp.make_trainer(args, CPU, D)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule

    schedule = make_schedule(args.schedule, args.N_train)
    _compare(loss_fn, params, batch, key, model,
             lambda b, d: pkp.keypoint_loss(model, args, schedule, b, d), draws,
             lambda p: params_to_state_dict(p, "keypoint"))


@pytest.mark.parametrize("extra", [
    ["--mode", "adj", "--interp_mode", "smooth"],
    ["--mode", "x0", "--anchor_conf", "0", "--corrupt_mode", "dist", "--w_anchor", "2.0"]])
def test_interp_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch, extra):
    flags = TINY + ["--K_min", "3", "--levels", "2"] + extra
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jil, jden.InterpLevelDenoiser, flags + ["--out_dir", str(tmp_path / "j")])
    B, T, D = batch["x"].shape
    draws = jax_draws(key, B, T, D, 3, 2, adjacent="adj" in extra)
    args = pil.build_argparser().parse_args(flags + ["--device", "cpu"])
    _, _, model = pil.make_trainer(args, CPU, D)
    _compare(loss_fn, params, batch, key, model, lambda b, d: pil.interp_loss(model, args, b, d),
             draws, lambda p: params_to_state_dict(p, "interp"))


def test_video_interpolator_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch):
    flags = ["--T", "8", "--latent_size", "4", "--num_samples", "16", "--batch", "4",
             "--steps", "1", "--K", "3", "--kernel_size", "5"]
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jvi, jint.TinyTemporalInterpolator, flags + ["--out_dir", str(tmp_path)])
    B, T, _ = batch["z"].shape
    args = pvi.build_argparser().parse_args(flags + ["--device", "cpu"])
    model = pvi.build_model(args, CPU)
    _compare(loss_fn, params, batch, key, model,
             lambda b, d: pvi.interpolator_loss(model, args, b, d),
             {"idx_rand": _t(jax.random.uniform(key, (B, T - 2)))},
             tiny_interpolator_to_state_dict)


def test_trainer_clis_flags_run_and_read_back(tmp_path):
    """Every JAX flag with its default (the port adds --device and, where a
    transformer runs, --attn_policy; the sampler's too); each CLI trains two
    steps on the CPU and
    its checkpoint reads back through models/loading (EMA and params), the
    wansynth alias defaults to --workload wansynth."""
    for mod, jmod, extra in ((pkp, jkp, {"device", "attn_policy"}),
                             (pil, jil, {"device", "attn_policy"}),
                             (pvi, jvi, {"device"}), (pviw, jvi, {"device"})):
        ours, theirs = (vars(m.build_argparser().parse_args([])) for m in (mod, jmod))
        assert set(ours) - set(theirs) == extra and {k: ours[k] for k in theirs} == theirs
        assert ours["device"] == "cuda"
    argv = ["--kp_ckpt", "a", "--interp_ckpt", "b"]
    ours, theirs = (vars(m.build_argparser().parse_args(argv)) for m in (psample, jsample))
    assert set(ours) - set(theirs) == {"device", "attn_policy"}
    assert {k: ours[k] for k in theirs} == theirs and ours["attn_policy"] == "fused"
    steps = ["--steps", "2", "--save_every", "2", "--device", "cpu"]
    kp = str(tmp_path / "kp")
    state = pkp.main(TINY + ["--K", "3", "--out_dir", kp] + steps)
    model, meta = loading.load_toy_video_model(kp, "keypoints_toy_video", False, True, "cpu")
    assert meta["stage"] == "keypoints_toy_video" and meta["data_dim"] == 48
    got = dict(model.named_parameters())
    assert all(torch.equal(got[k], state.ema_params[k]) for k in got)
    il = str(tmp_path / "il")
    state = pil.main(TINY + ["--K_min", "3", "--out_dir", il] + steps)
    model, meta = loading.load_toy_video_model(il, "interp_levels_toy_video", False, False, "cpu")
    assert meta["mask_channels"] == 3 and model.mask_channels == 3
    assert all(torch.equal(p, state.params[k]) for k, p in model.named_parameters())
    vi = str(tmp_path / "vi")
    state = pvi.main(["--T", "8", "--latent_size", "4", "--batch", "4", "--out_dir", vi,
                      "--log_every", "1"] + steps)
    model, meta = loading.load_video_interpolator(vi, device="cpu")
    assert meta["workload"] == "toy" and meta["data_dim"] == 48
    assert all(torch.equal(p, state.params[k]) for k, p in model.named_parameters())
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        pkp.main(TINY + ["--device", "cpu", "--n_data_shards", "2"])


# --- sampler end to end ----------------------------------------------------------------------

def fast_init(monkeypatch, *classes):
    """Replace the classes' flax init with seeded params in its shapes."""
    for cls in classes:
        monkeypatch.setattr(cls, "init", lambda self, rngs, *a, method=None, **kw:
                            {"params": jparams(self, *a, method=method, **kw)})


def test_sampler_on_jax_checkpoints_matches_jax(tmp_path, monkeypatch):
    """JAX's trainer CLIs write tiny checkpoints (one step each, seeded params
    in the init's shapes); the port's loaders read them and both
    sample_toy_video CLIs run on the same draws (JAX's, from its keys): the
    four MSEs of the summaries agree. Solver dpm, Stage 2 in adj mode with
    the anchor-confidence channel."""
    fast_init(monkeypatch, jden.KeypointDenoiser, jden.InterpLevelDenoiser)
    kp, il = str(tmp_path / "kp"), str(tmp_path / "il")
    jkp.main(TINY + ["--K", "3", "--out_dir", kp])
    jil.main(TINY + ["--K_min", "3", "--levels", "2", "--out_dir", il])
    argv = ["--kp_ckpt", kp, "--interp_ckpt", il, "--num_batches", "2", "--batch", "3",
            "--ddim_steps", "4", "--solver", "dpm", "--num_samples", "16", "--bf16", "0"]
    ref = jsample.main(argv + ["--out_dir", str(tmp_path / "j")])
    key, draws = jax.random.PRNGKey(1234), []
    for _ in range(2):
        key, k_b = jax.random.split(key)
        _, k_s1, k_s2 = jax.random.split(k_b, 3)
        draws.append({"noise": np.asarray(jax.random.normal(k_s1, (3, 3, 48))),
                      "mask_rand": np.asarray(jax.random.uniform(k_s2, (3, 8)))})
    out = str(tmp_path / "p")
    got = psample.main(argv + ["--out_dir", out, "--device", "cpu"], draws=draws)
    for k in psample.MSE_NAMES:
        name = f"{k}_mse_to_gt"
        assert abs(got[name] - ref[name]) <= MSE_TOL * abs(ref[name]), (name, got, ref)
    assert got["oracle_interp_mse_to_gt"] <= got["interp_mse_to_gt"]
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == got
    panels = np.load(os.path.join(out, "samples.npz"))
    assert panels["gt"].shape == (3, 8, 3, 64, 64) and os.path.exists(
        os.path.join(out, "run_config.json"))
    # the JAX checkpoints through the port's loaders: the converted EMA weights
    from flax import serialization

    with open(os.path.join(kp, "ckpt_1", "ema.msgpack"), "rb") as f:
        ema = serialization.msgpack_restore(f.read())
    model, _ = loading.load_toy_video_model(kp, "keypoints_toy_video", False, True, "cpu")
    want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, ema), "keypoint")
    assert model.state_dict().keys() == want.keys()
    assert all(torch.equal(p, want[k]) for k, p in model.state_dict().items())


def test_both_eval_clis_refuse_tiny(tmp_path):
    """The JAX CLI binds a model only for flow and sinkhorn: `tiny` fails
    before any batch (UnboundLocalError); the port raises, saying so."""
    jm = jint.TinyTemporalInterpolator(data_dim=4)
    from interpolated_diffusion_tpu.utils.checkpoint import save_checkpoint

    ckpt = str(tmp_path / "ckpt_1")
    save_checkpoint(ckpt, jparams(jm, np.zeros((1, 5, 4), np.float32)), None, 1, None,
                    {"stage": "video_interpolator", "T": 5, "K": 3, "kernel_size": 3,
                     "n_layers": 2, "data_dim": 4, "workload": "toy"})
    argv = ["--interpolator", "tiny", "--ckpt", ckpt, "--T", "5", "--K", "3", "--latent_c",
            "1", "--latent_h", "2", "--latent_w", "2", "--batch", "1", "--num_batches", "1"]
    with pytest.raises(UnboundLocalError):
        jeval.main(argv)
    with pytest.raises(NotImplementedError, match="JAX CLI builds no model for tiny"):
        peval.main(argv + ["--device", "cpu"])
    model, meta = loading.load_video_interpolator(ckpt, device="cpu")     # the model loads
    assert meta["stage"] == "video_interpolator" and isinstance(
        model, pint.TinyTemporalInterpolator)
