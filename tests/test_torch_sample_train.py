"""The trainers' sampling-side options against the JAX trainers, on the CPU
in f32, from the same weights, batch and random draws: the Stage-1
rectified-flow objective (`--objective rf`, with and without a ReFlow
teacher) and the Stage-2 bootstrap under `--bootstrap_solver pfdiff|dpm`
and `--bootstrap_best_of > 1` (dp and collision modes).

The setup, the draws JAX made and the tolerances are those of
tests/test_torch_maze_train_trainers.py (loss 1e-5 relative, every leaf's
gradient 1e-4 of its max). The extra draws: rf "tau" = uniform(k_t, (B,)),
"eps" = normal(k_eps, (B, K, D)) or, with a teacher, "reflow_noise" =
normal(split(k_eps)[1], (B, K, D)); best-of "boot_z" = normal(keys[n], (B,
K, D)) over keys = split(k_boot, N).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.ops.schedules import make_schedule as j_make_schedule
from interpolated_diffusion_tpu.train import train_interp_levels as js2
from interpolated_diffusion_tpu.train import train_keypoints as js1
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2
from interpolated_diffusion_tpu_torch.train import train_keypoints as ps1
from interpolated_diffusion_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_maze_train_trainers import (B, T, _check_grads, _s1_setup, _s2_draws, _s2_setup,
                                            t)


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def _save_both(tmp_path, name, jargs, pargs, params, D):
    """The same Stage-1 weights as a JAX checkpoint and as a port one."""
    meta = js1.make_meta(jargs, D)
    assert meta == ps1.make_meta(pargs, D)
    jckpt.save_checkpoint(str(tmp_path / name / "j" / "ckpt_1"),
                          jax.tree.map(jnp.asarray, params), None, 1, None, meta)
    save_checkpoint(str(tmp_path / name / "p" / "ckpt_1"), params_to_state_dict(params, "keypoint"),
                    None, 1, None, meta)
    return str(tmp_path / name / "j"), str(tmp_path / name / "p")


def _rf_draws(rng, args, D, device_policy, reflow):
    out = {}
    if device_policy is not None:
        rng, k_policy = jax.random.split(rng)
        out["policy_rand"] = t(jax.random.uniform(k_policy, (B, T - 2)))
    k_t, k_eps = jax.random.split(rng)
    out["tau"] = t(jax.random.uniform(k_t, (B,)))
    if reflow:
        out["reflow_noise"] = t(jax.random.normal(jax.random.split(k_eps)[1], (B, args.K, D)))
    else:
        out["eps"] = t(jax.random.normal(k_eps, (B, args.K, D)))
    return out


@pytest.mark.parametrize("flags,reflow", [
    (["--objective", "rf"], False),
    (["--objective", "rf", "--logit_space", "1", "--N_train", "1000"], False),
    (["--objective", "rf"], True)], ids=["objective-rf", "objective-rf-logit", "reflow_teacher"])
def test_stage1_rf_loss_and_gradients_match_jax(flags, reflow, tmp_path):
    D = 2
    jargs, pargs, jmodel, params, model, b = _s1_setup(flags, D)
    if reflow:
        # the teacher: other rf weights, saved in both formats
        jt, pt, _, t_params, _, _ = _s1_setup(["--objective", "rf"], D, seed=7)
        jargs.reflow_teacher, pargs.reflow_teacher = _save_both(tmp_path, "teacher", jt, pt,
                                                                t_params, D)
        jargs.reflow_steps = pargs.reflow_steps = 4
    assert ps1.device_policy_of(pargs) == "random"
    jloss = js1.make_loss_fn(jmodel, jargs, j_make_schedule(jargs.schedule, jargs.N_train),
                             "random", reflow_fn=js1.make_reflow_fn(jargs) if reflow else None)
    rng = jax.random.PRNGKey(41)
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in b.items()}, rng)
    ploss = ps1.make_loss_fn(model, pargs, ps1.make_schedule(pargs.schedule, pargs.N_train),
                             "random", ps1.make_reflow_fn(pargs, torch.device("cpu"))
                             if reflow else None)
    loss, _ = ploss(None, {k: t(v) for k, v in b.items()},
                    _rf_draws(rng, pargs, D, "random", reflow))
    _check_grads(model, grads_j, "keypoint", loss, loss_j)


def test_reflow_teacher_must_be_rf(tmp_path):
    jargs, pargs, _, params, _, _ = _s1_setup([], 2)
    _, pargs.reflow_teacher = _save_both(tmp_path, "eps", jargs, pargs, params, 2)
    with pytest.raises(ValueError, match="rf-objective"):
        ps1.make_reflow_fn(pargs, torch.device("cpu"))


@pytest.mark.parametrize("flags", [
    ["--bootstrap_solver", "pfdiff", "--bootstrap_ddim_steps", "6"],
    ["--bootstrap_solver", "dpm"],
    ["--bootstrap_best_of", "4"],
    ["--bootstrap_best_of", "3", "--bootstrap_best_of_mode", "collision",
     "--bootstrap_solver", "dpm"]],
    ids=["bootstrap_solver-pfdiff", "bootstrap_solver-dpm", "bootstrap_best_of-4",
         "bootstrap_best_of-3-collision"])
def test_stage2_bootstrap_solvers_match_jax(flags, tmp_path):
    """As test_stage2_bootstrap_loss_matches_jax, under the other solvers and
    the best-of anchor search: the student anchors, their scatter into x0
    and the student confidence give the JAX loss and gradients."""
    D = 2
    j1, p1, _, kp_params, _, _ = _s1_setup(["--schedule", "cosine"], D, seed=3)
    jdir, pdir = _save_both(tmp_path, "kp", j1, p1, kp_params, D)
    base = ["--anchor_conf", "1", "--pos_clip", "1", "--bootstrap_ddim_steps", "3",
            "--bootstrap_warmup_steps", "2"]
    jargs, pargs, jmodel, params, model, b = _s2_setup(base + flags, D, seed=4)
    jargs.bootstrap_ckpt, pargs.bootstrap_ckpt = jdir, pdir
    host = ps2.host_batch(pargs, b, 0, np.random.RandomState(1))
    host["bootstrap_p"] = np.float32(0.6)
    jsample, _ = js2.make_bootstrap_sampler(jargs, D)
    psample, _ = ps2.make_bootstrap_sampler(pargs, D, torch.device("cpu"))
    jloss = js2.make_loss_fn(jmodel, jargs, jsample)
    rng = jax.random.PRNGKey(71)
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in host.items()}, rng)
    draws = _s2_draws(rng, pargs, D, K_boot=4)
    N = pargs.bootstrap_best_of
    if N > 1:
        k_boot = jax.random.split(rng, 5)[3]
        draws["boot_z"] = t(np.stack([np.asarray(jax.random.normal(k, (B, 4, D)))
                                      for k in jax.random.split(k_boot, N)]))
    loss, _ = ps2.make_loss_fn(model, pargs, psample)(None, {k: t(v) for k, v in host.items()},
                                                      draws)
    _check_grads(model, grads_j, "interp", loss, loss_j)
