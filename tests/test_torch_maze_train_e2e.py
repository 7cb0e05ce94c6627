"""The port's maze trainers end to end through their CLIs, on the CPU
(`--device cpu`) at the tiny sizes of tests/test_train_e2e.py: Stage 1 train
and resume, Stage 2 adj with the anchor-confidence channel and `dist`
corruption, Stage 2 x0, Stage 2 with `--bootstrap_ckpt`, then the
checkpoints through models/loading.py into the port's make_pipeline. No JAX
is needed here: parity with the JAX trainers is in
tests/test_torch_maze_train_trainers.py.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu_torch.models.loading import (load_interp_model,
                                                              load_keypoint_model, resolve_ckpt)
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.sample.generate import PipelineConfig, make_pipeline
from interpolated_diffusion_tpu_torch.train import train_interp_levels, train_keypoints
from interpolated_diffusion_tpu_torch.utils.checkpoint import load_checkpoint

TINY = ["--device", "cpu", "--T", "32", "--batch", "16", "--num_samples", "64",
        "--d_model", "32", "--n_layers", "2", "--n_heads", "2", "--d_ff", "64",
        "--maze_channels", "8,8", "--maze_h", "9", "--maze_w", "9",
        "--log_every", "2", "--bf16", "0", "--steps_per_call", "1"]
S2 = TINY + ["--K_min", "4", "--levels", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Stage 1 trained 4 steps, resumed to 6; the Stage-2 runs train from it."""
    root = tmp_path_factory.mktemp("maze_e2e")
    kp = str(root / "kp")
    state4 = train_keypoints.main(TINY + ["--K", "4", "--steps", "4", "--save_every", "4",
                                          "--out_dir", kp])
    return root, kp, state4


def _ckpt_ok(path, step, stage):
    assert os.path.exists(os.path.join(path, "meta.json"))
    got_step, payload = load_checkpoint(path)
    assert got_step == step and payload["meta"]["stage"] == stage
    assert payload["params"].keys() == payload["ema"].keys() and "opt_state" in payload
    assert all(torch.isfinite(v).all() for v in payload["params"].values())
    return payload


def test_stage1_train_and_resume(runs, capsys):
    root, kp, state4 = runs
    assert state4.step == 4
    p4 = _ckpt_ok(os.path.join(kp, "ckpt_4"), 4, "keypoints")
    cfg = json.load(open(os.path.join(kp, "run_config.json")))
    assert cfg["meta"]["K"] == 4 and cfg["args"]["device"] == "cpu" and cfg["n_params"] > 0
    # the EMA moved away from the parameters (decay 0.999, 4 steps)
    assert any(not torch.equal(p4["params"][k], p4["ema"][k]) for k in p4["params"])
    state6 = train_keypoints.main(TINY + ["--K", "4", "--steps", "6", "--save_every", "6",
                                          "--out_dir", kp, "--resume", kp])
    out = capsys.readouterr().out
    assert "resumed from" in out and "@ step 4" in out and "step 6 loss" in out
    assert state6.step == 6 and state6.opt_state.count == 6
    p6 = _ckpt_ok(os.path.join(kp, "ckpt_6"), 6, "keypoints")
    assert any(not torch.equal(p4["params"][k], p6["params"][k]) for k in p4["params"])
    assert resolve_ckpt(kp).endswith("ckpt_6")


def test_resume_restores_parameters_ema_and_optimizer_state(tmp_path):
    """A run resumed at its last step (nothing left to do) holds the
    checkpoint's parameters, EMA and Adam moments, not its own --seed's."""
    out = str(tmp_path / "kp")
    a = train_keypoints.main(TINY + ["--K", "4", "--steps", "3", "--save_every", "3",
                                     "--out_dir", out])
    b = train_keypoints.main(TINY + ["--K", "4", "--steps", "3", "--save_every", "3",
                                     "--out_dir", out, "--resume", out, "--seed", "5"])
    assert b.step == 3 and b.opt_state.count == 3
    for k in a.params:   # --seed 5 initialised other weights; the checkpoint replaced them
        assert torch.equal(a.params[k], b.params[k]) and torch.equal(a.ema_params[k],
                                                                      b.ema_params[k])
    sa, sb = a.opt_state.adamw.state_dict()["state"], b.opt_state.adamw.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)


def test_stage2_adj_anchor_conf_dist_corruption(runs):
    root = runs[0]
    out = str(root / "il")
    state = train_interp_levels.main(S2 + [
        "--mode", "adj", "--anchor_conf", "1", "--anchor_conf_anneal", "1",
        "--corrupt_mode", "dist", "--corrupt_sigma_max", "0.05",
        "--steps", "3", "--save_every", "3", "--out_dir", out])
    assert state.step == 3
    payload = _ckpt_ok(os.path.join(out, "ckpt_3"), 3, "interp_levels")
    assert payload["meta"]["mask_channels"] == 3 and payload["meta"]["anchor_conf"] == 1
    # the zero-initialised head trained
    assert float(payload["params"]["out.weight"].abs().max()) > 0


def test_stage2_x0_with_grad_accum_and_superbatch(runs):
    root = runs[0]
    out = str(root / "il_x0")
    flags = [a for a in S2 if a not in ("--steps_per_call", "1")]
    state = train_interp_levels.main(flags + [
        "--steps_per_call", "2", "--grad_accum", "2", "--mode", "x0", "--mask_policy", "uniform",
        "--steps", "3", "--save_every", "2", "--out_dir", out])
    assert state.step == 3 and state.opt_state.count == 3     # exactly --steps optimizer steps
    assert os.path.isdir(os.path.join(out, "ckpt_2")) and os.path.isdir(os.path.join(out, "ckpt_3"))
    assert _ckpt_ok(os.path.join(out, "ckpt_3"), 3, "interp_levels")["meta"]["mask_channels"] == 1


def test_stage2_bootstrap_then_pipeline(runs):
    """Stage 2 with --bootstrap_ckpt, then both checkpoints (EMA weights)
    through models/loading.py into make_pipeline."""
    root, kp, _ = runs
    if not os.path.isdir(os.path.join(kp, "ckpt_4")):
        pytest.fail("the Stage-1 run left no checkpoint")
    out = str(root / "il_boot")
    train_interp_levels.main(S2 + [
        "--mode", "adj", "--bootstrap_ckpt", kp, "--bootstrap_ddim_steps", "3",
        "--bootstrap_warmup_steps", "1", "--pos_clip", "1",
        "--steps", "2", "--save_every", "2", "--out_dir", out])
    kp_model, kp_meta = load_keypoint_model(kp, bf16=False, device="cpu")
    it_model, it_meta = load_interp_model(out, bf16=False, device="cpu")
    assert kp_meta["stage"] == "keypoints" and it_meta["stage"] == "interp_levels"
    assert not any(p.requires_grad for p in kp_model.parameters()) and not kp_model.training
    # EMA by default: the loaded weights are ema.pt, not params.pt
    _, payload = load_checkpoint(resolve_ckpt(out))
    assert torch.equal(it_model.state_dict()["in_proj.weight"], payload["ema"]["in_proj.weight"])
    raw, _ = load_interp_model(out, bf16=False, use_ema=False, device="cpu")
    assert torch.equal(raw.state_dict()["in_proj.weight"], payload["params"]["in_proj.weight"])

    T, K, B = kp_meta["T"], kp_meta["K"], 5
    cfg = PipelineConfig(T=T, K=K, levels=it_meta["levels"], K_min=it_meta["K_min"], ddim_steps=4,
                         stage2_mode=it_meta["mode"], pos_clip=True)
    pipe = make_pipeline(kp_model, it_model, make_schedule(kp_meta["schedule"], kp_meta["N_train"]),
                         cfg, kp_meta["data_dim"])
    r = np.random.default_rng(0)
    inner = np.stack([np.sort(r.choice(np.arange(1, T - 1), K - 2, replace=False))
                      for _ in range(B)])
    idx = torch.tensor(np.concatenate([np.zeros((B, 1), int), inner, np.full((B, 1), T - 1)], 1))
    cond = {"occ": torch.tensor((r.uniform(size=(B, 1, 9, 9)) < 0.2).astype(np.float32)),
            "start_goal": torch.tensor(r.uniform(size=(B, 4)).astype(np.float32))}
    x_interp, x_ref, z_pred = pipe(idx, cond, generator=torch.Generator().manual_seed(0))
    assert x_interp.shape == x_ref.shape == (B, T, 2) and z_pred.shape == (B, K, 2)
    assert all(bool(torch.isfinite(v).all()) for v in (x_interp, x_ref, z_pred))
    assert torch.equal(x_ref[:, 0], cond["start_goal"][:, :2])
    assert torch.equal(x_ref[:, -1], cond["start_goal"][:, 2:])


def test_loaders_refuse_the_wrong_stage_and_unported_metas(runs, tmp_path):
    root, kp, _ = runs
    with pytest.raises(ValueError, match="interp_levels"):
        load_interp_model(kp, device="cpu")
    with pytest.raises(FileNotFoundError):
        resolve_ckpt(str(tmp_path))
    from interpolated_diffusion_tpu_torch.utils.checkpoint import read_meta, save_checkpoint

    # a causal meta is no longer refused: Stage 1 ignores `causal`, as the JAX
    # loader does (models/loading.py), and loads the same weights
    path = resolve_ckpt(kp)
    _, meta = read_meta(path)
    _, payload = load_checkpoint(path)
    save_checkpoint(str(tmp_path / "ckpt_1"), payload["params"], None, 1, payload["ema"],
                    dict(meta, causal=1))
    model, got = load_keypoint_model(str(tmp_path), device="cpu")
    want, _ = load_keypoint_model(kp, device="cpu")
    assert got["causal"] == 1
    for (n, a), (_, b) in zip(model.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), n


def test_loaders_default_to_the_card():
    """Like every other entry point of the port, the loaders put the model on
    the card unless the caller asks for the CPU."""
    from interpolated_diffusion_tpu_torch.models.loading import (load_segment_cost_model,
                                                                 load_selector_model,
                                                                 make_dphi_seg_cost_fn)

    for loader in (load_keypoint_model, load_interp_model, load_selector_model,
                   load_segment_cost_model, make_dphi_seg_cost_fn):
        assert inspect.signature(loader).parameters["device"].default == "cuda", loader.__name__


def test_bf16_compute_keeps_f32_masters(tmp_path):
    """--bf16 1 on the CPU: f32 master parameters, bf16 compute, f32 gradients
    and optimizer state; the loaded model computes in bf16 too."""
    out = str(tmp_path / "kp16")
    flags = [a for a in TINY if a not in ("--bf16", "0")]
    state = train_keypoints.main(flags + ["--bf16", "1", "--K", "4", "--steps", "2",
                                          "--save_every", "2", "--out_dir", out])
    assert all(p.dtype == torch.float32 for p in state.params.values())
    adam = state.opt_state.adamw.state_dict()["state"]
    assert all(s["exp_avg"].dtype == torch.float32 for s in adam.values())
    model, _ = load_keypoint_model(out, bf16=True, device="cpu")
    assert model.dtype == torch.bfloat16 and model.in_proj.weight.dtype == torch.float32
    assert model.transformer.layers[0].compute_dtype == torch.bfloat16
