"""The port's Wan Phase-2 chain on the JAX package's checkpoints and CLIs, on
the CPU in f32: the Phase-1 anchor precompute (data/precompute_phase1_
anchors.py), the Phase-2 loss (train/train_interp_levels_wansynth.py) and the
level-loop evaluation (diagnostics/eval_wansynth_stage2.py), each held to
the JAX package's own code on runs/wansynth_debug's checkpoints with JAX's
draws handed in; and the whole chain end to end on the port alone.

The fixtures runs/wansynth_debug/{p1,p2}/ckpt_2 predate the trainers'
`wan_base` save and the meta's lora_alpha: they hold the merged-form LoRA
tree and the frame projector only. The JAX CLIs would build their base from
their own seeded initialisation, and cannot read them as they stand (flax
refuses a template with keys the file lacks). So each JAX run here has its
checkpoint read patched to take the file's trees beside the template's
base, and the port is handed that same base (models/loading.
load_wansynth_model(base=...)). Nothing else is patched on the JAX side.

Tolerances, as max|port - jax| / max|jax|: 1e-4 with dense attention (the
same f32 arithmetic, other sum order); 2^-8 of the scale where attention runs
through SLA's bf16 contract in both packages (tests/test_torch_wan_model.py).
"""
import functools
import json
import os
import shutil
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from interpolated_diffusion_tpu.data import precompute_phase1_anchors as jprep
from interpolated_diffusion_tpu.diagnostics import eval_wansynth_stage2 as jeval
from interpolated_diffusion_tpu.ops import keyframes as jkf
from interpolated_diffusion_tpu_torch.data import make_synth_tars
from interpolated_diffusion_tpu_torch.data import precompute_phase1_anchors as prep
from interpolated_diffusion_tpu_torch.data.wan_synth import (SyntheticWanDataset,
                                                             iter_tar_samples, write_tar_shard)
from interpolated_diffusion_tpu_torch.diagnostics import eval_wansynth_stage2 as ev
from interpolated_diffusion_tpu_torch.models import loading
from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
from interpolated_diffusion_tpu_torch.train import train_interp_levels_wansynth as p2
from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
from interpolated_diffusion_tpu_torch.utils import checkpoint as pckpt

from test_torch_wan_phase2_ops import rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "runs", "wansynth_debug")
P1, P2, ANCHORS = (os.path.join(FIX, n) for n in ("p1/ckpt_2", "p2/ckpt_2", "anchors"))
F32_TOL, BF16_TOL = 1e-4, 2.0 ** -8


def _jax_reads_fixture(monkeypatch, module, bases):
    """Patch `module.load_checkpoint` (and its read_meta for the p2 meta's
    missing lora_alpha) so that the JAX CLI reads a fixture's trees and keeps
    its template's base; the base is appended to `bases`."""
    def load_checkpoint(path, tmpl, *a, **k):
        with open(os.path.join(path, "params.msgpack"), "rb") as f:
            raw = serialization.msgpack_restore(f.read())
        raw["wan_base"] = tmpl["wan_base"]
        bases.append(jax.tree_util.tree_map(np.asarray, tmpl["wan_base"]))
        return 2, {"params": raw}

    read_meta = module.read_meta
    monkeypatch.setattr(module, "load_checkpoint", load_checkpoint)
    monkeypatch.setattr(module, "read_meta",
                        lambda path: (lambda s, m: (s, {"lora_alpha": 16.0, **m}))(*read_meta(path)))


def _port_base(monkeypatch, base):
    """The port's loader gets the JAX run's base for a checkpoint without one."""
    sd, _ = wan_params_to_state_dict(base)
    monkeypatch.setattr(loading, "load_wansynth_model",
                        functools.partial(loading.load_wansynth_model, base=sd))


def _tar(path):
    with tarfile.open(path) as tf:
        return [m.name for m in tf.getmembers()]


# ---------------------------------------------------------------------------
# the Phase-1 anchor precompute
# ---------------------------------------------------------------------------

def test_precompute_cli_writes_the_fixture_shard_layout(tmp_path):
    """At prep_config.json's settings the port's CLI writes a shard with the
    members, fields, shapes and dtypes of anchors_00000.tar."""
    with open(os.path.join(ANCHORS, "prep_config.json")) as f:
        cfg = json.load(f)["args"]
    out = str(tmp_path / "anchors")
    with pytest.warns(UserWarning):          # no wan_base, no wan_head_mod stamp
        res = prep.main(["--device", "cpu", "--ckpt", P1, "--out_root", out,
                         "--num_samples", str(cfg["num_samples"]), "--batch", str(cfg["batch"]),
                         "--shard_size", str(cfg["shard_size"]),
                         "--ddim_steps", str(cfg["ddim_steps"]), "--seed", str(cfg["seed"]),
                         "--bf16", str(cfg["bf16"])])
    fixture = os.path.join(ANCHORS, "anchors_00000.tar")
    assert res["n_shards"] == 1 and os.listdir(out) == ["anchors_00000.tar", "prep_config.json"] \
        or sorted(os.listdir(out)) == ["anchors_00000.tar", "prep_config.json"]
    assert _tar(os.path.join(out, "anchors_00000.tar")) == _tar(fixture)
    for a, b in zip(iter_tar_samples(os.path.join(out, "anchors_00000.tar")),
                    iter_tar_samples(fixture)):
        assert a["__key__"] == b["__key__"] and set(a) == set(b)
        for k in ("anchors", "anchor_idx"):
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
        assert np.all(np.diff(a["anchor_idx"]) > 0) and np.isfinite(a["anchors"]).all()
    with open(os.path.join(out, "prep_config.json")) as f:
        prep_cfg = json.load(f)
    assert set(prep_cfg) == {"args", "meta", "samples_per_sec"}
    assert prep_cfg["meta"]["stage"] == "keypoints_wansynth"


@pytest.mark.parametrize("solver,extra", [
    ("ddim", []), ("pfdiff", []), ("dpm", []), ("ddim", ["--cache_interval", "2"]),
    ("dpm", ["--attn_mode", "sla", "--sla_topk_schedule", "0.5:0.05,1.0:0.1"])])
def test_precompute_anchors_match_jax(tmp_path, monkeypatch, solver, extra):
    """The port's CLI on the p1 fixture against JAX's CLI, JAX's draws (the
    anchor jitter's uniforms and the initial noise from its keys) handed in:
    the same shard, anchors within 1e-4 (2^-8 under sla). The top-k schedule
    under dpm splits the multistep solver's history at the segment boundary
    as JAX does (the fixture's 48 tokens are one SLA block, so the top-k
    itself cannot act here; test_topk_schedule_runs_each_segment_under_its_topk
    holds that)."""
    argv = ["--ckpt", P1, "--num_samples", "4", "--batch", "4", "--ddim_steps", "4",
            "--bf16", "0", "--solver", solver, *extra]
    bases = []
    _jax_reads_fixture(monkeypatch, jprep, bases)
    jprep.main(argv + ["--out_root", str(tmp_path / "jax")])
    key = jax.random.PRNGKey(0)
    _, k_idx, k_s = jax.random.split(key, 3)
    draws = {"idx_rand": torch.from_numpy(np.array(jax.random.uniform(k_idx, (4, 3)))),
             "z": torch.from_numpy(np.array(jax.random.normal(k_s, (4, 3, 16, 16))))}
    monkeypatch.setattr(prep, "make_anchor_draws", lambda *a, **k: draws)
    _port_base(monkeypatch, bases[0])
    prep.main(argv + ["--out_root", str(tmp_path / "port"), "--device", "cpu"])
    got = list(iter_tar_samples(str(tmp_path / "port" / "anchors_00000.tar")))
    ref = list(iter_tar_samples(str(tmp_path / "jax" / "anchors_00000.tar")))
    assert [s["__key__"] for s in got] == [s["__key__"] for s in ref]
    np.testing.assert_array_equal(np.stack([s["anchor_idx"] for s in got]),
                                  np.stack([s["anchor_idx"] for s in ref]))
    assert rel_err(np.stack([s["anchors"] for s in got]),
                   np.stack([s["anchors"] for s in ref])) <= (
        BF16_TOL if "sla" in extra else F32_TOL)


def test_topk_schedule_runs_each_segment_under_its_topk(monkeypatch):
    """--sla_topk_schedule: the grid splits into contiguous segments that
    share their end points, each solved under its own SLA top-k on the same
    weights (here 3 key blocks of 128, so top-k 0.34 keeps 1 and 0.7 keeps
    2), and the model's own top-k comes back afterwards."""
    from interpolated_diffusion_tpu_torch.ops.ddpm import make_timesteps
    from interpolated_diffusion_tpu_torch.sample import wan_anchors
    from interpolated_diffusion_tpu_torch.train.wansynth_common import build_wan, \
        wan_args_from_meta

    assert prep.parse_topk_schedule("0.5:0.3,1.0:0.6") == [(0.5, 0.3), (1.0, 0.6)]
    assert prep.parse_topk_schedule("") is None
    for bad in ("0.5:0.3,0.4:0.6", "0.5:0.3"):
        with pytest.raises(ValueError):
            prep.parse_topk_schedule(bad)
    times = make_timesteps(20, 5, "quadratic")
    cut = round(0.5 * (len(times) - 1))
    segs = wan_anchors.topk_segments(times, [(0.5, 0.34), (1.0, 0.7)])
    assert [(list(t), k) for t, k in segs] == [(list(times[:cut + 1]), 0.34),
                                               (list(times[cut:]), 0.7)]
    ns = wan_args_from_meta(dict(wan_dim=64, wan_layers=2, wan_heads=2, wan_ffn=128, latent_c=4,
                                 text_dim=32, T=9, lora_rank=0, frame_cond=1, attn_mode="sla",
                                 sla_topk=0.1), sla_block=128)
    wan, fc = build_wan(ns, False, generator=torch.Generator().manual_seed(0),
                        zero_init_scale=0.1)
    base = dict(T=9, K=3, latent_c=4, latent_h=16, latent_w=32, n_train=20, ddim_steps=5)
    gen = torch.Generator().manual_seed(1)
    z, idx = torch.randn(2, 3, 128, 16, generator=gen), torch.tensor([[0, 4, 8], [1, 2, 7]])
    text = torch.randn(2, 4, 32, generator=gen)
    seen, run = [], wan_anchors.run_solver

    def recording(solver, eps_fn, z0, seg_times, *a, **k):
        seen.append((list(seg_times), wan.blocks[1].attn1.sla.topk))
        return run(solver, eps_fn, z0, seg_times, *a, **k)

    monkeypatch.setattr(wan_anchors, "run_solver", recording)
    out = {}
    for name, sched in (("schedule", [(0.5, 0.34), (1.0, 0.7)]), ("low", [(1.0, 0.34)]),
                        ("high", [(1.0, 0.7)])):
        sampler = wan_anchors.make_anchor_sampler(
            wan_anchors.AnchorConfig(**base, topk_schedule=sched), wan, fc)
        out[name] = sampler(z, idx, text)
        assert wan.blocks[0].attn1.sla.topk == 0.1
    assert seen[:2] == [(list(times[:cut + 1]), 0.34), (list(times[cut:]), 0.7)]
    assert not torch.allclose(out["low"], out["high"])        # the top-k acts
    assert not torch.allclose(out["schedule"], out["low"])
    assert not torch.allclose(out["schedule"], out["high"])
    wan.set_attn_mode("dense")
    with pytest.raises(ValueError, match="sla/sage_sla"):
        wan_anchors.make_anchor_sampler(
            wan_anchors.AnchorConfig(**base, topk_schedule=[(1.0, 0.5)]), wan, fc)
    with pytest.raises(ValueError, match="pick one"):
        wan_anchors.make_anchor_sampler(
            wan_anchors.AnchorConfig(**base, solver="pfdiff", cache_interval=2), wan, fc)


# ---------------------------------------------------------------------------
# the level-loop evaluation on the p2 fixture
# ---------------------------------------------------------------------------

def _fixture_data(root):
    """The 8 synthetic clips the anchor fixture was sampled for (the p1 run's
    data: T 9, 4 x 8 x 8 latents, text dim 64), as one data shard under the
    anchor shard's basename, which is how the key join pairs them."""
    ds = SyntheticWanDataset(8, T=9, C=4, H=8, W=8, text_len=8, text_dim=64, seed=0)
    write_tar_shard(os.path.join(root, "anchors_00000.tar"),
                    [{"__key__": f"{i:08d}", **ds.get(i)} for i in range(8)])


def test_p2_fixture_loads_and_its_eval_matches_jax(tmp_path, monkeypatch):
    """runs/wansynth_debug/p2/ckpt_2 through the port's reader, then the
    evaluation CLI on one batch against JAX's `run` (its main), JAX's masks
    handed in."""
    step, payload = pckpt.load_checkpoint(P2, with_opt_state=False)
    assert step == 2 and set(payload["params"]) == {"lora", "frame_cond"}
    assert len(payload["params"]["lora"]) == 2 * 10 * 2      # 2 layers x 10 Linears x A, B
    data = str(tmp_path / "data")
    _fixture_data(data)
    argv = ["--p2_ckpt", P2, "--data_root", data, "--anchors_root", ANCHORS, "--T", "9",
            "--batch", "2", "--num_batches", "1", "--bf16", "0"]
    bases = []
    _jax_reads_fixture(monkeypatch, jeval, bases)
    ref = jeval.main(argv + ["--out_dir", str(tmp_path / "jax")])
    key = jax.random.PRNGKey(0)
    _, k_b = jax.random.split(key)
    rand = torch.from_numpy(np.array(jax.random.uniform(k_b, (2, 9))))
    monkeypatch.setattr(ev, "make_eval_draws", lambda *a, **k: {"mask_rand": rand})
    _port_base(monkeypatch, bases[0])
    with pytest.warns(UserWarning):
        got = ev.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    for k in ev.MSE_KEYS:
        assert abs(got[k] - ref[k]) <= F32_TOL * abs(ref[k]), (k, got[k], ref[k])
    assert got["stage2_helps_gt"] == ref["stage2_helps_gt"]
    assert got["stage2_helps_p1"] == ref["stage2_helps_p1"]
    with open(tmp_path / "port" / "summary.json") as f:
        assert set(json.load(f)) == set(ref)
    # JAX's masks are the port's from the same uniforms
    idx = np.stack([s["anchor_idx"] for s in iter_tar_samples(
        os.path.join(ANCHORS, "anchors_00000.tar"))])[:2]
    jm, _ = jkf.build_nested_masks_from_base(k_b, jnp.asarray(idx), 9, 2)
    from interpolated_diffusion_tpu_torch.ops.keyframes import build_nested_masks_from_base

    pm, _ = build_nested_masks_from_base(torch.from_numpy(idx).long(), 9, 2, rand=rand)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


# ---------------------------------------------------------------------------
# the chain on the port alone
# ---------------------------------------------------------------------------

DATA = ["--T", "8", "--latent_c", "4", "--latent_h", "8", "--latent_w", "8", "--text_len", "6",
        "--text_dim", "32"]
NET = ["--wan_dim", "64", "--wan_layers", "2", "--wan_heads", "2", "--wan_ffn", "128",
       "--lora_rank", "2", "--sla_block", "64", "--sla_topk", "0.5", "--device", "cpu"]


def test_tiny_chain_end_to_end(tmp_path):
    """make_synth_tars -> the Phase-1 trainer -> precompute (tar mode: anchor
    shards under the data shards' names) -> the Phase-2 trainer (2 steps,
    resumed to 3) -> the evaluation, each with --device cpu."""
    w = str(tmp_path)
    assert make_synth_tars.main(["--out_root", f"{w}/data", "--num_samples", "8",
                                 "--shard_size", "4", *DATA[:-4], "--text_len", "6",
                                 "--text_dim", "32"]) == 2
    p1.main(["--steps", "2", "--K", "3", "--data", "tar", "--data_root", f"{w}/data",
             "--out_dir", f"{w}/p1", *DATA, *NET])
    res = prep.main(["--device", "cpu", "--ckpt", f"{w}/p1", "--out_root", f"{w}/anchors",
                     "--data", "tar", "--data_root", f"{w}/data", "--batch", "4",
                     "--ddim_steps", "2", "--bf16", "0"])
    assert res["n_shards"] == 2 and sorted(os.listdir(f"{w}/anchors")) == [
        "prep_config.json", "shard_00000.tar", "shard_00001.tar"]
    common = ["--K_min", "3", "--data", "tar", "--data_root", f"{w}/data", "--anchors_root",
              f"{w}/anchors", "--out_dir", f"{w}/p2", "--log_every", "1", *DATA, *NET]
    p2.main(common + ["--steps", "2"])
    state = p2.main(common + ["--steps", "3", "--resume", f"{w}/p2"])
    assert state.step == 3
    assert sorted(os.listdir(f"{w}/p2")) == ["ckpt_2", "ckpt_3", "run_config.json"]
    step, payload = pckpt.load_checkpoint(f"{w}/p2/ckpt_3", with_opt_state=False)
    assert step == 3 and set(payload["params"]) == {"lora", "frame_cond", "wan_base"}
    assert payload["meta"]["stage"] == "interp_levels_wansynth" and "data_state" in payload["meta"]
    summary = ev.main(["--p2_ckpt", f"{w}/p2", "--data_root", f"{w}/data", "--anchors_root",
                       f"{w}/anchors", "--T", "8", "--num_batches", "2", "--bf16", "0",
                       "--out_dir", f"{w}/eval", "--device", "cpu"])
    with open(f"{w}/eval/summary.json") as f:
        assert json.load(f) == summary
    assert all(np.isfinite(summary[k]) for k in ev.MSE_KEYS)
    assert summary["p2_ckpt"].endswith("ckpt_3")
    shutil.rmtree(w)


def test_clis_default_to_cuda_and_refuse_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only refusal does not apply")
    for mod, argv in ((prep, ["--ckpt", P1, "--out_root", str(tmp_path)]),
                      (p2, ["--steps", "1", "--out_dir", str(tmp_path)]),
                      (ev, ["--p2_ckpt", P2, "--data_root", ANCHORS, "--anchors_root", ANCHORS])):
        assert mod.build_argparser().parse_args(argv).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        p2.main(["--n_data_shards", "2", "--device", "cpu"])
