"""The tuning registry (kernels/tuning.py) and the Muon optimizer
(train/state.make_optimizer(optimizer="muon")) of the port against the JAX
package.

Registry: every function's choice equals JAX's under the same environment
(no registry, the TPU registry docs/attn_autotune.json, registries that
exercise the guards: no best_grad -> best_fwd fallback, L < 8 * block,
G clamped to [1, 64], ID_TPU_FUSED_ROWS / ID_TPU_SMALL_ATTN, unreadable
files), with both modules' lru_cache cleared; the CLIs' --attn_policy
default and WanAttention's SLA block and flash tiles follow it.

Muon: optax.contrib.muon (as JAX's make_optimizer builds it, behind the
global-norm clip) against the port on a tiny maze Stage-2 tree: the leaf
labels are the same set, and three updates from JAX's own gradients leave
every leaf within 1e-5 of its max; two steps through the trainer's step
(loss, draws and EMA included) hold to the trainer tests' bound; the state
round-trips through state_dict().

utils/seed.py, utils/logging.py and utils/profiling.py: the same host draws
and scalars.jsonl lines as the JAX modules; time_fn leaves its warm-up out
of the timing; trace writes a torch.profiler trace.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.train import state as jstate
from interpolated_diffusion_tpu.train import train_interp_levels as js2
from interpolated_diffusion_tpu_torch.kernels import tuning as pt
from interpolated_diffusion_tpu_torch.models.jax_import import (
    matrix_layout,
    params_to_state_dict,
)
from interpolated_diffusion_tpu_torch.train import state as pstate
from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2
from test_torch_interpolators import jparams
from test_torch_maze_train_trainers import CORRUPT, _batch, _s2_draws, _s2_setup, _Step, _two_steps

jt = importlib.import_module("interpolated_diffusion_tpu.kernels.tuning")
ENV_VARS = ("ID_TPU_ATTN_TUNE", "ID_TPU_SMALL_ATTN", "ID_TPU_FUSED_ROWS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    yield
    jt._load.cache_clear()
    pt._load.cache_clear()


def _env(monkeypatch, tmp_path, registry=None, **env):
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    if isinstance(registry, dict):
        path = tmp_path / "reg.json"
        path.write_text(json.dumps(registry))
        registry = str(path)
    if registry is not None:
        monkeypatch.setenv("ID_TPU_ATTN_TUNE", registry)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jt._load.cache_clear()
    pt._load.cache_clear()


REGISTRIES = [
    (None, {}),
    ("docs/attn_autotune.json", {}),
    ({"flash": {"best_fwd": "1024x1024"}, "sla": {"best_grad": "128x128"},
      "sage_sla": {"best_fwd": "64x64"}, "small_attn": {"best": "full", "fused_rows": 256}}, {}),
    ({"flash": {"best_grad": "bad"}, "sla": {"best_grad": "x"},
      "small_attn": {"best": "weird", "fused_rows": -3}},
     {"ID_TPU_SMALL_ATTN": "group", "ID_TPU_FUSED_ROWS": "128"}),
    ({"small_attn": {"fused_rows": 100000}}, {"ID_TPU_FUSED_ROWS": "8"}),
    ("does/not/exist.json", {"ID_TPU_SMALL_ATTN": "none", "ID_TPU_FUSED_ROWS": "abc"}),
    (None, {"ID_TPU_SMALL_ATTN": "block", "ID_TPU_FUSED_ROWS": "4096"}),
]


@pytest.mark.parametrize("registry,env", REGISTRIES)
def test_registry_choices_match_jax(registry, env, monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path, registry, **env)
    calls = [("flash_blocks", (), {}), ("flash_blocks", (), {"prefer": "best_fwd"}),
             ("flash_blocks", (256, 512), {}), ("small_attn_policy", (), {}),
             ("small_attn_policy", ("none",), {})]
    calls += [("fused_group_b", (L,), {}) for L in (1, 4, 8, 64, 128, 1000)]
    calls += [("fused_group_b", (64, 1024), {})]
    calls += [("sla_blocks", (d, q, p, L), {}) for d in (128, 256) for q in ("none", "int8")
              for p in ("best_grad", "best_fwd") for L in (None, 1000, 4096, 32760)]
    for name, a, kw in calls:
        assert getattr(pt, name)(*a, **kw) == getattr(jt, name)(*a, **kw), (name, a, kw)


def test_tpu_registry_at_the_wan_geometry(monkeypatch, tmp_path):
    """docs/attn_autotune.json: the SLA model at L 32760 takes block 512 in
    both packages (256 below 8 blocks a row), the flash tiles 512 x 2048, and
    the small-attention policy block."""
    _env(monkeypatch, tmp_path, "docs/attn_autotune.json")
    for mod in (jt, pt):
        assert mod.sla_blocks(256, "none", L=32760) == mod.sla_blocks(256, "int8", L=32760) == 512
        assert mod.sla_blocks(256, "none", L=4000) == 256
        assert mod.flash_blocks() == (512, 2048)
        assert mod.small_attn_policy() == "block"
    assert pt.attn_policy_arg(pt.REGISTRY) == "block"


@pytest.mark.parametrize("registry,env,want", [
    (None, {}, "fused"),
    ({"small_attn": {"best": "full"}}, {}, "dense"),
    ({"small_attn": {"best": "group"}}, {}, "dense"),
    (None, {"ID_TPU_SMALL_ATTN": "none"}, "dense"),
    (None, {"ID_TPU_SMALL_ATTN": "block"}, "block"),
])
def test_cli_attn_policy_default_follows_the_registry(registry, env, want, monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path, registry, **env)
    p = ps2.build_argparser()
    assert p.parse_args([]).attn_policy == want
    assert p.parse_args(["--attn_policy", "fused"]).attn_policy == "fused"   # the flag wins
    from interpolated_diffusion_tpu_torch.sample import generate

    assert generate.build_argparser().parse_args(
        ["--kp_ckpt", "a", "--interp_ckpt", "b"]).attn_policy == want


def test_unknown_small_attention_policy_raises(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path, None, ID_TPU_SMALL_ATTN="packed")
    with pytest.raises(ValueError, match="packed"):
        pt.attn_policy_arg(pt.REGISTRY)


def test_wan_attention_takes_the_registry_blocks(monkeypatch, tmp_path):
    """WanAttention's SLA block comes from the registry where L >= 8 blocks,
    else its configured block; its flash tiles stay the defaults under any
    registry (the CUDA kernel tiles by its own design)."""
    from interpolated_diffusion_tpu_torch.kernels import sla as psla
    from interpolated_diffusion_tpu_torch.models import wan_dit

    seen = []
    real_map, real_flash = psla.get_block_map, wan_dit.flash_attention
    monkeypatch.setattr(psla, "get_block_map",
                        lambda q, k, topk, bq, bk: seen.append(("sla", bq, bk)) or
                        real_map(q, k, topk, bq, bk))
    monkeypatch.setattr(wan_dit, "flash_attention",
                        lambda q, k, v, bm, bn: seen.append(("flash", bm, bn)) or
                        real_flash(q, k, v, bm, bn))
    torch.manual_seed(0)
    sla = wan_dit.WanAttention(128, 1, "sla", sla_topk=0.5, sla_block=128)
    dense = wan_dit.WanAttention(128, 1, "dense")
    x512, x2048 = torch.randn(1, 512, 128), torch.randn(1, 2048, 128)
    for registry, want in ((None, [("sla", 128, 128), ("sla", 128, 128), ("flash", 512, 1024)]),
                           ({"sla": {"best_grad": "64x64"}, "flash": {"best_grad": "256x2048"}},
                            [("sla", 64, 64), ("sla", 128, 128), ("flash", 512, 1024)])):
        _env(monkeypatch, tmp_path, registry)
        seen.clear()
        sla(x512)
        sla(x512[:, :256])          # 256 < 8 * 64: the configured block
        dense(x2048)
        assert seen == want


# --- Muon ---------------------------------------------------------------------------

def _labels_by_torch_name(params):
    """optax.contrib.muon's labels ('muon' for 2-D leaves), in the port's
    names: each leaf filled with its label, through the converter."""
    filled = jax.tree.map(lambda x: np.full(x.shape, float(np.ndim(x) == 2), np.float32), params)
    sd = params_to_state_dict(filled, "interp")
    return {n: "muon" if bool((t == 1).all()) else "adam" for n, t in sd.items()}


@pytest.fixture(scope="module")
def stage2():
    """(jargs, pargs, JAX model, JAX params, port model, batch) of a tiny
    maze Stage-2 model with anchor confidence and corruption (its init drawn
    from numpy in the flax init's shapes: a flax init compiles every
    primitive op by op, or one large program under jit)."""
    from interpolated_diffusion_tpu.models.denoisers import InterpLevelDenoiser

    def init(self, key, *args, **kw):
        return {"params": jparams(self, *args, seed=12, **kw)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(InterpLevelDenoiser, "init", init)
        return _s2_setup(["--anchor_conf", "1", "--n_layers", "1"] + CORRUPT, 2, seed=12)


def test_muon_matches_optax_over_three_steps(stage2):
    """Three updates of the tiny Stage-2 tree from the same seeded gradients
    (numpy; clipped, unclipped, clipped) on each side."""
    params = stage2[3]
    tx = jstate.make_optimizer(1e-2, 0.1, 1.0, optimizer="muon")
    jp = jax.tree.map(jnp.asarray, params)
    jst = tx.init(jp)
    got = {n: t.clone() for n, t in params_to_state_dict(params, "interp").items()}
    popt = pstate.make_optimizer(1e-2, 0.1, 1.0, optimizer="muon")(got)
    assert popt.labels == _labels_by_torch_name(params)
    assert set(popt.labels.values()) == {"muon", "adam"}
    names = list(popt.labels)
    update = jax.jit(tx.update)
    r = np.random.default_rng(5)
    for scale in (0.3, 1e-4, 1.0):
        grads = jax.tree.map(lambda p: (scale * r.normal(size=p.shape)).astype(np.float32), params)
        upd, jst = update(jax.tree.map(jnp.asarray, grads), jst, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        g_sd = params_to_state_dict(grads, "interp")
        popt.update([g_sd[n] for n in names])
    want = params_to_state_dict(jax.tree.map(np.asarray, jp), "interp")
    for n in names:
        err = float((got[n].detach() - want[n]).abs().max())
        assert err <= 1e-5 * float(want[n].abs().max()), (n, popt.labels[n], err)
    start = params_to_state_dict(params, "interp")
    assert all(not torch.equal(got[n].detach(), start[n]) for n in names)


def test_muon_train_step_matches_jax(stage2):
    """Two steps of the Stage-2 trainer's step under Muon (the trainer's
    make_trainer(optimizer="muon")), against JAX's train step with optax's
    Muon: loss, gradient norm, parameters and EMA."""
    jargs, pargs, jmodel, params, model, _ = stage2
    jloss = js2.make_loss_fn(jmodel, jargs)
    tx = jstate.make_optimizer(jargs.lr, jargs.weight_decay, jargs.grad_clip, optimizer="muon")
    pargs.steps_per_call = 1
    pst, _, _ = ps2.make_trainer(pargs, torch.device("cpu"), 2, model, optimizer="muon")
    assert isinstance(pst.opt_state, pstate.Muon)
    pstep = _Step(ps2.make_loss_fn(model, pargs), 0.9)
    rngs = [jax.random.PRNGKey(90), jax.random.PRNGKey(91)]
    _two_steps(jloss, tx, params, model, "interp", pst, pstep, [_batch(2, 8), _batch(2, 9)],
               rngs, [_jit_s2_draws(r, pargs, 2) for r in rngs], pargs.lr)


def _jit_s2_draws(rng, args, D):
    """The trainers' _s2_draws under one jit (op by op, each shape of each
    level compiles its own program): the same draws."""
    import test_torch_maze_train_trainers as trainers

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainers, "t", lambda a: a)
        arrays = jax.jit(lambda r: _s2_draws(r, args, D))(rng)
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), arrays)


def test_muon_state_round_trips():
    """Saved after two of four updates and restored into a fresh optimizer
    over the saved parameters, Muon ends where the uninterrupted run ends."""
    torch.manual_seed(0)
    p0 = {"a.weight": torch.randn(6, 4), "a.bias": torch.randn(6),
          "level_emb.weight": torch.randn(3, 5)}
    grads = [[torch.randn_like(v) for v in p0.values()] for _ in range(4)]
    clone = lambda d: {k: v.clone() for k, v in d.items()}
    tx = pstate.make_optimizer(1e-2, warmup_steps=2, optimizer="muon")
    whole = clone(p0)
    opt = tx(whole)
    for g in grads:
        opt.update(g)
    part = clone(p0)
    first = tx(part)
    for g in grads[:2]:
        first.update(g)
    saved, snapshot = first.state_dict(), clone(part)
    first.update(grads[2])          # the saved state is a copy: later updates leave it alone
    resumed = clone(snapshot)
    second = tx(resumed)
    second.load_state_dict(saved)
    assert second.count == 2
    for g in grads[2:]:
        second.update(g)
    for k in p0:
        assert torch.equal(resumed[k], whole[k]), k


def test_matrix_layout_follows_the_converters():
    assert matrix_layout("transformer.layers.0.attn.in_proj_weight", (96, 32)) == "T"
    assert matrix_layout("transformer.layers.0.attn.out_proj.weight", (32, 32)) == "T"
    assert matrix_layout("blocks.0.attn.in_proj_weight", (96, 32)) is None   # flax MHA
    assert matrix_layout("blocks.0.attn.out_proj.weight", (32, 32)) is None
    assert matrix_layout("blocks.0.attn1.to_q.weight", (32, 32)) == "T"
    assert matrix_layout("lora/blocks.0.attn1.to_q.lora_A", (4, 32)) == "T"
    assert matrix_layout("patch_embedding.weight", (32, 4, 1, 2, 2)) == "T"
    assert matrix_layout("level_emb.weight", (8, 32)) == "N"
    assert matrix_layout("blocks.0.moe_ffn.ffn_in_bias", (8, 64)) == "N"
    assert matrix_layout("blocks.0.moe_ffn.ffn_in", (8, 32, 64)) is None
    assert matrix_layout("blocks.0.scale_shift_table", (1, 6, 32)) is None
    assert matrix_layout("cond_enc.maze.convs.0.weight", (8, 1, 3, 3)) is None
    assert matrix_layout("norm1.weight", (32,)) is None
    with pytest.raises(ValueError, match="unknown optimizer"):
        pstate.make_optimizer(1e-3, optimizer="sgd")


# --- utils/seed.py, utils/logging.py, utils/profiling.py ------------------------------

def test_set_seed_pins_the_host_generators_as_jax(monkeypatch):
    import os
    import random

    from interpolated_diffusion_tpu.utils import seed as jseed
    from interpolated_diffusion_tpu_torch.utils import seed as pseed

    # recorded so that the test's environment comes back as it was
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    draws = []
    for mod in (jseed, pseed):
        mod.set_seed(123)
        draws.append((os.environ["PYTHONHASHSEED"], random.random(), float(np.random.rand())))
    assert draws[0] == draws[1]
    pseed.set_seed(7)
    a = torch.rand(3)
    pseed.set_seed(7)
    assert torch.equal(a, torch.rand(3))           # torch's generator too
    monkeypatch.setenv("SEED", "42")
    assert pseed.get_seed_from_env() == jseed.get_seed_from_env() == 42
    try:
        pseed.set_seed(0, deterministic=True)
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(False)


def test_metric_writer_writes_the_jax_lines(tmp_path, monkeypatch):
    """The JSONL sink (TensorBoard left out: importing it takes ~10 s)."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from interpolated_diffusion_tpu.utils.logging import create_writer as jwriter
    from interpolated_diffusion_tpu_torch.utils.logging import create_writer as pwriter

    lines = []
    for name, make in (("j", jwriter), ("p", pwriter)):
        w = make(str(tmp_path / name))
        w.add_scalar("loss", np.float32(0.25), 1)
        w.add_scalar("lr", 1e-3, 2)
        w.close()
        recs = [json.loads(x) for x in open(tmp_path / name / "scalars.jsonl")]
        lines.append([{k: v for k, v in r.items() if k != "time"} for r in recs])
    assert lines[0] == lines[1] == [{"tag": "loss", "value": 0.25, "step": 1},
                                    {"tag": "lr", "value": 1e-3, "step": 2}]
    pwriter(None).add_scalar("x", 1.0, 0)           # no directory: a no-op sink


def test_profiling_times_without_warmup_and_writes_a_trace(tmp_path):
    from interpolated_diffusion_tpu_torch.utils.profiling import time_fn, trace

    calls = []
    secs, out = time_fn(lambda x: calls.append(x) or len(calls), 5, iters=4, warmup=3)
    assert len(calls) == 7 and out == 7 and secs >= 0.0
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "prof" / "trace.json").is_file()
    assert any("mm" in e.key for e in prof.key_averages())
