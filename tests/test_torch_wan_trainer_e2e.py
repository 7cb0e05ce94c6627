"""The Wan Phase-1 trainer as a whole: the JAX package's `main` for two steps
against the port's trainer from the same initial weights, batches and random
draws, and the port's command line end to end on the CPU.

The tiny configuration is the JAX tests' own (T 9, 4 x 8 x 8 latents, text
8 x 64, WanDiT 64d x 2 layers x 2 heads, ffn 128, dense attention, no remat,
batch 2, K 3, N_train 20, f32) with LoRA rank 2 and frame conditioning, the
loop parameter layout and no prefetch thread. The test replays `main`'s key
splits to rebuild its initial parameters and its per-step draws (index jitter,
t, eps, text dropout) and hands them to the port as numbers.

Tolerance: every final LoRA / frame_cond leaf within 1e-4 of the JAX leaf's
max, f32 on both sides, on every element whose gradient was exactly 0 or at
least 1e-6 in magnitude at both steps. Adam's first steps are
u = g / (|g| + eps) with eps = 1e-8: an f32 difference dg in a gradient
element moves u by eps dg / (|g| + eps)^2, which for |g| < 1e-6 and the
~1e-8 absolute noise of these gradients exceeds 1e-4. Such elements (dead
GELU units of the projector feed a few of them) are only held to the bound
of any two Adam steps, 2 lr.
"""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from interpolated_diffusion_tpu.train import train_keypoints_wansynth as jtrainer
from interpolated_diffusion_tpu.train import wansynth_common as jcommon
from interpolated_diffusion_tpu_torch.models import jax_import
from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as ptrainer
from interpolated_diffusion_tpu_torch.train import wansynth_common as pcommon
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.train.state import flatten_dict, tree_leaves
from interpolated_diffusion_tpu_torch.utils.checkpoint import load_checkpoint, read_meta

TINY = ["--num_samples", "12", "--T", "9", "--latent_c", "4", "--latent_h", "8",
        "--latent_w", "8", "--text_len", "8", "--text_dim", "64", "--wan_dim", "64",
        "--wan_layers", "2", "--wan_heads", "2", "--wan_ffn", "128", "--batch", "2",
        "--steps", "2", "--save_every", "2", "--log_every", "1", "--K", "3", "--N_train", "20",
        "--lora_rank", "2"]
PARITY = TINY + ["--attn_mode", "dense", "--use_remat", "0", "--bf16", "0",
                 "--layer_mode", "loop", "--prefetch_depth", "0", "--seed", "0"]
REL_TOL = 1e-4


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _jax_initial_state(args):
    """main's initial (wan params, trainable tree) and the key it carries on,
    from the same key splits (train_keypoints_wansynth.main)."""
    C, H, W, L_in = args.latent_c, args.latent_h, args.latent_w, args.K
    rng = jax.random.PRNGKey(args.seed)
    rng, k_init, k_tr = jax.random.split(rng, 3)
    wan = jcommon.build_wan(args, bool(args.bf16))
    wan_params = wan.init(k_init, jnp.zeros((1, C, L_in, H, W)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 8, args.text_dim)), jnp.zeros((1, L_in), jnp.int32),
                          jnp.zeros((1, L_in, args.text_dim)))["params"]
    trainable, _, _ = jcommon.init_wan_trainables(k_tr, args, wan_params, bool(args.bf16))
    return wan_params, trainable, rng


def _jax_draws(key, args, z_shape):
    """The draws of main's loss_fn for the step key `key`, as torch tensors."""
    k_idx, k_t, k_eps, k_drop = jax.random.split(key, 4)
    B = args.batch
    t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt)
    return {"idx_rand": t(jax.random.uniform(k_idx, (B, args.K))),
            "t": t(jax.random.randint(k_t, (B,), 0, args.N_train), torch.long),
            "eps": t(jax.random.normal(k_eps, z_shape, dtype=jnp.float32)),
            "drop_rand": t(jax.random.uniform(k_drop, (B,)))}


def test_two_steps_match_jax_main(tmp_path, capsys):
    j_state = jtrainer.main(PARITY + ["--out_dir", str(tmp_path / "jax")])
    ref = jax.tree_util.tree_map(np.asarray, dict(j_state.params))
    j_log = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]

    j_args = jtrainer.build_argparser().parse_args(PARITY)
    wan_params, trainable0, rng = _jax_initial_state(j_args)
    sd, fc_sd = jax_import.wan_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, wan_params),
        frame_cond=jax.tree_util.tree_map(np.asarray, trainable0["frame_cond"]))

    args = ptrainer.build_argparser().parse_args(PARITY + ["--device", "cpu"])
    # the same flags, but for --device and the port's own backbone choice (--dit, --hy_*)
    hy = argparse.ArgumentParser()
    pcommon.add_hunyuan_args(hy)
    port_only = {"device"} | set(vars(hy.parse_args([])))
    assert {k: v for k, v in vars(args).items() if k not in port_only} == vars(j_args)
    device = torch.device("cpu")
    wan, fc = pcommon.build_wan(args, False, generator=torch.Generator().manual_seed(0))
    wan.load_state_dict(sd, strict=True)
    fc.load_state_dict(fc_sd, strict=True)
    state, base, train_step, _, _ = ptrainer.make_trainer(args, device, wan, fc)
    loader = pcommon.make_wansynth_loader(args, args.seed)
    N, D_tok = (args.latent_h // 2) * (args.latent_w // 2), args.latent_c * 4
    schedule = make_schedule(args.schedule, args.N_train)
    leaves = tree_leaves(state.params)
    losses, settled = [], [torch.ones_like(p, dtype=torch.bool) for p in leaves]
    for _ in range(args.steps):
        batch = {k: torch.tensor(v) for k, v in next(loader).items()}
        rng, key = jax.random.split(rng)
        draws = _jax_draws(key, j_args, (args.batch, args.K, N, D_tok))
        loss, _ = ptrainer.phase1_loss(wan, fc, args, schedule, batch, draws)
        for m, g in zip(settled, torch.autograd.grad(loss, leaves)):
            m &= (g == 0) | (g.abs() >= 1e-6)
        state, metrics = train_step(state, base, batch, draws)
        losses.append(float(metrics["loss"]))

    def to_jax_layout(values):
        named = dict(zip(flatten_dict(state.params), values))
        pick = lambda pre: {k[len(pre):]: v for k, v in named.items() if k.startswith(pre)}
        return traverse_util.flatten_dict(
            {"lora": jax_import.lora_to_params(pick("lora/")),
             "frame_cond": jax_import.frame_cond_to_params(pick("frame_cond/"))})

    flat_ref, flat_got = traverse_util.flatten_dict(ref), to_jax_layout(leaves)
    flat_settled = to_jax_layout([m.float() for m in settled])
    assert flat_ref.keys() == flat_got.keys() and len(flat_ref) == 2 * 10 * 2 + 4
    for k, want in flat_ref.items():
        d = np.abs(flat_got[k].astype(np.float64) - want)
        tol = REL_TOL * np.abs(want).max()
        bound = np.where(flat_settled[k] > 0, tol, max(tol, 2 * args.lr))
        assert (d <= bound).all(), ("/".join(k), d.max(), tol)
    moved = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, trainable0))
    assert all(not np.array_equal(moved[k], flat_got[k]) for k in flat_got)   # every leaf trained
    # the logged losses are the same numbers (4 decimals in the log line)
    assert [f"{x:.4f}" for x in losses] == [l.split()[3] for l in j_log], (losses, j_log)


@pytest.mark.parametrize("mode", ["full", "short_anchors", "short_midpoints", "short_meanpool"])
def test_cli_end_to_end_on_cpu(tmp_path, capsys, mode):
    """The port's command line with its own generator: bf16, SLA through the
    twins, remat, EMA; log lines, run_config.json, the checkpoint and its meta."""
    out = str(tmp_path / mode)
    argv = TINY + ["--device", "cpu", "--attn_mode", "sla", "--sla_block", "64", "--sla_topk",
                   "0.5", "--phase1_input_mode", mode, "--use_ema", "1", "--out_dir", out]
    state = ptrainer.main(argv)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert len(lines) == 2 and all("s/step" in l and "samples/s" in l and "frames/s" in l
                                   for l in lines)
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
    assert state.step == 2
    cfg = json.load(open(os.path.join(out, "run_config.json")))
    assert cfg["args"]["phase1_input_mode"] == mode and cfg["meta"]["wan_head_mod"] == "t_emb"
    step, meta = read_meta(os.path.join(out, "ckpt_2"))
    assert step == 2 and meta["data_state"]["batches"] >= 2 and meta["lora_rank"] == 2
    _, payload = load_checkpoint(os.path.join(out, "ckpt_2"))
    assert set(payload["params"]) == {"lora", "frame_cond", "wan_base"} and "ema" in payload
    saved, live = flatten_dict(payload["params"]["lora"]), flatten_dict(state.params["lora"])
    assert saved.keys() == live.keys() and all(torch.equal(saved[k], live[k]) for k in saved)
    assert all(v.dtype == torch.float32 for v in saved.values())             # f32 masters
    assert all(v.dtype == torch.bfloat16 for v in payload["params"]["wan_base"].values())


def test_cli_resume_continues_from_checkpoint(tmp_path, capsys):
    out = str(tmp_path / "run")
    argv = TINY + ["--device", "cpu", "--attn_mode", "dense", "--bf16", "0", "--out_dir", out]
    first = ptrainer.main(argv)
    capsys.readouterr()
    resumed = ptrainer.main(argv + ["--steps", "3", "--resume", out])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert [l.split()[1] for l in lines] == ["2"] and resumed.step == 3
    assert read_meta(os.path.join(out, "ckpt_3"))[0] == 3
    # the resumed run started from the saved leaves, not from the seed's
    _, payload = load_checkpoint(os.path.join(out, "ckpt_2"))
    a = flatten_dict(payload["params"]["lora"])
    b = flatten_dict(first.params["lora"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = flatten_dict(resumed.params["lora"])
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_cli_trains_every_weight_under_bf16(tmp_path):
    """--lora_rank 0 --bf16 1: every WanDiT weight is an f32 master computing
    in bf16; two steps move every one of them, and the checkpoint holds them
    in f32 under "wan" (no frozen base)."""
    out = str(tmp_path / "full")
    args = ptrainer.build_argparser().parse_args(
        TINY + ["--device", "cpu", "--attn_mode", "dense", "--lora_rank", "0", "--bf16", "1",
                "--frame_cond", "0", "--out_dir", out])
    wan, _ = pcommon.build_wan(args, bf16=True, generator=torch.Generator().manual_seed(args.seed))
    before = {k: v.detach().float().clone() for k, v in wan.named_parameters()}
    state = ptrainer.main(TINY + ["--device", "cpu", "--attn_mode", "dense", "--lora_rank", "0",
                                  "--bf16", "1", "--frame_cond", "0", "--out_dir", out])
    leaves = state.params["wan"]
    assert set(state.params) == {"wan"} and leaves.keys() == before.keys()
    assert all(p.dtype == torch.float32 for p in leaves.values())
    still = [k for k, p in leaves.items() if torch.equal(p.detach(), before[k])
             and ".sla." not in k]
    assert not still, still[:3]
    _, payload = load_checkpoint(os.path.join(out, "ckpt_2"))
    assert set(payload["params"]) == {"wan"}
    assert all(v.dtype == torch.float32 for v in payload["params"]["wan"].values())


def test_cli_refuses_what_is_not_ported(tmp_path):
    """What the CLI took as not ported now runs: --ckpt_async 1 writes the
    port's sharded checkpoint (read back by load_checkpoint), --ffn_mode moe
    builds Switch-MoE blocks; --n_data_shards 2 in one process names torchrun."""
    base = TINY + ["--device", "cpu", "--out_dir", str(tmp_path / "x")]
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        ptrainer.main(base + ["--n_data_shards", "2"])
    state = ptrainer.main(base + ["--ckpt_async", "1", "--ffn_mode", "moe", "--n_experts", "2",
                                  "--attn_mode", "dense", "--use_remat", "0", "--bf16", "0"])
    ckpt = str(tmp_path / "x" / "ckpt_2")
    header = json.load(open(os.path.join(ckpt, "meta.json")))
    assert header["format"] == "torch_sharded" and header["meta"]["ffn_mode"] == "moe"
    _, payload = load_checkpoint(ckpt)
    saved = flatten_dict(payload["params"])
    assert any(".moe_ffn.ffn_in" in k for k in saved)
    for k, p in flatten_dict(state.params).items():
        assert torch.equal(saved[k], p.detach())
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: nothing to refuse")
        ptrainer.main(TINY + ["--out_dir", str(tmp_path / "y")])   # --device defaults to cuda
