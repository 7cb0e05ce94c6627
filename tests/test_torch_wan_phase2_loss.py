"""The port's Wan Phase-2 loss (train/train_interp_levels_wansynth.py)
against the JAX trainer's own loss_fn, on the CPU in f32, at the weights of
runs/wansynth_debug/p2/ckpt_2: under dense attention the loss and every
trainable leaf's gradient, under SLA the loss. (--use_wan 0 is in
tests/test_torch_wan_phase2_tokens.py.)

Each JAX trainer's main runs as it stands until its first step, whose
arguments (loss_fn, state, frozen base, batch, key) are captured; JAX's
draws come from that key by the loss_fn's own splits and are handed to the
port. The fixture predates the trainers' `wan_base` save, so the port gets
the JAX run's base (see tests/test_torch_wan_phase2_cli.py).

Tolerances, as |port - jax| / |jax|: 1e-4 with dense attention (the same
f32 arithmetic, other sum order); 2^-8 where attention runs through SLA's
bf16 contract in both packages.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from interpolated_diffusion_tpu.train import state as jstate
from interpolated_diffusion_tpu.train import train_interp_levels_wansynth as jp2
from interpolated_diffusion_tpu_torch.models import loading
from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
from interpolated_diffusion_tpu_torch.models.lora import leaves_to_tree
from interpolated_diffusion_tpu_torch.train import train_interp_levels_wansynth as p2

from test_torch_wan_phase2_ops import jax_draws, rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P2 = os.path.join(ROOT, "runs", "wansynth_debug", "p2", "ckpt_2")
F32_TOL, BF16_TOL = 1e-4, 2.0 ** -8
# the p2 fixture's run_config.json: the data and model it was trained on
P2_FLAGS = ["--K_min", "3", "--levels", "2", "--T", "9", "--latent_c", "4", "--latent_h", "8",
            "--latent_w", "8", "--text_len", "8", "--text_dim", "64", "--wan_dim", "64",
            "--wan_layers", "2", "--wan_heads", "2", "--wan_ffn", "128", "--lora_rank", "2",
            "--lora_alpha", "16", "--lora_form", "merged", "--layer_mode", "loop", "--bf16", "0",
            "--batch", "2", "--prefetch_depth", "0"]


class _Stop(Exception):
    pass


def capture_jax_step(monkeypatch, main, argv):
    """Run a JAX trainer's main until its first step: (loss_fn, state, frozen,
    batch, key) as that step would have received them."""
    got = {}

    def make_train_step_frozen(loss_fn, tx, ema_decay=0.999):
        def step(state, frozen, batch, key):
            got.update(loss_fn=loss_fn, state=state, frozen=frozen, batch=batch, key=key)
            raise _Stop
        return step

    monkeypatch.setattr(jstate, "make_train_step_frozen", make_train_step_frozen)
    with pytest.raises(_Stop):
        main(argv)
    return got


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(got):
    return {k: torch.from_numpy(np.array(v)) for k, v in got["batch"].items()}


def phase2_draws_from_key(key, args, B, T, D):
    """make_phase2_draws' layout from the JAX loss_fn's key splits."""
    k_corr, k_drop = jax.random.split(key)
    return {"corr": jax_draws(k_corr, B, T, D, args.K_min, args.levels, args.mode == "adj"),
            "drop_rand": torch.from_numpy(np.array(jax.random.uniform(k_drop, (B,))))}


@pytest.mark.parametrize("attn_mode", ["dense", "sla"])
def test_phase2_loss_at_the_p2_weights_matches_jax(tmp_path, monkeypatch, attn_mode):
    flags = P2_FLAGS + ["--attn_mode", attn_mode, "--sla_block", "32", "--sla_topk", "0.5",
                        "--use_remat", "0", "--cond_drop_prob", "0.5"]
    got = capture_jax_step(monkeypatch, jp2.main, flags + ["--steps", "1",
                                                          "--out_dir", str(tmp_path)])
    with open(os.path.join(P2, "params.msgpack"), "rb") as f:
        trees = jax.tree_util.tree_map(jnp.asarray, serialization.msgpack_restore(f.read()))
    loss_fn = functools.partial(got["loss_fn"], frozen=got["frozen"], batch=got["batch"],
                                rng=got["key"])
    if attn_mode == "dense":   # f32 throughout: XLA keeps no excess precision to mind
        j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p)[0]))(trees)
    else:
        j_loss = loss_fn(trees)[0]
    sd, _ = wan_params_to_state_dict(_np(got["frozen"]))
    with pytest.warns(UserWarning):          # the fixture meta has no wan_head_mod stamp
        wan, fc, _ = loading.load_wansynth_model(P2, "interp_levels_wansynth", False, "cpu",
                                                 base=sd, frame_cond=1, frame_cond_dim=7,
                                                 attn_mode=attn_mode, sla_block=32, sla_topk=0.5)
    args = p2.build_argparser().parse_args(flags)
    batch = _batch(got)
    B, T, C, H, W = batch["latents"].shape
    draws = phase2_draws_from_key(got["key"], args, B, T, (H // 2) * (W // 2) * C * 4)
    leaves = {**{f"lora/{k}": p for k, p in wan.named_parameters() if "lora" in k},
              **{f"frame_cond/{k}": p for k, p in fc.named_parameters()}}
    for p in leaves.values():
        p.requires_grad_(True)
    loss, _ = p2.phase2_loss(wan, fc, args, batch, draws)
    tol = F32_TOL if attn_mode == "dense" else BF16_TOL
    assert abs(loss.item() - float(j_loss)) <= tol * abs(float(j_loss))
    if attn_mode == "dense":
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        port = leaves_to_tree({k[5:]: g for k, g in grads.items() if k.startswith("lora/")})
        for path, ab in j_grads["lora"].items():
            for leaf in ("A", "B"):
                assert rel_err(port[path][leaf].numpy(), ab[leaf]) <= F32_TOL, (path, leaf)
        for name, p in j_grads["frame_cond"].items():
            assert rel_err(grads[f"frame_cond/{name}.weight"].numpy().T, p["kernel"]) <= F32_TOL
            assert rel_err(grads[f"frame_cond/{name}.bias"].numpy(), p["bias"]) <= F32_TOL
