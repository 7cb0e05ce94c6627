"""The port's Switch-MoE FFN (models/moe.py), expert parallelism
(parallel/ep.py) and WanDiT ffn_mode="moe" against the JAX package, in f32
on the CPU.

- SwitchFFN on the JAX module's weights: output and aux loss 1e-5 of their
  scale, every gradient of mean(y^2) + 0.01 aux 1e-4 of its scale (the port
  scatters into [E, C, D] buffers where JAX contracts [N, E, C] one-hots:
  each output element has one nonzero term either way); with a capacity
  that drops tokens (their rows are zero, as JAX's) too.
- The JAX package's own checks: at most E tokens pass at C = 1, and the aux
  loss is at least its uniform-routing minimum 1.
- Expert parallelism over two gloo ranks (tests/torch_dist_workers.py):
  every rank's output rows, the aux loss and the gradients (the router's
  summed over ranks, each expert slice from its owner) equal one process's
  (1e-5 / 1e-4).
- WanDiT ffn_mode="moe" through models/jax_import against the JAX WanDiT
  (1e-4; the scan layout converts to the loop layout's state dict); the
  Phase-1 trainer CLI with --ffn_mode moe records the MoE config in its
  meta and its checkpoint loads back.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models.moe import SwitchFFN as JSwitchFFN
from interpolated_diffusion_tpu_torch.models.moe import SwitchFFN
from torch_dist_workers import spawn

DIM, FFN, E = 16, 32, 4


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pair(capacity_factor, seed, shape=(2, 6, DIM)):
    """(JAX module, its params with a non-zero bias, port module, x)."""
    jm = JSwitchFFN(dim=DIM, ffn_dim=FFN, n_experts=E, capacity_factor=capacity_factor)
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    # random weights of the module's shapes (jax.eval_shape: no op-by-op flax init)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed), x)["params"]
    r = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: (r.normal(size=a.shape) / np.sqrt(a.shape[-2] if len(a.shape) > 1 else 10)
                   ).astype(np.float32), shapes)
    pm = SwitchFFN(DIM, FFN, E, capacity_factor)
    pm.load_state_dict(_state_dict(params))
    return jm, params, pm, x


def _state_dict(params):
    sd = {"router.weight": params["router"]["kernel"].T, "router.bias": params["router"]["bias"]}
    sd.update({k: params[k] for k in ("ffn_in", "ffn_in_bias", "ffn_out")})
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_switch_ffn_matches_jax(capacity_factor):
    jm, params, pm, x = _pair(capacity_factor, seed=0)

    def jloss(p):
        y, aux = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    (_, (y_j, aux_j)), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    y, aux = pm(torch.tensor(x))
    assert y.shape == x.shape and rel(y.detach(), y_j) <= 1e-5
    assert abs(float(aux.detach()) - float(aux_j)) <= 1e-5 * float(aux_j)
    if capacity_factor < 1:     # C = 3 < 12 / 4 * 2: some tokens are dropped, rows zero
        dropped = np.abs(np.asarray(y_j)).reshape(-1, DIM).max(-1) == 0
        assert dropped.any() and not dropped.all()
        assert (y.detach().reshape(-1, DIM)[torch.tensor(dropped)] == 0).all()
    (y.pow(2).mean() + 0.01 * aux).backward()
    want = _state_dict(jax.tree_util.tree_map(np.asarray, g_j))
    for name, p in pm.named_parameters():
        assert rel(p.grad, want[name]) <= 1e-4, name


def test_switch_ffn_capacity_and_aux_checks():
    """The JAX package's own checks: at C = 1 at most E tokens produce output;
    the aux loss is at least its uniform-routing minimum 1."""
    _, _, pm, x = _pair(0.01, seed=2, shape=(1, 12, DIM))
    with torch.no_grad():
        y, _ = pm(torch.tensor(x))
    assert int((y.abs().amax(-1) > 1e-9).sum()) <= E
    _, _, pm, x = _pair(8.0, seed=4, shape=(4, 8, DIM))
    with torch.no_grad():
        _, aux = pm(torch.tensor(x))
    assert float(aux) >= 1.0 - 1e-6


def test_expert_parallel_matches_replicated(tmp_path):
    """Experts split over two gloo ranks, each with its own 12 of 24 tokens."""
    _, params, pm, x = _pair(1.25, seed=6, shape=(24, DIM))
    y, aux = pm(torch.tensor(x))
    ((y ** 2).sum() + 0.01 * aux).backward()
    payload = {"shape": (DIM, FFN, E, 1.25), "x": x,
               "sd": {k: v.numpy() for k, v in _state_dict(params).items()}}
    res = [r[0] for r in spawn([("expert_parallel", payload)], 2, tmp_path)]
    assert rel(np.concatenate([r["y"] for r in res]), y.detach()) <= 1e-5
    assert all(abs(r["aux"] - float(aux.detach())) <= 1e-6 * float(aux.detach()) for r in res)
    grads = dict(pm.named_parameters())
    for name in ("router.weight", "router.bias"):
        assert rel(sum(r["grads"][name] for r in res), grads[name].grad) <= 1e-4, name
    for name in ("ffn_in", "ffn_in_bias", "ffn_out"):
        got = np.concatenate([r["grads"][name] for r in res])
        assert rel(got, grads[name].grad) <= 1e-4, name


def test_wan_dit_moe_matches_jax():
    """The JAX WanDiT with Switch-MoE blocks (loop layout, one jit) against the
    port on its weights (1e-4); the scan layout, the same blocks stacked,
    converts to the same state dict."""
    from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
    from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
    from interpolated_diffusion_tpu_torch.models.wan_dit import WanDiT

    cfg = dict(dim=32, n_layers=2, n_heads=2, ffn_dim=64, in_channels=4, out_channels=4,
               text_dim=16, freq_dim=16, ffn_mode="moe", n_experts=4, capacity_factor=2.0)
    jm = JWanDiT(layer_mode="loop", dtype=jnp.float32, **cfg)
    r = np.random.default_rng(3)
    lat = r.normal(size=(2, 4, 2, 4, 4)).astype(np.float32)
    t = np.array([999, 111], np.int32)
    ctx = r.normal(size=(2, 5, 16)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), lat, t, ctx)["params"]

    def fill(path, a):
        if path[-1].key == "scale":
            return (1 + 0.05 * r.normal(size=a.shape)).astype(np.float32)
        fan_in = a.shape[-2] if len(a.shape) > 1 else 10
        return (r.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, lat, t, ctx))
    sd, _ = wan_params_to_state_dict(params)
    pm = WanDiT(**cfg).eval()
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = pm(torch.tensor(lat), torch.tensor(t), torch.tensor(ctx))
    assert out.shape == ref.shape and rel(out, ref) <= 1e-4, rel(out, ref)
    blocks = [params.pop(f"block_{i}") for i in range(2)]
    params["blocks"] = {"block": jax.tree.map(lambda *a: np.stack(a), *blocks)}
    scan, _ = wan_params_to_state_dict(params)
    assert scan.keys() == sd.keys() and all(torch.equal(scan[k], sd[k]) for k in sd)


def test_phase1_trainer_moe_cli(tmp_path):
    """--ffn_mode moe end to end on the CPU (every weight trained, f32): the
    checkpoint meta records the MoE config for the loaders' rebuild, and the
    expert weights moved."""
    from interpolated_diffusion_tpu_torch.models.loading import load_wansynth_model
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1

    out = str(tmp_path / "p1moe")
    state = p1.main(["--num_samples", "12", "--T", "9", "--latent_c", "4", "--latent_h", "8",
                     "--latent_w", "8", "--text_len", "8", "--text_dim", "64", "--wan_dim", "64",
                     "--wan_layers", "2", "--wan_heads", "2", "--wan_ffn", "128", "--attn_mode",
                     "dense", "--use_remat", "0", "--batch", "2", "--steps", "2", "--save_every",
                     "2", "--log_every", "1", "--bf16", "0", "--K", "3", "--N_train", "20",
                     "--lora_rank", "0", "--ffn_mode", "moe", "--n_experts", "2",
                     "--device", "cpu", "--out_dir", out])
    meta = json.load(open(os.path.join(out, "ckpt_2", "meta.json")))["meta"]
    assert meta["ffn_mode"] == "moe" and meta["n_experts"] == 2
    assert meta["capacity_factor"] == 1.25
    wan = state.params["wan"]
    assert wan["blocks.0.moe_ffn.ffn_in"].shape == (2, 64, 128)
    assert all(bool(torch.isfinite(p).all()) for p in wan.values())
    model, _, _ = load_wansynth_model(out, "keypoints_wansynth", bf16=False, device="cpu")
    got = dict(model.named_parameters())
    assert all(torch.equal(got[k], p.detach()) for k, p in wan.items())
