"""The port's pipeline parallelism (parallel/pp.py, models/wan_pp.py) and
tensor parallelism (parallel/tp.py) on gloo process groups of CPU ranks
(tests/torch_dist_workers.py), f32.

- pipeline_blocks at pipe 2 and pipe 4 (a ring of four tells left from
  right), 8 residual tanh layers, 4 microbatches of 2: the output on every
  rank, and the gradients of a loss after a head (of the input, of the
  batched context every stage reads, of the head and of each stage's layers
  on its rank) against the sequential stack in one process (1e-6 of the
  scale: the same f32 operations in the same order).
- wan_pp_apply at pipe 2 (each rank keeping only its stage's blocks) on the
  JAX scan-layout WanDiT's weights through models/jax_import: the output
  against JAX's WanDiT (1e-4), and every gradient of mean(out^2) against the
  port's sequential forward in one process (1e-5).
- A WanDiT train step under tensor parallelism at (data 1, model 2) against
  one process: loss 1e-4 relative, every parameter after the step rtol 2e-4
  / atol 1e-5 (tests/test_parallel.py's bounds for JAX's own TP step), the
  split leaves being q / k / v / o, the FFN's and the q / k RMSNorms'.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
from interpolated_diffusion_tpu_torch.models.wan_dit import WanDiT
from interpolated_diffusion_tpu_torch.train.state import (init_train_state, make_optimizer,
                                                          make_train_step)
from torch_dist_workers import spawn

CFG = dict(dim=32, n_layers=4, n_heads=2, ffn_dim=64, in_channels=4, out_channels=4,
           text_dim=16, freq_dim=16)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pipeline_payload():
    r = np.random.default_rng(0)
    D = 16
    return {"W": [(r.normal(size=(D, D)) / 4).astype(np.float32) for _ in range(8)],
            "head": r.normal(size=(D, 3)).astype(np.float32),
            "shift": (0.1 * r.normal(size=(8, D))).astype(np.float32),
            "x": r.normal(size=(8, D)).astype(np.float32), "M": 4}


def _pipeline_reference(p):
    Ws = [torch.tensor(w, requires_grad=True) for w in p["W"]]
    head, x, shift = (torch.tensor(p[k], requires_grad=True) for k in ("head", "x", "shift"))
    h = x
    for W in Ws:
        h = h + torch.tanh(h @ W + shift)
    ((h @ head) ** 2).sum().backward()
    return h.detach(), x.grad, head.grad, shift.grad, [W.grad for W in Ws]


def _wan_case():
    """JAX's scan-layout WanDiT with random weights of its shapes, its output,
    and the port's inputs."""
    jm = JWanDiT(layer_mode="scan", dtype=jnp.float32, **CFG)
    r = np.random.default_rng(1)
    lat = r.normal(size=(4, 4, 2, 4, 4)).astype(np.float32)
    t = np.array([999, 500, 111, 3], np.int32)
    ctx = r.normal(size=(4, 6, 16)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), lat, t, ctx)["params"]

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.05 * r.normal(size=leaf.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[-3 if leaf.ndim == 5 else -2:-1]))
            return (r.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.05 * r.normal(size=leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, lat, t, ctx))
    sd, _ = wan_params_to_state_dict(params)
    return {"cfg": CFG, "sd": {k: v.numpy() for k, v in sd.items()}, "lat": lat, "t": t,
            "ctx": ctx, "M": 2}, ref


def _port_wan(payload):
    m = WanDiT(**payload["cfg"]).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in payload["sd"].items()})
    return m, [torch.tensor(payload[k]) for k in ("lat", "t", "ctx")]


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_and_tensor_parallel(world, tmp_path):
    pp = _pipeline_payload()
    jobs = [("pipeline", pp)]
    if world == 2:
        wan, wan_ref = _wan_case()
        tp = dict(wan, cfg=dict(CFG, n_layers=2),
                  sd={k: v for k, v in wan["sd"].items()
                      if not k.startswith(("blocks.2.", "blocks.3."))})
        jobs += [("wan_pp", wan), ("tensor_parallel", tp)]
    ranks = spawn(jobs, world, tmp_path)

    out, dx, dhead, dshift, dW = _pipeline_reference(pp)
    for rank, r in enumerate(ranks):
        got = r[0]
        assert rel(got["out"], out) <= 1e-6
        for name, want in (("dx", dx), ("dhead", dhead), ("dshift", dshift)):
            assert rel(got[name], want) <= 1e-6, (rank, name)
        assert sorted(got["dW"]) == list(range(rank * 8 // world, (rank + 1) * 8 // world))
        for i, g in got["dW"].items():
            assert rel(g, dW[i]) <= 1e-6, (rank, i)
    if world != 2:
        return

    # wan_pp against JAX's scan-layout WanDiT, and the port's sequential gradients
    m, (lat, t, ctx) = _port_wan(wan)
    seq = m(lat, t, ctx)
    (seq ** 2).mean().backward()
    want = {k: p.grad for k, p in m.named_parameters()}
    for rank, r in enumerate(ranks):
        got = r[1]
        assert rel(got["out"], wan_ref) <= 1e-4, rel(got["out"], wan_ref)
        assert rel(got["out"], seq.detach()) <= 1e-5
        mine = {f"blocks.{i}." for i in range(rank * 2, rank * 2 + 2)}
        names = [k for k in want if not k.startswith("blocks.") or k[:9] in mine]
        assert sorted(got["grads"]) == sorted(names)
        for k in names:
            assert rel(got["grads"][k], want[k]) <= 1e-5, (rank, k)

    # one tensor-parallel train step against one process
    m, (lat, t, ctx) = _port_wan(tp)
    state = init_train_state(dict(m.named_parameters()), make_optimizer(1e-3), use_ema=False)
    step = make_train_step(lambda p, b, rng: ((m(b["lat"], b["t"], b["ctx"]) ** 2).mean(), {}))
    state, metrics = step(state, {"lat": lat, "t": t, "ctx": ctx}, None)
    for r in ranks:
        got = r[2]
        assert abs(got["loss"] - float(metrics["loss"])) <= 1e-4 * float(metrics["loss"])
        assert abs(got["grad_norm"] - float(metrics["grad_norm"])) <= 1e-4 * float(
            metrics["grad_norm"])
        # a layer's split leaves: per attention q / k / v weight and bias, o's weight,
        # the q / k norms (9, self and cross); the FFN's in weight and bias, out weight
        assert len(got["split"]) == 2 * (2 * 9 + 3)
        for k, p in state.params.items():
            np.testing.assert_allclose(got["params"][k], p.detach().numpy(), rtol=2e-4,
                                       atol=1e-5, err_msg=k)
