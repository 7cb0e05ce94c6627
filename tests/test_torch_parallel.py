"""The port's data parallelism (parallel/{multihost,mesh,collectives}.py,
train/state.py) and sharded checkpoints (utils/checkpoint_sharded.py) on
gloo process groups of CPU ranks (tests/torch_dist_workers.py), held to one
process and to the JAX package's single-device step.

- The mesh rules (the gcd default, more shards than processes naming
  torchrun), batch slicing and the multihost helpers in one process.
- The collectives at world 3 (a ring that tells left from right): ppermute
  and its inverse-permutation backward, psum, all_gather, all_to_all.
- One maze Stage-2 train step at world 2 (batch 6, three rows a rank): with
  JAX's draws injected, its loss, global-norm and all-reduced gradients are
  JAX's single-device ones (loss 1e-5 relative, norm and every gradient
  1e-4 as tests/test_torch_maze_train_trainers.py holds one process); with
  the trainer's own generator it equals one process at the same global
  batch (loss 1e-5, gradients 1e-5 of their max: every draw global, the
  masked ratio a global sum). Either way the params after the step are one
  process's (1e-5 of their max; elements whose gradient is under 1e-6
  within 2 lr: Adam's g / (|g| + eps) of f32 noise).
- The Stage-1 trainer CLI at world 2 with --n_data_shards 2 against one
  process: the checkpoint rank 0 wrote after two steps.
- A sharded asynchronous checkpoint written by two ranks reads back whole
  through utils/checkpoint.load_checkpoint.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.train import train_interp_levels as js2
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.parallel import mesh as pmesh
from interpolated_diffusion_tpu_torch.parallel import multihost
from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2
from interpolated_diffusion_tpu_torch.train import train_keypoints as ps1
from interpolated_diffusion_tpu_torch.utils.checkpoint import load_checkpoint, read_meta
from test_torch_maze_train_trainers import CORRUPT, TINY2, _batch, _s2_draws, t
from torch_dist_workers import spawn


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_mesh_rules_and_multihost_helpers_in_one_process():
    assert multihost.maybe_initialize_distributed() is False     # no torchrun env: no-op
    assert multihost.process_count() == 1 and multihost.is_main_process()
    multihost.assert_same_across_processes(123.0, what="seed")
    assert multihost.process_local_slice(16) == slice(0, 16)
    assert str(multihost.local_device("cpu")) == "cpu"
    b = multihost.global_batch_from_local({"x": np.ones((4, 2), np.float32), "n": 3},
                                          torch.device("cpu"))
    assert isinstance(b["x"], torch.Tensor) and b["n"] == 3
    mesh = pmesh.make_mesh_for_batch(6)
    assert mesh.shape == {"data": 1, "model": 1} and pmesh.make_mesh() is mesh
    for bad in (lambda: pmesh.make_mesh(n_data=2), lambda: pmesh.make_mesh_for_batch(8, 4),
                lambda: pmesh.make_mesh(n_model=2)):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            bad()
    batch = {"x": np.arange(12).reshape(6, 2), "s": np.float32(1)}
    assert pmesh.shard_batch(batch, mesh) is batch
    # the slicing of rank 1 of 3 data shards, without a process group
    m3 = pmesh.Mesh(3, 1, None, None)
    m3.data_index = 1
    got = pmesh.shard_batch(batch, m3)
    assert got["x"].tolist() == [[4, 5], [6, 7]] and got["s"] == 1
    sup = pmesh.shard_superbatch({"x": np.arange(24).reshape(2, 6, 2)}, m3)
    assert sup["x"].shape == (2, 2, 2) and sup["x"][1, 0].tolist() == [16, 17]
    draws = {"a": torch.arange(6), "lv": [{"n": torch.ones(6, 2), "k": None}], "z": torch.ones(3)}
    cut = pmesh.shard_draws(draws, m3, 2)
    assert cut["a"].tolist() == [2, 3] and cut["lv"][0]["n"].shape == (2, 2)
    assert cut["z"].shape == (3,) and cut["lv"][0]["k"] is None
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_batch({"x": np.zeros((4, 1))}, m3)
    x = torch.tensor([1.0, 2.0, 3.0])
    assert pmesh.dp_sum(x) is x and float(pmesh.dp_mean(x)) == 2.0


def test_collectives_at_world_three(tmp_path):
    res = [r[0] for r in spawn([("collectives", None)], 3, tmp_path)]
    for rank, r in enumerate(res):
        assert (r["y"] == (rank + 1) % 3).all()              # i -> i - 1: from rank + 1
        assert (r["xgrad"] == (rank + 2) % 3 + 1).all()       # backward: to rank - 1
        assert r["psum"].tolist() == [3.0]
        assert r["gather"].ravel().tolist() == [0.0, 1.0, 2.0]
        assert r["a2a"].tolist() == [rank + 10.0 * i for i in range(3)]


def _jax_grads(flags, D, seed):
    """The Stage-2 setup with random weights of JAX's shapes (jax.eval_shape:
    no op-by-op flax init), JAX's loss and gradients under one jit, JAX's
    draws for the port: (argv, port model, host batch, draws, loss, grad
    norm, gradients in the port's names)."""
    argv = TINY2 + ["--K_min", "4", "--levels", "2", "--with_velocity", str(int(D == 4))] + flags
    jargs = js2.build_argparser().parse_args(argv)
    pargs = ps2.build_argparser().parse_args(argv + ["--device", "cpu"])
    jmodel = js2.build_model(jargs, D)
    b = _batch(D, seed)
    mc = js2.mask_channels_for(jargs)
    cond = {"occ": jnp.asarray(b["occ"][:2]), "start_goal": jnp.asarray(b["start_goal"][:2])}
    T = b["x"].shape[1]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, T, D)),
                            jnp.zeros((2,), jnp.int32),
                            jnp.zeros((2, T, mc)) if mc > 1 else jnp.zeros((2, T), bool),
                            cond)["params"]
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.05 * r.normal(size=leaf.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (r.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.05 * r.normal(size=leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    model = ps2.build_model(pargs, D, torch.device("cpu"))
    model.load_state_dict(params_to_state_dict(params, "interp"), strict=True)
    host = ps2.host_batch(pargs, b, 0, np.random.RandomState(1))
    jloss = js2.make_loss_fn(jmodel, jargs)
    rng = jax.random.PRNGKey(90)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(lambda p: jloss(p, jb, rng), has_aux=True))(
        params)
    grads = {k: v.numpy() for k, v in params_to_state_dict(
        jax.tree.map(np.asarray, grads), "interp").items()}
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))
    return (argv + ["--device", "cpu"], pargs, model, host, _s2_draws(rng, pargs, D),
            float(loss), norm, grads)


def test_dp_train_step_matches_one_process_and_jax(tmp_path):
    flags, D = ["--anchor_conf", "1"] + CORRUPT, 2
    argv, pargs, model, host, draws, loss_j, norm_j, grads_j = _jax_grads(flags, D, seed=5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    payload = {"argv": argv, "D": D, "sd": sd, "batch": host, "draws": draws, "seed": 11}
    ranks = [r[0] for r in spawn([("dp_stage2", payload)], 2, tmp_path)]

    def one_process(rng):
        """The trainer's step in this process at the global batch: (metrics,
        gradients, params after)."""
        pargs.steps_per_call = 1
        one = ps2.build_model(pargs, D, torch.device("cpu"))
        one.load_state_dict(model.state_dict())
        state, step, _ = ps2.make_trainer(pargs, torch.device("cpu"), D, one)
        seen = []
        update = state.opt_state.update
        state.opt_state.update = lambda g, *a: (seen.append([x.clone() for x in g]),
                                                update(g, *a))[1]
        state, m = step(state, {k: t(v) for k, v in host.items()}, rng)
        return m, dict(zip(state.params, seen[0])), {k: p.detach() for k, p in
                                                     state.params.items()}

    m_inj, _, p_inj = one_process(draws)
    m_gen, g_gen, p_gen = one_process(torch.Generator().manual_seed(11))
    lr = pargs.lr
    for r in ranks:
        inj, gen = r["injected"], r["generator"]
        assert abs(inj["loss"] - loss_j) <= 1e-5 * abs(loss_j)
        assert abs(inj["grad_norm"] - norm_j) <= 1e-4 * norm_j
        assert abs(gen["loss"] - float(m_gen["loss"])) <= 1e-5 * float(m_gen["loss"])
        for n, g_j in grads_j.items():
            assert rel(inj["grads"][n], g_j) <= 1e-4, n
            assert rel(gen["grads"][n], g_gen[n]) <= 1e-5, n
            # the update: one process's, elements with a gradient under 1e-6 within 2 lr
            for got, want, g in ((inj, p_inj, g_j), (gen, p_gen, g_gen[n].numpy())):
                scale = float(want[n].abs().max())
                tol = np.where(np.abs(g) >= 1e-6, 1e-5 * scale, max(1e-5 * scale, 2 * lr))
                assert (np.abs(got["params"][n] - want[n].numpy()) <= tol).all(), n
    for n in grads_j:      # the ranks stay replicas
        assert np.array_equal(ranks[0]["generator"]["params"][n],
                              ranks[1]["generator"]["params"][n])


def test_trainer_cli_data_parallel_and_sharded_checkpoint(tmp_path):
    """train_keypoints --n_data_shards 2 on two ranks (the device policy draws
    the anchors inside the step) against one process; and a sharded async
    checkpoint of two ranks read back whole."""
    argv = ["--device", "cpu", "--T", "16", "--K", "4", "--batch", "8", "--num_samples", "32",
            "--d_model", "32", "--n_layers", "2", "--n_heads", "2", "--d_ff", "64",
            "--maze_channels", "4,8", "--maze_h", "9", "--maze_w", "9", "--bf16", "0",
            "--steps", "2", "--steps_per_call", "2", "--save_every", "2", "--log_every", "1",
            "--lr", "1e-3"]
    one = str(tmp_path / "one")
    ps1.main(argv + ["--out_dir", one])          # also builds the native maze generator
    two, ck = str(tmp_path / "two"), str(tmp_path / "ck")
    res = spawn([("train_cli", {"module": ps1.__name__,
                                "argv": argv + ["--out_dir", two, "--n_data_shards", "2"]}),
                 ("sharded_checkpoint", {"path": ck})], 2, tmp_path)
    _, p1 = load_checkpoint(os.path.join(one, "ckpt_2"))
    _, p2 = load_checkpoint(os.path.join(two, "ckpt_2"))
    assert read_meta(os.path.join(one, "ckpt_2")) == read_meta(os.path.join(two, "ckpt_2"))
    close = total = 0
    for k, w in p1["params"].items():
        d = (p2["params"][k] - w).abs()
        # Adam moves an element whose gradient is f32 noise (the attention key
        # bias's, exactly zero in exact arithmetic) by up to lr a step
        assert float(d.max()) <= 2 * 2 * 1e-3, k
        close += int((d <= 1e-5 * float(w.abs().max())).sum())
        total += d.numel()
    assert close >= 0.99 * total, close / total

    saved = res[0][1]
    assert saved["files"] == ["meta.json", "shard_0.pt", "shard_1.pt"]
    step, payload = load_checkpoint(ck)
    assert step == 7 and payload["meta"] == {"stage": "x"}
    for part in ("params", "ema"):
        for grp, leaves in saved[part].items():
            for k, v in leaves.items():
                assert torch.equal(payload[part][grp][k], v), (part, grp, k)
    assert payload["opt_state"]["count"] == 3
    assert torch.equal(payload["opt_state"]["adamw"]["state"][0]["exp_avg"],
                       saved["opt"]["adamw"]["state"][0]["exp_avg"])
