"""The port's selection trainers (train/train_segment_cost.py,
train/train_keypoint_selector.py), data/prepare_dp_keypoints.py and the
selection modes of the maze trainers and the sampling CLI, against the JAX
package on the CPU.

The trainers: the JAX trainer's own loss function (taken from its main as it
hands it to make_train_step) and the port's, on one batch, from the same
weights (the port's seeded model carried to JAX by the JAX package's
converters), with the same draws: loss 1e-5 relative and every leaf's
gradient 1e-4 of its max (tests/test_torch_maze_train_trainers.py's
tolerances). prepare_dp_keypoints at 96 mazes, T=32, 9x9: the npz equals
JAX's (kp_idx and kp_mask_levels exactly, kp_feat to 1e-6). The end-to-end
case mirrors tests/test_selection_pipeline.py: port CLIs train D_phi, the
selector, a kp_feat Stage 1 under a dp/selector/random policy and a
selector_level Stage 2, then both sampling CLIs run the selector modes on
those weights.
"""
import csv
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import native as jnative
from interpolated_diffusion_tpu.data import prepare_dp_keypoints as jprep
from interpolated_diffusion_tpu.models.torch_import import (convert_keypoint_selector,
                                                            convert_segment_cost,
                                                            convert_state_dict)
from interpolated_diffusion_tpu.sample import generate as jgen
from interpolated_diffusion_tpu.train import train_keypoint_selector as jtks
from interpolated_diffusion_tpu.train import train_segment_cost as jtsc
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.data import prepare_dp_keypoints as pprep
from interpolated_diffusion_tpu_torch.sample import generate
from interpolated_diffusion_tpu_torch.train import train_interp_levels, train_keypoints
from interpolated_diffusion_tpu_torch.train import train_keypoint_selector as ptks
from interpolated_diffusion_tpu_torch.train import train_segment_cost as ptsc
from interpolated_diffusion_tpu_torch.utils.checkpoint import load_checkpoint, read_meta

T, G = 32, 9
PREP = ["--T", str(T), "--K", "4", "--num_samples", "96", "--batch", "48", "--maze_h", str(G),
        "--maze_w", str(G), "--levels", "2"]
COMMON = ["--T", str(T), "--batch", "16", "--steps", "2", "--save_every", "2", "--log_every", "1",
          "--maze_h", str(G), "--maze_w", str(G), "--maze_channels", "8,8", "--bf16", "0",
          "--steps_per_call", "1"]
DPHI = ["--d_cond", "16", "--hidden_dim", "32"]
SEL = ["--K", "4", "--d_model", "32", "--n_heads", "2", "--d_ff", "64", "--pos_dim", "16",
       "--levels", "2", "--k_schedule", "doubling", "--use_level", "1"]
NET = ["--d_model", "32", "--n_layers", "2", "--n_heads", "2", "--d_ff", "64", "--d_cond", "16"]


def _jax_native_loaded():
    """JAX's "auto" falls back to numpy when its library fails to load
    (another test process may still be writing it): load it first."""
    for _ in range(5):
        if shutil.which("g++") is None or jnative.load_native() is not None:
            return
        time.sleep(1.0)


def _to_jax_ckpt(port_dir, jax_dir, convert):
    """The port checkpoint's weights as a JAX checkpoint with the same meta."""
    src = port_dir if os.path.exists(os.path.join(port_dir, "meta.json")) else None
    if src is None:
        from interpolated_diffusion_tpu_torch.utils.checkpoint import latest_checkpoint

        src = latest_checkpoint(port_dir)
    step, payload = load_checkpoint(src)
    _, meta = read_meta(src)
    conv = lambda sd: jax.tree.map(jnp.asarray, convert({k: v.numpy() for k, v in sd.items()}))
    jckpt.save_checkpoint(os.path.join(jax_dir, f"ckpt_{step}"), conv(payload["params"]), None,
                          step, conv(payload["ema"]) if "ema" in payload else None, meta)
    return jax_dir


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The port's DP prep and its D_phi and selector checkpoints (port CLIs),
    with JAX copies of the two checkpoints."""
    _jax_native_loaded()
    root = tmp_path_factory.mktemp("select")
    prep = str(root / "dp.npz")
    pprep.main(PREP + ["--device", "cpu", "--store_kp_mask_levels", "1", "--out_path", prep])
    data = ["--dataset", "prepared", "--prepared_path", prep, "--device", "cpu"]
    ptsc.main(COMMON + DPHI + data + ["--out_dir", str(root / "dphi")])
    ptks.main(COMMON + SEL + data + ["--out_dir", str(root / "sel")])
    out = {"root": root, "prep": prep, "data": data, "dphi": str(root / "dphi"),
           "sel": str(root / "sel")}
    out["j_dphi"] = _to_jax_ckpt(out["dphi"], str(root / "j_dphi"), convert_segment_cost)
    out["j_sel"] = _to_jax_ckpt(out["sel"], str(root / "j_sel"),
                                lambda sd: convert_keypoint_selector(sd, n_heads=2))
    return out


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _jax_cost_matrices(case, npz, work):
    """The cost matrices the JAX prep built for these samples (its jitted
    interp-MSE costs, or its D_phi), [N, T, T]."""
    from interpolated_diffusion_tpu.models.loading import load_segment_cost_model
    from interpolated_diffusion_tpu.ops import selection as jsel

    pre = jsel.build_segment_precompute(T, 16)
    snr, weights = jsel.build_snr_weights("cosine", 1000, 0.1, 10.0, 1.0)
    ws = float(np.asarray(weights)[jsel.sample_timesteps_log_snr(snr, 16)].sum())
    if case == "dphi":
        model, params, meta = load_segment_cost_model(work["j_dphi"], bf16=False)
        cost = model.apply({"params": params}, {"occ": jnp.asarray(npz["occ"]),
                                                "start_goal": jnp.asarray(npz["start_goal"])},
                           jsel.build_segment_features(T, pre.seg_i, pre.seg_j))
        if meta.get("normalize_targets"):
            cost = cost * meta["target_std"] + meta["target_mean"]
    else:
        cost = jax.jit(lambda x: jsel.compute_segment_costs_batch(x, pre, ws))(
            jnp.asarray(npz["x"]))
    return np.asarray(jsel.build_cost_matrix_from_segments(cost, pre, T))


def _path_cost(C, idx):
    rows = np.arange(C.shape[0])[:, None]
    return C[rows, idx[:, :-1], idx[:, 1:]].astype(np.float64).sum(1)


@pytest.mark.parametrize("case", ["gt_levels", "dphi", "annotate"])
def test_prepare_dp_keypoints_matches_jax(case, work):
    """The npz of the JAX prep: ground-truth costs with per-level masks,
    D_phi costs (the same weights in both packages), and --prepared_path
    annotation of an existing npz.

    The data arrays are equal bit for bit and the keys and dtypes are JAX's.
    The costs are f32 sums taken in another order than XLA's fused ones (the
    JAX package's own jitted and op-by-op costs differ at the ulp too), and
    DP paths on near-equal costs (straight maze corridors cost ~0 for many
    splits) may then pick another of the equally cheap paths. So the DP is
    held exactly on JAX's own cost matrices (the port's DP on them gives
    JAX's kp_idx and kp_mask_levels bit for bit), and the port's own choice
    is held to optimality: under JAX's costs its paths cost what JAX's do,
    to 1e-5 relative (+1e-6)."""
    from interpolated_diffusion_tpu_torch.ops.keyframes import compute_k_schedule
    from interpolated_diffusion_tpu_torch.ops.selection import (build_kp_feat_batch,
                                                                dp_select_indices_batch)

    root = work["root"]
    flags = {"gt_levels": ["--store_kp_mask_levels", "1"],
             "dphi": ["--cost_source", "dphi"],
             "annotate": ["--prepared_path", work["prep"], "--store_kp_mask_levels", "1",
                          "--levels", "1"]}[case]
    got_path, want_path = str(root / f"p_{case}.npz"), str(root / f"j_{case}.npz")
    pflags = flags + (["--dphi_ckpt", work["dphi"]] if case == "dphi" else [])
    jflags = flags + (["--dphi_ckpt", work["j_dphi"]] if case == "dphi" else [])
    if case == "gt_levels":
        got = _npz(work["prep"])
    else:
        got = pprep.main(PREP + pflags + ["--device", "cpu", "--out_path", got_path])
        assert _npz(got_path).keys() == got.keys()
    jprep.main(PREP + jflags + ["--out_path", want_path])
    want = _npz(want_path)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    for k in ("x", "occ", "start_goal"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    C = _jax_cost_matrices(case, want, work)
    levels = 1 if case == "annotate" else 2
    k_list = compute_k_schedule(T, 4, levels)
    for K_s, s in [(4, None)] + ([(k, s) for s, k in enumerate(k_list)]
                                 if "kp_mask_levels" in want else []):
        mine = dp_select_indices_batch(torch.as_tensor(C), K_s).numpy()
        theirs = want["kp_idx"] if s is None else np.sort(
            np.argsort(~want["kp_mask_levels"][:, s], axis=1, kind="stable")[:, :K_s], 1)
        np.testing.assert_array_equal(mine, theirs)
        ours = got["kp_idx"] if s is None else np.sort(
            np.argsort(~got["kp_mask_levels"][:, s], axis=1, kind="stable")[:, :K_s], 1)
        assert (ours[:, 0] == 0).all() and (ours[:, -1] == T - 1).all()
        assert (np.diff(ours, 1) > 0).all()
        best = _path_cost(C, theirs)
        assert (_path_cost(C, ours) <= best + 1e-5 * np.abs(best) + 1e-6).all(), K_s
    np.testing.assert_allclose(got["kp_feat"], build_kp_feat_batch(
        torch.as_tensor(got["kp_idx"]), T).numpy(), atol=1e-6)
    if "kp_mask_levels" in got:
        counts = got["kp_mask_levels"].sum(-1)
        assert (counts == np.asarray(k_list)[None]).all()


def _jax_loss_fn(module, argv, monkeypatch):
    """(loss_fn, meta) of a JAX trainer: its main runs one step, and the
    loss function it hands to make_train_step is kept."""
    kept = {}
    real = module.make_train_step

    def keep(loss_fn, *a, **kw):
        kept["loss_fn"] = loss_fn
        return real(loss_fn, *a, **kw)

    monkeypatch.setattr(module, "make_train_step", keep)
    module.main(argv)
    out_dir = argv[argv.index("--out_dir") + 1]
    return kept["loss_fn"], read_meta(os.path.join(out_dir, "ckpt_1"))[1]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _check(model, convert, loss, loss_j, grads_j):
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    got_j = convert({n: g.numpy() for n, g in zip(names, got)})
    flat = lambda tree: {"/".join(str(getattr(k, "key", k)) for k in path): v
                         for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got_j, want = flat(got_j), flat(jax.tree.map(np.asarray, grads_j))
    assert set(got_j) == set(want)
    for n in want:
        # + 1e-8: the attention's key bias has a zero gradient (softmax does
        # not see a shift of every logit), which both compute as f32 noise
        d = np.abs(np.asarray(got_j[n], np.float64) - want[n]).max()
        assert d <= 1e-4 * np.abs(want[n]).max() + 1e-8, (n, _rel(got_j[n], want[n]))


def _batch(ds, n, seed):
    return ds.get_batch(np.random.RandomState(seed).randint(0, len(ds), size=n))


def test_segment_cost_trainer_matches_jax(work, monkeypatch, tmp_path):
    """D_phi's regression loss and gradients, the target statistics and the
    checkpoint meta against the JAX trainer, on the default particle data
    (the C++ generator in both packages)."""
    flags = COMMON + DPHI + ["--num_samples", "64", "--stats_subset", "32", "--steps", "1",
                             "--save_every", "1"]
    jloss, jmeta = _jax_loss_fn(jtsc, flags + ["--out_dir", str(tmp_path / "j")], monkeypatch)
    args = ptsc.build_argparser().parse_args(flags + ["--device", "cpu",
                                                      "--out_dir", str(tmp_path / "p")])
    ds, _ = ptsc.make_dataset(args)
    _, _, model, targets = ptsc.make_trainer(args, torch.device("cpu"), ds)
    meta = ptsc.make_meta(args, targets)
    assert set(meta) == set(jmeta)
    for k in meta:
        if k in ("target_mean", "target_std", "weight_scale"):
            np.testing.assert_allclose(meta[k], jmeta[k], rtol=1e-5, err_msg=k)
        else:
            assert meta[k] == jmeta[k], k
    b = _batch(ds, 16, 3)
    host = ptsc.host_batch(args, b)
    params = jax.tree.map(jnp.asarray, convert_segment_cost(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}))
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in host.items()}, jax.random.PRNGKey(0))
    loss, aux = ptsc.make_loss_fn(model, targets)(None, {k: torch.as_tensor(v)
                                                         for k, v in host.items()}, None)
    assert aux == {}
    _check(model, convert_segment_cost, loss, loss_j, grads_j)


@pytest.mark.parametrize("labels", ["kp_mask_levels", "kp_idx"])
def test_keypoint_selector_trainer_matches_jax(labels, work, monkeypatch, tmp_path):
    """BCE with per-level labels (level-conditioned, s drawn per sample) and
    with kp_idx labels, the KL term at an annealed temperature."""
    prep = work["prep"]
    if labels == "kp_idx":   # the same prep without the per-level masks
        prep = str(tmp_path / "dp_idx.npz")
        np.savez(prep, **{k: v for k, v in _npz(work["prep"]).items() if k != "kp_mask_levels"})
    flags = COMMON + SEL + ["--dataset", "prepared", "--prepared_path", prep, "--steps", "1",
                            "--save_every", "1", "--sel_kl_weight", "0.5"]
    jloss, jmeta = _jax_loss_fn(jtks, flags + ["--out_dir", str(tmp_path / "j")], monkeypatch)
    args = ptks.build_argparser().parse_args(flags + ["--device", "cpu",
                                                      "--out_dir", str(tmp_path / "p")])
    assert ptks.make_meta(args) == jmeta
    for step, total, mode in ((0, 10, "cosine"), (3, 10, "cosine"), (5, 10, "linear"),
                              (9, 10, "none")):
        assert ptks.anneal_tau(step, total, 1.0, 0.3, 0.8, mode) == jtks.anneal_tau(
            step, total, 1.0, 0.3, 0.8, mode)
    ds, _ = ptks.make_dataset(args)
    has_levels = labels == "kp_mask_levels"
    _, _, model = ptks.make_trainer(args, torch.device("cpu"), has_levels)
    host = ptks.host_batch(args, _batch(ds, 16, 4), 3, has_levels)
    conv = lambda sd: convert_keypoint_selector(sd, n_heads=2)
    params = jax.tree.map(jnp.asarray, conv(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}))
    rng = jax.random.PRNGKey(5)
    (loss_j, aux_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in host.items()}, rng)
    draws = {"s_idx": torch.as_tensor(np.array(jax.random.randint(rng, (16,), 1, 3)))}
    loss, aux = ptks.make_loss_fn(model, args, has_levels)(
        None, {k: torch.as_tensor(v) for k, v in host.items()}, draws)
    # the KL to uniform is a small difference of large terms: 1e-7 absolute
    np.testing.assert_allclose(float(aux["kl"]), float(aux_j["kl"]), rtol=1e-5, atol=1e-7)
    _check(model, conv, loss, loss_j, grads_j)


def _columns(out_dir):
    with open(os.path.join(out_dir, "metrics.csv")) as f:
        return next(csv.reader(f))


def test_selection_modes_end_to_end_match_jax(work):
    """Port CLIs train a kp_feat Stage 1 (D_phi cost channels, dp / selector
    / random anchors) and a selector_level Stage 2 on the prepared data; the
    port's sampling CLI and the JAX CLI (on the same weights) run
    --kp_index_mode selector --stage2_mask_policy selector: the same anchors
    from the selector, the same data, the same columns and keys, and the
    same oracle-interp metrics (no draw is involved there)."""
    root, data = work["root"], work["data"]
    kp_dir, il_dir = str(root / "kp"), str(root / "il")
    train_keypoints.main(COMMON + NET + data + [
        "--K", "4", "--use_kp_feat", "1", "--kp_feat_dim", "5", "--dphi_ckpt", work["dphi"],
        "--idx_policy", "dp:0.4,selector:0.3,random:0.3", "--selector_ckpt", work["sel"],
        "--out_dir", kp_dir])
    train_interp_levels.main(COMMON + NET + data + [
        "--K_min", "4", "--levels", "2", "--mask_policy", "selector_level",
        "--selector_ckpt", work["sel"], "--out_dir", il_dir])
    _, kp_meta = read_meta(os.path.join(kp_dir, "ckpt_2"))
    assert kp_meta["use_kp_feat"] == 1 and kp_meta["kp_feat_dphi"] == 1
    j_kp = _to_jax_ckpt(kp_dir, str(root / "j_kp"), lambda sd: convert_state_dict(sd, "keypoint"))
    j_il = _to_jax_ckpt(il_dir, str(root / "j_il"), lambda sd: convert_state_dict(sd, "interp"))
    sample = ["--num_batches", "2", "--batch", "8", "--num_samples", "64", "--maze_h", str(G),
              "--maze_w", str(G), "--bf16", "0", "--kp_index_mode", "selector",
              "--stage2_mask_policy", "selector", "--compare_oracle", "1"]
    p_dir, j_dir = str(root / "gen"), str(root / "j_gen")
    summary = generate.main(sample + ["--kp_ckpt", kp_dir, "--interp_ckpt", il_dir,
                                      "--selector_ckpt", work["sel"], "--dphi_ckpt", work["dphi"],
                                      "--device", "cpu", "--out_dir", p_dir])
    j_summary = jgen.main(sample + ["--kp_ckpt", j_kp, "--interp_ckpt", j_il,
                                    "--selector_ckpt", work["j_sel"], "--dphi_ckpt", work["j_dphi"],
                                    "--out_dir", j_dir])
    assert _columns(p_dir) == _columns(j_dir) and set(summary) == set(j_summary)
    got, want = _npz(os.path.join(p_dir, "samples.npz")), _npz(os.path.join(j_dir, "samples.npz"))
    assert sorted(got) == sorted(want)
    for k in ("idx", "gt", "occ", "start_goal"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(np.isfinite(got[k]).all() for k in ("interp", "refined", "keypoints"))
    for k in j_summary:
        if k.startswith("oracle_interp"):
            np.testing.assert_allclose(summary[k], j_summary[k], atol=1e-5, rtol=1e-4, err_msg=k)
    # a Stage-1 checkpoint trained with D_phi channels refuses to sample without D_phi
    with pytest.raises(ValueError, match="dphi_ckpt"):
        generate.main(sample + ["--kp_ckpt", kp_dir, "--interp_ckpt", il_dir, "--selector_ckpt",
                                work["sel"], "--device", "cpu", "--out_dir", p_dir])


def test_selection_clis_default_to_the_card(work, tmp_path):
    """Without a GPU the new CLIs raise unless given --device cpu; with it
    they run (the D_phi and selector trainers above, the prep)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for main, argv in ((ptsc.main, COMMON + DPHI), (ptks.main, COMMON + SEL),
                       (pprep.main, PREP)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--out_dir" if main is not pprep.main else "--out_path",
                         str(tmp_path / "x")])
