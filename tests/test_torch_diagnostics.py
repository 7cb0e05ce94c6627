"""The nine diagnostics of the port against the JAX package's CLIs, on the CPU
at a tiny size, from the same weights and the same random draws: each
report (or the arrays a CLI returns) at 1e-4 relative in f32, equal where
it holds counts or indices; 2^-8 of the value's scale where an SLA mode
rounds q / k / v to bf16 (both packages do, and an ulp of f32 difference
upstream can round one element the other way).

Draws: the JAX CLIs split jax.random keys; the tests recompute those splits
and hand the draws to the port's `main` (mask uniforms, t and eps). The
host-side draws (numpy RandomState batches and triplets) are the same by
construction. The oracle DP breaks near-ties by f32 order, so its indices
are compared on JAX's cost matrix. Weights: the Stage-2 model and the
selector are seeded and saved as a JAX checkpoint and a port checkpoint of
the same values; the Wan models read one diffusers-named safetensors file
(--wan_pretrained); the straightener and the Sinkhorn model are JAX
checkpoints the port's loaders read. The templates the JAX CLIs init and
then overwrite from a checkpoint are made by eval_shape (an init compiles
every primitive op by op, or a whole program under jit), and JAX's
selector loader is asked for f32 as the port's --bf16 0.
"""
import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.diagnostics import diagnose_latent_straightness as j_straight
from interpolated_diffusion_tpu.diagnostics import diagnose_oracle_dp as j_dp
from interpolated_diffusion_tpu.diagnostics import diagnose_selector as j_sel
from interpolated_diffusion_tpu.diagnostics import diagnose_selector_per_maze as j_sel_maze
from interpolated_diffusion_tpu.diagnostics import diagnose_sinkhorn_outliers as j_sink
from interpolated_diffusion_tpu.diagnostics import diagnose_stage2_masks as j_masks
from interpolated_diffusion_tpu.diagnostics import diagnose_stage2_model_error as j_err
from interpolated_diffusion_tpu.diagnostics import eval_wan_fullseq_eps as j_full
from interpolated_diffusion_tpu.diagnostics import eval_wan_sla_gap as j_gap
from interpolated_diffusion_tpu.models import sinkhorn_warp as jsw
from interpolated_diffusion_tpu.models.selector import KeypointSelector as JKeypointSelector
from interpolated_diffusion_tpu.models import straightener as jst
from interpolated_diffusion_tpu.models import wan_convert as jconvert
from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
from interpolated_diffusion_tpu.train import train_interp_levels as js2
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.diagnostics import diagnose_latent_straightness as p_straight
from interpolated_diffusion_tpu_torch.diagnostics import diagnose_oracle_dp as p_dp
from interpolated_diffusion_tpu_torch.diagnostics import diagnose_selector as p_sel
from interpolated_diffusion_tpu_torch.diagnostics import diagnose_selector_per_maze as p_sel_maze
from interpolated_diffusion_tpu_torch.diagnostics import diagnose_sinkhorn_outliers as p_sink
from interpolated_diffusion_tpu_torch.diagnostics import diagnose_stage2_masks as p_masks
from interpolated_diffusion_tpu_torch.diagnostics import diagnose_stage2_model_error as p_err
from interpolated_diffusion_tpu_torch.diagnostics import eval_wan_fullseq_eps as p_full
from interpolated_diffusion_tpu_torch.diagnostics import eval_wan_sla_gap as p_gap
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.models.selector import KeypointSelector
from interpolated_diffusion_tpu_torch.utils.checkpoint import save_checkpoint
from interpolated_diffusion_tpu_torch.utils.safetensors import write_safetensors
from test_torch_interpolators import jparams

TOL, BF16_TOL = 1e-4, 2.0 ** -8
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def _close(got, want, tol=TOL, path=""):
    """Reports equal in keys; numbers within tol of their magnitude (ints,
    strings and lists of ints equal)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)) and want and not isinstance(want[0], (int, np.integer)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        assert abs(got - want) <= tol * max(abs(want), 1e-6), (path, got, want)
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6),
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


def _zero_init(monkeypatch, cls):
    """flax init of `cls` as zeros in the init's shapes (eval_shape: nothing
    is compiled). The JAX CLIs overwrite every leaf of such a template from
    a checkpoint, except leaves that flax zero-initialises (the SLA linear
    branch), so their reports do not change; a leaf that mattered would
    show as a mismatch with the port, which inits its own."""
    def init(self, key, *args, **kw):
        shapes = jax.eval_shape(lambda k, *a: nn.Module.init(self, k, *a, **kw), key, *args)
        return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    monkeypatch.setattr(cls, "init", init)


# --- the maze diagnostics ---------------------------------------------------------

def test_stage2_masks_report_matches_jax(capsys):
    argv = ["--T", "40", "--K_min", "4", "--levels", "3", "--batch", "24", "--seed", "3"]
    want = j_masks.main(argv)
    k1, _, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    draws = {"mask_rand": np.asarray(jax.random.uniform(k1, (24, 38))),
             "base_rand": np.asarray(jax.random.uniform(k3, (24, 40)))}
    got = p_masks.main(argv + CPU, draws=draws)
    assert got == want
    assert got["random_nested"]["nestedness_violations"] == 0


T2, G2, B2 = 32, 9, 8
S2_FLAGS = ["--T", str(T2), "--d_model", "32", "--n_layers", "1", "--n_heads", "4", "--d_ff",
            "64", "--d_cond", "16", "--maze_channels", "8,8", "--maze_h", str(G2), "--maze_w",
            str(G2), "--K_min", "4", "--levels", "2", "--with_velocity", "1", "--bf16", "0"]


def _prepared(path, n=40, T=T2, seed=0, mazes=3, levels=2, K=4):
    """A prepared npz of `mazes` distinct 9x9 grids with DP-style labels."""
    r = np.random.default_rng(seed)
    grids = (r.uniform(size=(mazes, 1, G2, G2)) < 0.25).astype(np.float32)
    occ = grids[r.integers(0, mazes, n)]
    occ[:6] = grids[0]                      # uneven group sizes: a stable maze order
    kp = np.zeros((n, levels + 1, T), bool)    # level s: K * 2^(levels - s) nested anchors
    for i in range(n):
        inner = r.permutation(np.arange(1, T - 1))
        for s in range(levels + 1):
            kp[i, s, [0, T - 1]] = True
            kp[i, s, inner[:K * 2 ** (levels - s) - 2]] = True
    x = r.uniform(size=(n, T, 4)).astype(np.float32)
    np.savez(path, x=x, occ=occ, start_goal=r.uniform(size=(n, 4)).astype(np.float32),
             kp_mask_levels=kp, kp_idx=np.sort(r.integers(0, T, (n, K))).astype(np.int32))
    return str(path)


@pytest.mark.parametrize("flags", [[], ["--mode", "x0", "--anchor_conf", "1"]])
def test_stage2_model_error_report_matches_jax(flags, tmp_path, monkeypatch, capsys):
    jargs = js2.build_argparser().parse_args(S2_FLAGS + flags)
    jmodel, D = js2.build_model(jargs, 4), 4
    mc = js2.mask_channels_for(jargs)
    # numpy-drawn, no leaf zero (the zero-initialised head too): no identity model
    params = jparams(jmodel, np.zeros((2, T2, D), np.float32), np.zeros((2,), np.int32),
                     np.zeros((2, T2, mc), np.float32) if mc > 1 else np.zeros((2, T2), bool),
                     {"occ": np.zeros((2, 1, G2, G2), np.float32),
                      "start_goal": np.zeros((2, 4), np.float32)}, seed=1)
    _zero_init(monkeypatch, type(jmodel))     # the JAX loader's template init
    meta = js2.make_meta(jargs, D)
    jckpt.save_checkpoint(str(tmp_path / "j" / "ckpt_1"), jax.tree.map(jnp.asarray, params),
                          None, 1, None, meta)
    save_checkpoint(str(tmp_path / "p" / "ckpt_1"), params_to_state_dict(params, "interp"),
                    None, 1, None, meta)
    data = _prepared(tmp_path / "prep.npz")
    argv = ["--batch", str(B2), "--num_batches", "2", "--seed", "5", "--dataset", "prepared",
            "--prepared_path", data, "--maze_h", str(G2), "--maze_w", str(G2)]
    want = j_err.main(["--interp_ckpt", str(tmp_path / "j")] + argv)
    key, draws = jax.random.PRNGKey(5), []
    for _ in range(2 * 2):                   # levels x batches, one split a batch
        key, k = jax.random.split(key)
        draws.append({"mask_rand": np.asarray(jax.random.uniform(jax.random.split(k, 3)[0],
                                                                 (B2, T2 - 2)))})
    got = p_err.main(["--interp_ckpt", str(tmp_path / "p"), "--attn_policy", "dense"] + argv + CPU,
                     draws=draws)
    _close(got, want)
    assert all(v["model_mse"] > 0 for v in got.values())


def test_oracle_dp_report_matches_jax(capsys):
    from interpolated_diffusion_tpu.data.wan_synth import SyntheticWanDataset
    from interpolated_diffusion_tpu.ops.oracle_segment_cost import (
        build_oracle_seg_precompute, compute_oracle_cost_seg_mse)
    from interpolated_diffusion_tpu.ops.selection import build_cost_matrix_from_segments

    T, B = 9, 6
    argv = ["--T", str(T), "--K", "4", "--batch", str(B), "--latent_c", "4", "--latent_h", "6",
            "--latent_w", "6", "--seed", "2"]
    want = j_dp.main(argv)
    ds = SyntheticWanDataset(n_samples=B, T=T, C=4, H=6, W=6, text_len=4, text_dim=8, seed=2)
    z = ds.get_batch(np.arange(B))["latents"]
    pre = build_oracle_seg_precompute(T)
    C = np.asarray(build_cost_matrix_from_segments(
        compute_oracle_cost_seg_mse(jnp.asarray(z).reshape(B, T, -1), pre, normalize=False),
        pre, T))
    got = p_dp.main(argv + CPU, cost_matrix=torch.tensor(C))
    _close(got, want)
    own = p_dp.oracle_cost_matrix(torch.tensor(z), T).numpy()
    finite = C < 1e29
    np.testing.assert_allclose(own[finite], C[finite], rtol=1e-5, atol=1e-7)
    assert (own[~finite] >= 1e29).all()


@pytest.fixture(scope="module")
def selector_ckpts(tmp_path_factory):
    """A seeded keypoint selector (T 32, K 4, levels 2, level-conditioned) as
    a port checkpoint and, converted by the JAX package, a JAX checkpoint."""
    from interpolated_diffusion_tpu.models.torch_import import convert_keypoint_selector

    root = tmp_path_factory.mktemp("selector")
    meta = dict(stage="selector", T=T2, K=4, d_model=16, n_heads=2, d_ff=32, n_layers=2,
                pos_dim=8, use_sdf=0, cond_start_goal=1, use_sg_map=1, use_sg_token=1,
                use_goal_dist_token=0, use_cond_bias=0, cond_bias_mode="memory", use_level=1,
                level_mode="k_norm", levels=2, k_schedule="doubling", k_geom_gamma=None,
                sg_map_sigma=1.5, maze_channels="4,8", maze_h=G2, maze_w=G2)
    model = build_model(KeypointSelector, generator=torch.Generator().manual_seed(8), T=T2,
                        d_model=16, n_heads=2, d_ff=32, n_layers=2, pos_dim=8, use_level=True,
                        maze_channels=(4, 8))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    save_checkpoint(str(root / "p" / "ckpt_1"), sd, None, 1, None, meta)
    jckpt.save_checkpoint(str(root / "j" / "ckpt_1"), jax.tree.map(
        jnp.asarray, convert_keypoint_selector({k: v.numpy() for k, v in sd.items()}, n_heads=2)),
        None, 1, None, meta)
    return str(root / "j"), str(root / "p"), _prepared(root / "prep.npz", n=48, seed=3)


@pytest.mark.parametrize("mod", ["global", "per_maze"])
def test_selector_reports_match_jax(mod, selector_ckpts, monkeypatch, capsys):
    jdir, pdir, data = selector_ckpts
    jmod, pmod = (j_sel, p_sel) if mod == "global" else (j_sel_maze, p_sel_maze)
    _zero_init(monkeypatch, JKeypointSelector)
    monkeypatch.setattr(jmod, "load_selector_model",
                        functools.partial(jmod.load_selector_model, bf16=False))
    if mod == "global":
        argv = ["--prepared_path", data, "--batch", "20", "--seed", "4"]
    else:
        argv = ["--eval_npz", data, "--batch_per_maze", "8", "--max_mazes", "2", "--seed", "6"]
    want = jmod.main(["--ckpt", jdir] + argv)
    got = pmod.main(["--ckpt", pdir, "--bf16", "0"] + argv + CPU)
    _close(got, want)


# --- the latent diagnostics -------------------------------------------------------

LAT = ["--T", "7", "--latent_c", "4", "--latent_h", "8", "--latent_w", "8", "--text_len", "3",
       "--text_dim", "8", "--num_samples", "12"]


@pytest.fixture(scope="module")
def straightener_ckpt(tmp_path_factory):
    """A JAX conv straightener checkpoint (numpy-seeded weights)."""
    jm = jst.LatentStraightener(in_channels=4, hidden_channels=8, blocks=2)
    params = jparams(jm, np.zeros((1, 4, 8, 8), np.float32), seed=4)
    path = str(tmp_path_factory.mktemp("straight") / "ckpt_1")
    jckpt.save_checkpoint(path, jax.tree.map(jnp.asarray, params), None, 1, None, {
        "stage": "straightener", "in_channels": 4, "hidden_channels": 8, "blocks": 2,
        "arch": "conv"})
    return path


@pytest.mark.parametrize("with_straightener", [False, True])
def test_latent_straightness_matches_jax(with_straightener, straightener_ckpt, monkeypatch,
                                         capsys):
    _zero_init(monkeypatch, jst.LatentStraightener)
    argv = LAT + ["--batch", "3", "--num_batches", "2", "--loss_type",
                  "l2" if with_straightener else "l1", "--seed", "9"]
    if with_straightener:
        argv += ["--straightener_ckpt", straightener_ckpt]
    want = j_straight.main(argv)
    got = p_straight.main(argv + CPU)
    assert set(got) == set(want) == ({"curv", "curv_ratio", "lerp", "copy"} | (
        {"s_lerp", "z_from_s", "s_curv", "s_curv_ratio"} if with_straightener else set()))
    _close(got, {k: np.asarray(v) for k, v in want.items()})
    out = capsys.readouterr().out
    assert out.count("LERP") >= 4 and "gap 02-03" in out


def test_sinkhorn_outliers_match_jax(straightener_ckpt, tmp_path, monkeypatch, capsys):
    """A Sinkhorn checkpoint with global alignment and a forward-backward
    gate, with the straight-LERP baseline: summary, every case's record
    (same order) and the worst cases' tensors."""
    _zero_init(monkeypatch, jsw.SinkhornWarpInterpolator)
    _zero_init(monkeypatch, jst.LatentStraightener)
    meta = {"stage": "sinkhorn_interp", "in_channels": 4, "patch_size": 2, "win_size": 3,
            "sinkhorn_iters": 5, "global_mode": "phasecorr", "sinkhorn_tau": 0.05,
            "dustbin_logit": -2.0, "learn_tau": 1, "learn_dustbin": 1, "fb_sigma": 2.0,
            "d_match": 0}
    ckpt = str(tmp_path / "sk" / "ckpt_1")
    jckpt.save_checkpoint(ckpt, {"tau_raw": jnp.asarray(-2.7, jnp.float32),
                                 "dustbin": jnp.asarray(-1.6, jnp.float32)}, None, 1, None, meta)
    argv = ["--ckpt", ckpt] + LAT + ["--batch", "3", "--num_batches", "2", "--topk", "4",
                                     "--seed", "1", "--straightener_ckpt", straightener_ckpt]
    want = j_sink.main(argv + ["--out_dir", str(tmp_path / "j")])
    got = p_sink.main(argv + ["--out_dir", str(tmp_path / "p")] + CPU)
    _close(got, want)
    cases = [[json.loads(line) for line in open(tmp_path / d / "cases.jsonl")] for d in "pj"]
    assert [(c["batch"], c["index"]) for c in cases[0]] == [(c["batch"], c["index"])
                                                           for c in cases[1]]
    for a, b in zip(*cases):
        _close(a, b)
    with np.load(tmp_path / "p" / "worst_cases.npz") as fp, \
            np.load(tmp_path / "j" / "worst_cases.npz") as fj:
        for k in ("z0", "z1", "zt", "z_hat"):
            _close(fp[k], fj[k])


# --- the Wan evaluations ----------------------------------------------------------

WAN = ["--T", "8", "--latent_c", "4", "--latent_h", "8", "--latent_w", "8", "--text_len", "6",
       "--text_dim", "32", "--num_samples", "8", "--wan_dim", "64", "--wan_layers", "1",
       "--wan_heads", "2", "--wan_ffn", "128", "--sla_block", "64", "--sla_topk", "0.5",
       "--bf16", "0", "--seed", "4", "--layer_mode", "loop", "--use_remat", "0"]


@pytest.fixture(scope="module")
def wan_weights(tmp_path_factory):
    """One diffusers-named safetensors file of a tiny dense WanDiT (numpy-seeded)."""
    jm = JWanDiT(dim=64, n_layers=1, n_heads=2, ffn_dim=128, in_channels=4, out_channels=4,
                 text_dim=32, attn_mode="dense", layer_mode="loop", dtype=jnp.float32)
    params = jparams(jm, np.zeros((1, 4, 8, 8, 8), np.float32), np.zeros((1,), np.int32),
                     np.zeros((1, 6, 32), np.float32), seed=7)
    sd = jconvert.export_wan_state_dict(params, (1, 2, 2), in_channels=4)
    path = str(tmp_path_factory.mktemp("wan") / "wan.safetensors")
    write_safetensors(path, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return path


def _wan_draws(seed, n, shape, n_train=1000):
    """The JAX CLIs' (t, eps) per batch: key, k_t, k_e = split(key, 3)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, k_t, k_e = jax.random.split(key, 3)
        out.append((np.asarray(jax.random.randint(k_t, (shape[0],), 0, n_train)),
                    np.asarray(jax.random.normal(k_e, shape, jnp.float32))))
    return out


def test_wan_sla_gap_report_matches_jax(wan_weights, monkeypatch, capsys):
    """--attn_mode dense becomes sla, as in the JAX CLI; the sparse model's
    q / k / v are rounded to bf16 in both packages."""
    _zero_init(monkeypatch, JWanDiT)
    argv = WAN + ["--attn_mode", "dense", "--max_batches", "2", "--batch", "2",
                  "--wan_pretrained", wan_weights]
    want = j_gap.main(argv)
    got = p_gap.main(argv + CPU, draws=_wan_draws(4, 2, (2, 8, 4, 8, 8)))
    assert set(got) == set(want) and "mse_sla_eps" in got
    _close(got["mse_dense_eps"], want["mse_dense_eps"])
    for k in ("mse_sla_eps", "mse_ratio"):
        _close(got[k], want[k], BF16_TOL)
    # the gap is the square of the kernel-level difference: held at 2^-8 of
    # the eps MSE it is measured against
    assert abs(got["mse_sla_vs_dense"] - want["mse_sla_vs_dense"]) <= BF16_TOL * want[
        "mse_dense_eps"]
    out = capsys.readouterr().out
    assert "shared" in out and "batch 1: mse_dense=" in out


@pytest.mark.parametrize("mode", ["dense", "sla"])
def test_wan_fullseq_eps_matches_jax(mode, wan_weights, monkeypatch, capsys):
    _zero_init(monkeypatch, JWanDiT)
    argv = WAN + ["--attn_mode", mode, "--max_batches", "3", "--batch", "1",
                  "--wan_pretrained", wan_weights]
    want = j_full.main(argv)
    got = p_full.main(argv + CPU, draws=_wan_draws(4, 3, (1, 8, 4, 8, 8)))
    _close(got, want, TOL if mode == "dense" else BF16_TOL)
    assert "'attn_mode': '%s'" % mode in capsys.readouterr().out
