"""The port's reader of the JAX package's checkpoints (utils/jax_checkpoint.py,
models/jax_import.checkpoint_to_state_dict, utils/checkpoint.load_checkpoint,
models/loading.py) on the CPU.

- The msgpack decoder against flax.serialization.msgpack_restore, bit for
  bit, on the three JAX checkpoints in runs/wansynth_debug and a tree with
  bf16, int32, 0-d arrays, numpy scalars and nested lists, with the
  `msgpack` package blocked (the machine with the card has none).
- A checkpoint of each ported stage, written by JAX's own save_checkpoint
  with the JAX trainers' metas, models and optimizer state (keypoints,
  interp_levels, causal interp_levels, segment_cost, selector; the CLI runs
  of JAX's trainers are in tests/test_torch_causal_sample.py): each loads
  through the port's loader (EMA by default, params with use_ema=False) and
  its forward equals the JAX loader's model, 3e-5 / 1e-4.
- runs/wansynth_debug/p1 (keypoints_wansynth: merged-form LoRA and the frame
  projector) into the port's WanDiT over the same seeded frozen base, equal
  to JAX's forward (dense attention, f32, head dim 32, 1e-4 of the output
  scale, as tests/test_torch_wan_model.py's f32 tolerance).
- runs/wansynth_debug/flow (flow_interpolator) through the port's loader,
  equal to JAX's forward on its params (f32, 1e-4).
- What does not cross over raises: unported stages, a resume (the optax
  optimizer state).
"""
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from interpolated_diffusion_tpu.models import loading as jloading
from interpolated_diffusion_tpu.models import selector as jsel
from interpolated_diffusion_tpu.train import state as jstate
from interpolated_diffusion_tpu.train import train_interp_levels as jt2
from interpolated_diffusion_tpu.train import train_keypoints as jt1
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.models import loading
from interpolated_diffusion_tpu_torch.train import common
from interpolated_diffusion_tpu_torch.utils import checkpoint, jax_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(ROOT, "runs", "wansynth_debug", n, "ckpt_2") for n in ("p1", "p2", "flow")]
B, T, G = 3, 16, 9


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def _same(got, want, path=""):
    """got (the port's reader) is want (flax's) bit for bit: the same tree,
    tensors for arrays and numpy scalars, equal bits, dtypes and shapes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        assert isinstance(got, torch.Tensor) and tuple(got.shape) == w.shape, path
        if w.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16, path
            assert np.array_equal(got.view(torch.uint16).numpy(), w.view(np.uint16)), path
        else:
            assert got.numpy().dtype == w.dtype, path
            assert got.numpy().tobytes() == w.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def test_msgpack_reader_is_flax_bit_for_bit_without_msgpack(monkeypatch):
    r = np.random.default_rng(0)
    tree = {"bf16": jnp.asarray(r.normal(size=(3, 5)), jnp.bfloat16),
            "int32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
            "zero_d": np.array(2.5, np.float32), "np_scalar": np.float32(-1.25),
            "np_int": np.int64(-7), "empty": np.zeros((0, 4), np.float16),
            "nested": [np.ones(2, np.uint8), [1, 2.5, "s", None, True], {"k": np.int16(3)}],
            "ints": [-1, -33, 200, 70000, 2 ** 40, -(2 ** 40)], "c": complex(1.5, -2.0),
            "text": "x" * 300, "f64": r.normal(size=(70000,)), "bool": np.array([True, False])}
    blobs = [open(os.path.join(p, "params.msgpack"), "rb").read() for p in FIXTURES]
    blobs.append(serialization.msgpack_serialize(tree))
    want = [serialization.msgpack_restore(b) for b in blobs]
    monkeypatch.setitem(sys.modules, "msgpack", None)       # `import msgpack` fails
    reader = importlib.reload(jax_checkpoint)
    for b, w in zip(blobs, want):
        _same(reader.msgpack_restore(b), w)
    with pytest.raises(ValueError, match="truncated"):
        reader.msgpack_restore(blobs[0][:-3])


def test_load_checkpoint_reads_a_jax_directory_it_used_to_miss(monkeypatch):
    """A JAX meta.json has no "format" key, so the torch branch's
    header.get("format", "torch") reads "torch" and goes on to open params.pt,
    which a JAX checkpoint does not have: FileNotFoundError. That branch is
    what load_checkpoint ran on such a directory before it recognised one by
    its params.msgpack; with the recognition turned off it fails so again."""
    path = FIXTURES[0]
    with open(os.path.join(path, "meta.json")) as f:
        header = json.load(f)
    assert "format" not in header and not os.path.exists(os.path.join(path, "params.pt"))
    step, payload = checkpoint.load_checkpoint(path, with_opt_state=False)
    assert step == 2 and payload["meta"]["stage"] == "keypoints_wansynth"
    assert set(payload["params"]) == {"lora", "frame_cond"} and "ema" not in payload
    assert checkpoint.read_meta(path) == (2, header["meta"])
    with monkeypatch.context() as m:
        m.setattr(checkpoint, "is_jax_checkpoint", lambda path: False)
        with pytest.raises(FileNotFoundError, match="params.pt"):
            checkpoint.load_checkpoint(path, with_opt_state=False)


def test_a_sharded_jax_checkpoint_raises_naming_its_reader(tmp_path):
    """JAX's sharded saver writes meta.json with "format": "orbax" and no
    params.msgpack."""
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"step": 1, "meta": {"stage": "keypoints"}, "format": "orbax"}, f)
    assert not jax_checkpoint.is_jax_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="utils/checkpoint_sharded.py"):
        checkpoint.load_checkpoint(str(tmp_path), with_opt_state=False)


def test_fixtures_leaf_counts_and_shapes():
    trees = [jax_checkpoint.read_tree(os.path.join(p, "params.msgpack")) for p in FIXTURES]
    counts = [len(traverse_util.flatten_dict(t)) for t in trees]
    assert counts == [44, 44, 26]
    p1 = trees[0]
    assert tuple(p1["frame_cond"]["fc_0"]["kernel"].shape) == (5, 256)
    assert tuple(p1["lora"]["block_1/ffn_out"]["A"].shape) == (128, 2)
    assert tuple(trees[2]["net"]["enc1"]["conv1"]["kernel"].shape) == (3, 3, 34, 8)


# --- a JAX checkpoint of each maze stage ----------------------------------------

TINY = ["--T", str(T), "--d_model", "32", "--n_layers", "2", "--n_heads", "4", "--d_ff", "64",
        "--d_cond", "16", "--maze_channels", "8,8", "--maze_h", str(G), "--maze_w", str(G),
        "--bf16", "0"]
SEL_META = dict(stage="selector", T=T, K=4, d_model=16, n_heads=2, d_ff=32, n_layers=2,
                pos_dim=8, use_sdf=0, cond_start_goal=1, use_sg_map=1, use_sg_token=1,
                use_goal_dist_token=1, use_cond_bias=1, cond_bias_mode="encoder", use_level=1,
                level_mode="k_norm", levels=2, k_schedule="doubling", sg_map_sigma=1.5,
                maze_channels="4,8", maze_h=G, maze_w=G)
DPHI_META = dict(stage="segment_cost", T=T, d_cond=16, seg_feat_dim=3, hidden_dim=24, n_layers=3,
                 use_sdf=0, cond_start_goal=1, maze_channels="4,8", normalize_targets=0,
                 target_mean=0.0, target_std=1.0, maze_h=G, maze_w=G)


def _cond(seed=0):
    r = np.random.default_rng(seed)
    return {"occ": (r.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32),
            "start_goal": r.uniform(size=(B, 4)).astype(np.float32),
            "level": r.uniform(size=(B, 1)).astype(np.float32)}


def _noisy(params, seed, scale=0.05):
    """flax zero-initialises biases and the Stage-2 head: move every leaf."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        np.asarray(p) + scale * r.normal(size=p.shape).astype(np.float32)), params)


def _stage_model(stage):
    """(JAX module, params, meta, inputs) as the JAX trainers build them."""
    cond = _cond()
    jc = {"occ": jnp.asarray(cond["occ"]), "start_goal": jnp.asarray(cond["start_goal"])}
    r = np.random.default_rng(1)
    if stage == "keypoints":
        args = jt1.build_argparser().parse_args(TINY + ["--K", "4"])
        model = jt1.build_model(args, 2)
        idx = np.array([[0, 3, 9, T - 1]] * B, np.int32)
        inputs = (r.normal(size=(B, 4, 2)).astype(np.float32), np.array([3, 40, 90], np.int32),
                  idx, r.uniform(size=(B, 4, 2)) < 0.3, cond, T)
        meta = jt1.make_meta(args, 2)
    elif stage in ("interp_levels", "causal"):
        args = jt2.build_argparser().parse_args(
            TINY + ["--K_min", "4", "--levels", "2", "--causal", str(int(stage == "causal"))])
        model = jt2.build_model(args, 2)
        mc = jt2.mask_channels_for(args)
        inputs = (r.normal(size=(B, T, 2)).astype(np.float32), np.array([2, 1, 2], np.int32),
                  (r.uniform(size=(B, T, mc)) < 0.4).astype(np.float32), cond)
        meta = jt2.make_meta(args, 2)
    elif stage == "selector":
        meta = SEL_META
        model = jsel.KeypointSelector(
            T=T, d_model=16, n_heads=2, d_ff=32, n_layers=2, pos_dim=8, use_goal_dist_token=True,
            use_cond_bias=True, cond_bias_mode="encoder", use_level=True, maze_channels=(4, 8))
        inputs = (cond,)
    else:
        meta = DPHI_META
        model = jsel.SegmentCostPredictor(d_cond=16, hidden_dim=24, maze_channels=(4, 8))
        inputs = (cond, r.uniform(size=(5, 3)).astype(np.float32))
    jin = [jc if isinstance(a, dict) else (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for a in inputs]
    if stage == "selector":
        jin[0] = dict(jc, level=jnp.asarray(cond["level"]))
    params = model.init(jax.random.PRNGKey(2), *jin)["params"]
    return model, _noisy(params, 3), meta, inputs, jin


_JAX_LOADERS = {"keypoints": jloading.load_keypoint_model,
                "interp_levels": jloading.load_interp_model, "causal": jloading.load_interp_model,
                "selector": jloading.load_selector_model,
                "segment_cost": jloading.load_segment_cost_model}
_PORT_LOADERS = {"keypoints": loading.load_keypoint_model,
                 "interp_levels": loading.load_interp_model, "causal": loading.load_interp_model,
                 "selector": loading.load_selector_model,
                 "segment_cost": loading.load_segment_cost_model}


def _torch_in(a):
    if isinstance(a, dict):
        return {k: torch.tensor(v) for k, v in a.items()}
    return torch.tensor(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("stage", ["keypoints", "interp_levels", "causal", "segment_cost",
                                   "selector"])
def test_jax_checkpoint_of_each_stage_loads_and_gives_the_jax_forward(stage, tmp_path):
    model, params, meta, inputs, jin = _stage_model(stage)
    with_ema = stage not in ("selector", "segment_cost")    # those trainers keep no EMA
    ema = _noisy(params, 4) if with_ema else None
    opt_state = jstate.make_optimizer(1e-3).init(params)
    path = str(tmp_path / "run" / "ckpt_3")
    jckpt.save_checkpoint(path, params, opt_state, 3, ema, meta)
    assert jax_checkpoint.is_jax_checkpoint(path)
    uses = [True, False] if with_ema else [False]
    for use_ema in uses:
        kw = {"use_ema": use_ema} if with_ema else {}
        jm, jp, _ = _JAX_LOADERS[stage](str(tmp_path / "run"), False, **kw)
        ref = jm.apply({"params": jp}, *jin)
        pm, pmeta = _PORT_LOADERS[stage](str(tmp_path / "run"), False, device="cpu", **kw)
        assert pmeta == meta
        if stage == "causal":
            assert pm.causal and all(layer.causal for layer in pm.transformer.layers)
        with torch.no_grad():
            out = pm(*map(_torch_in, inputs))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    # a resume needs the optax optimizer state, which does not cross over
    with pytest.raises(NotImplementedError, match="optax optimizer state"):
        common.resume_state(None, str(tmp_path / "run"), torch.device("cpu"))


# --- the Wan Phase-1 fixture ----------------------------------------------------

def test_wan_phase1_fixture_into_the_port_wan_dit():
    """p1 holds merged-form LoRA (A / B under "block_i/self_attn/q_proj"
    keys) and the frame projector; the frozen base is in neither package's
    checkpoint, so both sides take JAX's seeded base."""
    from interpolated_diffusion_tpu.models.lora import apply_lora
    from interpolated_diffusion_tpu.models.wan_dit import FrameCondProjector as JFrameCond
    from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
    from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
    from interpolated_diffusion_tpu_torch.models.wan_dit import FrameCondProjector, WanDiT

    path = FIXTURES[0]
    _, meta = checkpoint.read_meta(path)
    cfg = dict(dim=meta["wan_dim"], n_layers=meta["wan_layers"], n_heads=meta["wan_heads"],
               ffn_dim=meta["wan_ffn"], in_channels=meta["latent_c"],
               out_channels=meta["latent_c"], text_dim=meta["text_dim"])
    r = np.random.default_rng(0)
    Tf = 3
    lat = r.normal(size=(2, meta["latent_c"], Tf, meta["latent_h"], meta["latent_w"]))
    lat = lat.astype(np.float32)
    t = np.array([999, 111], np.int32)
    ctx = r.normal(size=(2, 5, meta["text_dim"])).astype(np.float32)
    fi = np.array([[0, 4, 8], [1, 2, 7]], np.int32)
    feat = r.uniform(size=(2, Tf, 5)).astype(np.float32)

    raw = serialization.msgpack_restore(open(os.path.join(path, "params.msgpack"), "rb").read())
    jfc = JFrameCond(feat_dim=5, text_dim=meta["text_dim"])
    extra = jfc.apply({"params": raw["frame_cond"]}, jnp.asarray(feat))
    jm = JWanDiT(attn_mode="dense", dtype=jnp.float32, **cfg)
    base = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, (lat, t, ctx, fi)), extra)["params"]
    merged = apply_lora(base, raw["lora"], meta["lora_rank"], meta["lora_alpha"])
    ref = np.asarray(jm.apply({"params": merged}, *map(jnp.asarray, (lat, t, ctx, fi)), extra))

    _, payload = checkpoint.load_checkpoint(path, with_opt_state=False)
    sd, _ = wan_params_to_state_dict(jax.tree.map(np.asarray, base))
    pm = WanDiT(attn_mode="dense", extra_context=True, lora_rank=meta["lora_rank"],
                lora_alpha=meta["lora_alpha"], **cfg).eval()
    pm.load_state_dict({**sd, **payload["params"]["lora"]}, strict=True)
    pfc = FrameCondProjector(feat_dim=5, text_dim=meta["text_dim"]).eval()
    pfc.load_state_dict(payload["params"]["frame_cond"], strict=True)
    with torch.no_grad():
        out = pm(*map(torch.tensor, (lat, t, ctx, fi)), pfc(torch.tensor(feat))).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    # the LoRA acts: without it the output moves
    pm.load_state_dict({k: torch.zeros_like(v) for k, v in payload["params"]["lora"].items()},
                       strict=False)
    with torch.no_grad():
        bare = pm(*map(torch.tensor, (lat, t, ctx, fi)), pfc(torch.tensor(feat))).numpy()
    assert np.abs(bare - ref).max() > 1e-3 * np.abs(ref).max()


def test_lora_layouts_convert_alike():
    """The runtime layout (lora_A / lora_B under block_i/...), the scan layout
    (stacked on a leading layer axis) and remat groups give the leaves of the
    merged form."""
    from interpolated_diffusion_tpu_torch.models.jax_import import (lora_params_to_state_dict,
                                                                    lora_to_params)

    raw = jax_checkpoint.read_tree(os.path.join(FIXTURES[0], "params.msgpack"))["lora"]
    want = lora_params_to_state_dict(raw)
    assert len(want) == 2 * 2 * 10
    runtime = lora_to_params(want)
    assert set(runtime) == {"block_0", "block_1"}
    grouped = {"group_0": {"block_0": runtime["block_0"]},
               "group_1": {"block_0": runtime["block_1"]}}
    for tree in (runtime, lora_to_params(want, "scan"), grouped):
        got = lora_params_to_state_dict(tree)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("stage,match", [("no_such_stage", "stage 'no_such_stage'")])
def test_unported_stages_raise_naming_what_is_missing(tmp_path, stage, match):
    """A JAX checkpoint of a stage the port has no module for, written by
    JAX's save_checkpoint. (Every stage of the JAX package has one: the
    video_interpolator stage, which raised here before, is read in
    tests/test_torch_toy_video.py.)"""
    path = str(tmp_path / "ckpt_1")
    jckpt.save_checkpoint(path, {"dwconv_0": {"kernel": jnp.zeros((3, 1, 4)),
                                              "bias": jnp.zeros((4,))}}, None, 1, None,
                          {"stage": stage})
    with pytest.raises(NotImplementedError, match=match):
        checkpoint.load_checkpoint(path, with_opt_state=False)


def test_flow_fixture_loads_and_matches_jax():
    """runs/wansynth_debug/flow/ckpt_2 (stage flow_interpolator, written by
    JAX's trainer) through the port's loader: its forward equals JAX's on the
    checkpoint's params, 1e-4 of the output's scale (f32)."""
    from interpolated_diffusion_tpu.models import flow_interpolator as jfi

    from test_torch_interpolators import japply, jparams, rel

    pm, meta = loading.load_flow_interpolator(FIXTURES[2], device="cpu")
    assert meta["stage"] == "flow_interpolator" and pm.gap_cond and pm.time_mask
    r = np.random.default_rng(4)
    lat = r.normal(size=(2, 9, 4, 8, 8)).astype(np.float32)
    idx = np.array([[0, 4, 8], [0, 3, 8]], np.int32)
    jm = jfi.LatentFlowInterpolator(
        in_channels=4, base_channels=8, max_flow=20.0, residual_blocks=1, time_mask=True,
        gap_cond=True, use_cost_volume=True, cv_radius=2)
    _, payload = jckpt.load_checkpoint(FIXTURES[2], jparams(jm, lat, idx))
    ref_out, ref_conf = japply(jm, payload["params"], lat, idx)
    with torch.no_grad():
        out, conf = pm(torch.tensor(lat), torch.tensor(idx).long())
    assert rel(out, ref_out) <= 1e-4 and rel(conf, ref_conf) <= 1e-4


def test_a_wan_tree_with_other_leaves_raises():
    """The wansynth readers take the LoRA, frame-projector and WanDiT trees
    (`wan_base`, and `wan` of a run that trained every weight); a tree with
    any other leaves says so rather than drop them."""
    from interpolated_diffusion_tpu_torch.models.jax_import import checkpoint_to_state_dict

    for stage in ("keypoints_wansynth", "interp_levels_wansynth"):
        with pytest.raises(NotImplementedError, match="moe"):
            checkpoint_to_state_dict({"stage": stage, "use_wan": 1},
                                     {"moe": {"kernel": np.zeros((2, 2), np.float32)}})
    # a WanDiT with Switch-MoE blocks (ffn_mode moe) is a tree it reads: the
    # router and the stacked experts, loop and scan layouts alike
    from interpolated_diffusion_tpu_torch.models import jax_import

    r = np.random.default_rng(0)
    moe = {"router": {"kernel": r.normal(size=(8, 2)).astype(np.float32),
                      "bias": np.zeros(2, np.float32)},
           "ffn_in": r.normal(size=(2, 8, 16)).astype(np.float32),
           "ffn_in_bias": np.zeros((2, 16), np.float32),
           "ffn_out": r.normal(size=(2, 16, 8)).astype(np.float32)}
    attn = {n: {"kernel": np.zeros((8, 8), np.float32), "bias": np.zeros(8, np.float32)}
            for n in ("q_proj", "k_proj", "v_proj", "o_proj")}
    attn.update(q_norm={"scale": np.ones(8, np.float32)}, k_norm={"scale": np.ones(8, np.float32)})
    block = {"scale_shift_table": np.zeros((1, 6, 8), np.float32), "self_attn": attn,
             "cross_attn": attn, "norm2": {"scale": np.ones(8, np.float32),
                                           "bias": np.zeros(8, np.float32)}, "moe_ffn": moe}
    for tree in ({"block_0": block},
                 {"blocks": {"block": jax.tree.map(lambda a: np.stack([a, a]), block)}}):
        sd = {}
        for i, blk in enumerate(jax_import._wan_blocks(tree)):
            jax_import._wan_block(sd, f"blocks.{i}.", blk)
        router = sd["blocks.0.moe_ffn.router.weight"].numpy()
        assert np.array_equal(router, moe["router"]["kernel"].T)
        assert np.array_equal(sd["blocks.0.moe_ffn.ffn_out"].numpy(), moe["ffn_out"])
        assert not any(".ffn.net." in k for k in sd)
