"""The port's DiDeMo slice against the JAX package on the CPU, in f32: the
annotation parsers and clip windows, RawClipDataset's retry on neighbours,
read_video_clip (a real MJPG clip through OpenCV, and ImportError without a
decoder), the clip cache (write_clip_cache / CachedClipDataset, and the
synthetic precompute bit for bit), CLIPTextEncoder's ImportError without
`transformers` (it downloads weights, so it gets no run here), and both
DiDeMo trainers: the loss and every leaf's gradient on JAX's own loss_fn,
params, batch and draws (test_torch_toy_video.capture_jax_step), the CLIs'
flags, a tiny run of each CLI, and checkpoints written by JAX's trainers
read through the port's loader.

Tolerances: losses 1e-5 relative, gradients 1e-4 of each leaf's largest JAX
gradient; everything else exact.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import didemo as jdd
from interpolated_diffusion_tpu.data import precompute_clip_cache as jprep
from interpolated_diffusion_tpu.models import video_denoisers as jvd
from interpolated_diffusion_tpu.train import train_interp_levels_didemo as jil
from interpolated_diffusion_tpu.train import train_keypoints_didemo as jkp
from interpolated_diffusion_tpu_torch.data import didemo as pdd
from interpolated_diffusion_tpu_torch.data import precompute_clip_cache as pprep
from interpolated_diffusion_tpu_torch.models import clip_text as pclip
from interpolated_diffusion_tpu_torch.models import loading
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.train import train_interp_levels_didemo as pil
from interpolated_diffusion_tpu_torch.train import train_keypoints_didemo as pkp

from test_torch_interp_train import capture_jax_step
from test_torch_toy_video import _compare, _t, fast_init
from test_torch_wan_phase2_ops import jax_draws

CPU = torch.device("cpu")
NET = ["--d_model", "32", "--n_layers", "1", "--n_heads", "2", "--d_ff", "64", "--batch", "2",
       "--steps", "1", "--save_every", "1", "--log_every", "1", "--bf16", "0"]


# --- annotations, raw clips ------------------------------------------------------------------

def test_annotation_parsers_and_clip_windows_match_jax(tmp_path):
    assert pdd.mode_time_pair([[0, 0], [1, 1], [0, 0]]) == (0, 0) == jdd.mode_time_pair(
        [[0, 0], [1, 1], [0, 0]])
    assert pdd.mode_time_pair([]) == (0, 0)
    assert abs(pdd.parse_timecode("01.02.03.500") - 3723.5) < 1e-6
    with pytest.raises(ValueError):
        pdd.parse_timecode("01.02.03")
    ann = [{"video": "a.mp4", "description": "cap", "times": [[1, 1], [1, 1], [2, 3]]},
           {"video": "b.mp4", "times": [[0, 2], [0, 2]]}]          # multi-segment: dropped
    with open(tmp_path / "train_data.json", "w") as f:
        json.dump(ann, f)
    out = pdd.load_didemo_annotations(str(tmp_path), "train")
    assert out == jdd.load_didemo_annotations(str(tmp_path), "train")
    assert out == [{"video": "a.mp4", "caption": "cap", "start_sec": 5.0, "end_sec": 10.0}]
    assert len(pdd.load_didemo_annotations(str(tmp_path), "train", False)) == 2
    with open(tmp_path / "anns.csv", "w") as f:
        f.write("clip1\tx\t00.00.01.000\t00.00.03.000\tx\tsome caption\n"
                "clip2\tx\tbad\t00.00.03.000\tx\tskipped\nshort\trow\n")
    out = pdd.load_lsmdc_annotations(str(tmp_path / "anns.csv"))
    assert out == jdd.load_lsmdc_annotations(str(tmp_path / "anns.csv"))
    assert out == [{"video": "clip1", "caption": "some caption", "start_sec": 1.0,
                    "end_sec": 3.0}]
    for strategy in ("center", "random"):
        for args in ((2.0, 10.0, 3.0), (2.0, 4.0, 3.0), (1.0, 5.0, None)):
            got = pdd.clip_window(*args, np.random.RandomState(3), strategy)
            assert got == jdd.clip_window(*args, np.random.RandomState(3), strategy)
    assert pdd.clip_window(2.0, 10.0, 3.0, np.random.RandomState(0)) == (4.5, 7.5)


def test_raw_clip_dataset_retries_on_neighbours(tmp_path, monkeypatch):
    """As tests/test_round2_aux.py: a missing file and a decode error move on
    to the next annotation; an all-bad set fails after max_retries."""
    anns = [{"video": "missing_clip", "caption": "a", "start_sec": 0.0, "end_sec": 2.0},
            {"video": "corrupt_clip", "caption": "b", "start_sec": 0.0, "end_sec": 2.0},
            {"video": "good_clip", "caption": "c", "start_sec": 0.0, "end_sec": 2.0}]
    for name in ("corrupt_clip", "good_clip"):
        (tmp_path / f"{name}.mp4").write_bytes(b"x")

    def fake_read(path, start, end, T, frame_size):
        if "corrupt" in path:
            raise ValueError("decode failed")
        return np.zeros((T, 3, frame_size, frame_size), np.float32)

    monkeypatch.setattr(pdd, "read_video_clip", fake_read)
    ds = pdd.RawClipDataset(anns, str(tmp_path), T=4, frame_size=8)
    out = ds.get(0)
    assert out["video"] == "good_clip" and out["frames"].shape == (4, 3, 8, 8)
    assert out["text"] == "c" and len(ds) == 3
    ds_bad = pdd.RawClipDataset(anns[:2], str(tmp_path), T=4, frame_size=8, max_retries=4)
    with pytest.raises(RuntimeError, match="no decodable clip"):
        ds_bad.get(0)
    with pytest.raises(ValueError):
        pdd.RawClipDataset([], str(tmp_path), T=4)

    def no_decoder(*a):
        raise ImportError("no decoder")

    monkeypatch.setattr(pdd, "read_video_clip", no_decoder)
    with pytest.raises(ImportError):                      # retrying cannot help
        pdd.RawClipDataset(anns, str(tmp_path), T=4).get(1)


def test_read_video_clip_matches_jax_and_needs_a_decoder(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
    if not w.isOpened():
        pytest.skip("cv2 build lacks an encoder")
    for i in range(30):
        frame = np.full((48, 64, 3), i * 8, np.uint8)
        frame[:, :, 2] = 255 - i * 8
        w.write(frame)
    w.release()
    clip = pdd.read_video_clip(path, 0.5, 2.5, T=4, frame_size=16)
    assert clip.shape == (4, 3, 16, 16) and clip.dtype == np.float32
    assert np.array_equal(clip, jdd.read_video_clip(path, 0.5, 2.5, T=4, frame_size=16))
    assert np.all(np.diff(clip.mean(axis=(1, 2, 3))) > 0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.raises(ImportError, match="cv2 or imageio"):
        pdd.read_video_clip(path, 0.5, 2.5, T=4, frame_size=16)


def test_clip_text_encoder_needs_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        pclip.CLIPTextEncoder()


# --- caches ----------------------------------------------------------------------------------

def test_clip_cache_round_trip_and_synthetic_precompute_is_jax_bit_for_bit(tmp_path):
    r = np.random.default_rng(0)
    samples = [{"latents": r.normal(size=(6, 3, 8, 8)).astype(np.float32),
                "text_embed": r.normal(size=(2, 16)).astype(np.float32)} for _ in range(10)]
    pdd.write_clip_cache(str(tmp_path / "cache"), "train", samples, shard_size=4)
    ds = pdd.CachedClipDataset(str(tmp_path / "cache"), "train")
    jds = jdd.CachedClipDataset(str(tmp_path / "cache"), "train")
    assert len(ds) == 10 and len(ds.shards) == 3
    assert np.array_equal(ds.get(5)["latents"], samples[5]["latents"])
    got, want = ds.get_batch([1, 7, 9]), jds.get_batch([1, 7, 9])
    assert got["latents"].shape == (3, 6, 3, 8, 8)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    flags = ["--synthetic", "1", "--max_samples", "5", "--T", "6", "--shard_size", "2",
             "--seed", "3"]
    jprep.main(flags + ["--cache_dir", str(tmp_path / "j")])
    pprep.main(flags + ["--cache_dir", str(tmp_path / "p")])
    for name in ("index.json", "shard_00000.npz", "shard_00001.npz", "shard_00002.npz"):
        a, b = (str(tmp_path / d / "train" / name) for d in ("j", "p"))
        if name.endswith(".json"):
            assert open(a).read() == open(b).read()
            continue
        with np.load(a) as fa, np.load(b) as fb:
            assert fa.files == fb.files and all(
                np.array_equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype for k in fa.files)
    row = pdd.CachedClipDataset(str(tmp_path / "p"), "train").get(4)
    assert row["latents"].shape == (6, 3, 16, 16) and row["text_embed"].shape == (1, 64)
    ours, theirs = (vars(m.build_argparser().parse_args(["--cache_dir", "c"]))
                    for m in (pprep, jprep))
    assert ours == theirs


# --- trainers --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """Six clips of [T 6, C 3, 8, 8] latents with [4, 16] text: 16 tokens a
    frame at patch 2."""
    root = str(tmp_path_factory.mktemp("didemo_cache"))
    r = np.random.default_rng(1)
    pdd.write_clip_cache(root, "train", [
        {"latents": r.normal(size=(6, 3, 8, 8)).astype(np.float32),
         "text_embed": r.normal(size=(4, 16)).astype(np.float32)} for _ in range(6)], 4)
    return root


def test_keypoint_trainer_loss_and_grads_match_jax(cache, tmp_path, monkeypatch):
    flags = ["--cache_dir", cache, "--K", "3", "--cond_drop_prob", "0.9"] + NET
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jkp, jvd.VideoTokenKeypointDenoiser, flags + ["--out_dir", str(tmp_path)])
    B, N, D_tok = 2, 16, 12
    k_idx, k_t, k_eps, k_drop = jax.random.split(key, 4)
    draws = {"idx_rand": _t(jax.random.uniform(k_idx, (B, 3))),
             "t": _t(jax.random.randint(k_t, (B,), 0, 100)),
             "eps": _t(jax.random.normal(k_eps, (B, 3, N, D_tok))),
             "drop_rand": _t(jax.random.uniform(k_drop, (B,)))}
    assert (np.asarray(draws["drop_rand"]) < 0.9).any()        # the dropout acts
    args = pkp.build_argparser().parse_args(flags + ["--device", "cpu"])
    _, _, model = pkp.make_trainer(args, CPU, batch)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule

    schedule = make_schedule(args.schedule, args.N_train)
    _compare(loss_fn, params, batch, key, model,
             lambda b, d: pkp.keypoint_loss(model, args, schedule, b, d), draws,
             lambda p: params_to_state_dict(p, "video_keypoint"))


@pytest.mark.parametrize("extra", [["--mode", "adj"],
                                   ["--mode", "x0", "--corrupt_mode", "dist", "--w_anchor", "2"]])
def test_interp_trainer_loss_and_grads_match_jax(cache, tmp_path, monkeypatch, extra):
    flags = ["--cache_dir", cache, "--K_min", "3", "--levels", "2"] + NET + extra
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jil, jvd.VideoTokenInterpLevelDenoiser,
        flags + ["--out_dir", str(tmp_path)])
    draws = jax_draws(key, 2, 6, 16 * 12, 3, 2, adjacent="adj" in extra)
    args = pil.build_argparser().parse_args(flags + ["--device", "cpu"])
    _, _, model = pil.make_trainer(args, CPU, batch)
    _compare(loss_fn, params, batch, key, model, lambda b, d: pil.interp_loss(model, args, b, d),
             draws, lambda p: params_to_state_dict(p, "video_interp"))


def test_clis_flags_run_and_read_jax_checkpoints(cache, tmp_path, monkeypatch):
    """Every JAX flag with its default (the port adds --device and
    --attn_policy); each port CLI trains two steps and reads back; JAX's
    trainer CLIs write one-step checkpoints that the port's loader reads
    (the EMA tree, converted, is the model's state dict)."""
    from flax import serialization

    fast_init(monkeypatch, jvd.VideoTokenKeypointDenoiser, jvd.VideoTokenInterpLevelDenoiser)
    for mod, jmod, extra in ((pkp, jkp, ["--K", "3"]), (pil, jil, ["--K_min", "3"])):
        ours, theirs = (vars(m.build_argparser().parse_args(["--cache_dir", "c"]))
                        for m in (mod, jmod))
        assert set(ours) - set(theirs) == {"device", "attn_policy"}
        assert {k: ours[k] for k in theirs} == theirs and ours["device"] == "cuda"
        stage = "keypoints_didemo" if mod is pkp else "interp_levels_didemo"
        argv = ["--cache_dir", cache] + extra + NET
        out = str(tmp_path / stage)
        state = mod.main(argv + ["--device", "cpu", "--steps", "2", "--save_every", "2",
                                 "--out_dir", out])
        model, meta = loading.load_didemo_model(out, stage, False, True, "cpu")
        assert meta["stage"] == stage and meta["T"] == 6 and meta["text_dim"] == 16
        assert all(torch.equal(p, state.ema_params[k]) for k, p in model.named_parameters())
        jout = str(tmp_path / f"j_{stage}")
        jmod.main(argv + ["--out_dir", jout])
        with open(os.path.join(jout, "ckpt_1", "ema.msgpack"), "rb") as f:
            ema = serialization.msgpack_restore(f.read())
        model, meta = loading.load_didemo_model(jout, stage, False, True, "cpu")
        kind = "video_keypoint" if mod is pkp else "video_interp"
        want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, ema), kind)
        assert model.state_dict().keys() == want.keys()
        assert all(torch.equal(p, want[k]) for k, p in model.state_dict().items())
    with pytest.raises(NotImplementedError, match="n_data_shards"):
        pkp.main(["--cache_dir", cache, "--device", "cpu", "--n_data_shards", "2"])
    with pytest.raises(ValueError, match="not a DiDeMo stage"):
        loading.load_didemo_model(out, "keypoints_wansynth", device="cpu")
