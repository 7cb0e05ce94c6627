"""The port's interpolator / selector CLIs, the teacher precompute, the
interpolator evaluation and full WanDiT fine-tuning under bf16, on the CPU.

- Each of the five trainer CLIs runs tiny (`--device cpu`) and writes a
  checkpoint that the port's loader reads back into the trained weights;
  each refuses `--n_data_shards` and, without a GPU, the default device.
- The teacher shards (lerp, and the JAX fixture runs/wansynth_debug/flow as
  a model teacher) equal the JAX package's precompute_teacher_shards on the
  same tar shards (lerp exactly, the model 1e-4 of the scale) and join back
  through WanSynthTarDataset(teacher_root=...).
- eval_interpolators' report under lerp, flow (the fixture) and sinkhorn (a
  checkpoint JAX's save_checkpoint wrote) against the JAX CLI's on the same
  clips and anchor draws: every key, 1e-4 relative (counts equal); with
  `--rgb 1 --vae_sd FILE` too (the four rgb_* keys: prediction, lerp and
  ground truth decoded by each package's SDVAE from one safetensors file).
- WanDiT with every weight an f32 master computing in bf16
  (init_wan_trainables at lora_rank 0) against JAX's WanDiT(dtype=bfloat16)
  over f32 params: the loss within 1e-2 and every weight's gradient within
  5e-2 of its largest, the tolerances of the card's kernel-vs-twin gate, and
  every gradient f32. bf16 rounds each product and sum at 2^-8, and the two
  frameworks reduce the per-token terms of a weight's gradient in other
  orders and precisions: JAX's own jitted and op-by-op runs of this loss
  differ by 0.9%, the port's gradients sit 1.3% (median leaf) and 4.5%
  (worst, an RMSNorm scale) from the jitted run, against which it is held.
"""
import functools
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.diagnostics import eval_interpolators as jeval
from interpolated_diffusion_tpu.models import flow_interpolator as jfi
from interpolated_diffusion_tpu.models import sd_vae as jsd
from interpolated_diffusion_tpu.models import sinkhorn_warp as jsw
from interpolated_diffusion_tpu.teachers import teacher as jteach
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.data import make_synth_tars
from interpolated_diffusion_tpu_torch.data import precompute_teacher as pprep
from interpolated_diffusion_tpu_torch.data.wan_synth import WanSynthTarDataset, iter_tar_samples
from interpolated_diffusion_tpu_torch.diagnostics import eval_interpolators as peval
from interpolated_diffusion_tpu_torch.models import loading
from interpolated_diffusion_tpu_torch.models import sd_vae as psd
from interpolated_diffusion_tpu_torch.models.straightener import load_latent_straightener
from interpolated_diffusion_tpu_torch.teachers import teacher as pteach
from interpolated_diffusion_tpu_torch.train import train_flow_interpolator_wansynth as pflow
from interpolated_diffusion_tpu_torch.train import train_latent_straightener_wansynth as pstr
from interpolated_diffusion_tpu_torch.train import train_segment_cost_wansynth as pseg
from interpolated_diffusion_tpu_torch.train import train_sinkhorn_interp_wansynth as psk
from interpolated_diffusion_tpu_torch.train import train_video_selector_wansynth as psel
from interpolated_diffusion_tpu_torch.utils.checkpoint import read_meta
from interpolated_diffusion_tpu_torch.utils.safetensors import write_safetensors

from test_torch_interpolators import jparams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW = os.path.join(ROOT, "runs", "wansynth_debug", "flow", "ckpt_2")
TINY = ["--num_samples", "8", "--T", "8", "--latent_c", "4", "--latent_h", "8", "--latent_w", "8",
        "--text_len", "6", "--text_dim", "32", "--batch", "2"]
CLIS = {
    "flow": (pflow, ["--base_channels", "8"], loading.load_flow_interpolator),
    "straightener": (pstr, ["--hidden_channels", "8"], load_latent_straightener),
    "straightener_token": (pstr, ["--arch", "token", "--token_patch", "2", "--token_d_model",
                                  "32", "--token_layers", "1"], load_latent_straightener),
    "sinkhorn": (psk, ["--sinkhorn_patch", "2", "--win_size", "3", "--val_every", "2",
                       "--val_batches", "1"], loading.load_sinkhorn_interp),
    "segment_cost": (pseg, ["--d_cond", "16", "--hidden_dim", "32"],
                     loading.load_video_segment_cost),
    "video_selector": (psel, ["--K", "3", "--d_model", "32", "--d_cond", "16", "--n_sel_layers",
                              "1", "--n_heads", "2", "--d_ff", "64", "--eval_every", "2"],
                       loading.load_video_selector),
}


def rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture
def fast_flax_init(monkeypatch):
    """JAX's own CLIs build their models by an op-by-op flax init (~30 s of
    primitive compiles for the flow or the Sinkhorn model); the loaded
    checkpoint replaces those params, so the init returns random ones in its
    shapes."""
    for cls in (jfi.LatentFlowInterpolator, jsw.SinkhornWarpInterpolator):
        monkeypatch.setattr(cls, "init", lambda self, rngs, *a, method=None, **kw:
                            {"params": jparams(self, *a, method=method, **kw)})


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_trains_tiny_and_its_checkpoint_reads_back(tmp_path, capsys, name):
    module, extra, load = CLIS[name]
    out = str(tmp_path / name)
    state = module.main(TINY + extra + ["--device", "cpu", "--steps", "2", "--log_every", "1",
                                        "--out_dir", out])
    log = capsys.readouterr().out
    steps = [l for l in log.splitlines() if l.startswith("step ")]
    assert [l.split()[1] for l in steps] == ["0", "1"] and all("s/step" in l for l in steps)
    if name == "sinkhorn":
        assert "[val] sinkhorn" in log and "vs lerp" in log
    if name == "video_selector":
        assert "[eval] top-K/DP overlap" in log
    assert os.path.exists(os.path.join(out, "run_config.json"))
    step, meta = read_meta(os.path.join(out, "ckpt_2"))
    assert step == 2
    model, meta2 = load(out, device="cpu")
    assert meta2 == meta
    got = dict(model.named_parameters())
    assert got.keys() == state.params.keys()
    assert all(torch.equal(got[k], state.params[k].detach()) for k in got)
    assert all(bool(torch.isfinite(p).all()) for p in got.values())


def test_clis_refuse_what_is_not_ported(tmp_path):
    for name, (module, extra, _) in CLIS.items():
        argv = TINY + extra + ["--out_dir", str(tmp_path / name)]
        with pytest.raises(NotImplementedError, match="n_data_shards"):
            module.main(argv + ["--device", "cpu", "--n_data_shards", "2"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                module.main(argv)                    # --device defaults to cuda
    with pytest.raises(NotImplementedError, match="JAX CLI builds no model for tiny"):
        peval.main(["--interpolator", "tiny", "--ckpt", FLOW, "--device", "cpu"])
    with pytest.raises(SystemExit, match="4-channel SD latents"):   # --rgb on Wan latents
        peval.main(["--rgb", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="LDMVFI"):
        pprep.main(["--data_root", str(tmp_path), "--out_root", str(tmp_path / "t"),
                    "--teacher", "ldmvfi", "--device", "cpu"])


def test_teacher_shards_match_jax_and_join_back(tmp_path, fast_flax_init):
    data = str(tmp_path / "data")
    make_synth_tars.main(["--out_root", data, "--num_samples", "4", "--shard_size", "2",
                          "--T", "9", "--latent_c", "4", "--latent_h", "8", "--latent_w", "8",
                          "--text_len", "4", "--text_dim", "8"])
    for teacher in ("lerp", f"model:{FLOW}"):
        tag = "lerp" if teacher == "lerp" else "flow"
        n = pprep.main(["--data_root", data, "--out_root", str(tmp_path / f"p_{tag}"), "--T",
                        "9", "--teacher", teacher, "--device", "cpu"])
        jt = jteach.LerpTeacher() if tag == "lerp" else jteach.ModelTeacher(FLOW)
        assert n == jteach.precompute_teacher_shards(data, str(tmp_path / f"j_{tag}"), 9,
                                                     teacher=jt) == 4
        for shard in sorted(os.listdir(tmp_path / f"j_{tag}")):
            want = list(iter_tar_samples(str(tmp_path / f"j_{tag}" / shard)))
            got = list(iter_tar_samples(str(tmp_path / f"p_{tag}" / shard)))
            assert [s["__key__"] for s in got] == [s["__key__"] for s in want]
            for g, w in zip(got, want):
                assert g["teacher_latents"].shape == w["teacher_latents"].shape == (4, 4, 8, 8)
                if tag == "lerp":
                    assert np.array_equal(g["teacher_latents"], w["teacher_latents"])
                else:
                    assert rel(g["teacher_latents"], w["teacher_latents"]) <= 1e-4
    # the join: every clip carries its teacher mid-frames, by key
    joined = list(pteach.PrecomputedTeacher(str(tmp_path / "p_flow")).stream(data, 9))
    assert len(joined) == 4 and all(s["teacher_latents"].shape == (4, 4, 8, 8) for s in joined)
    batch = next(WanSynthTarDataset(data, T=9, teacher_root=str(tmp_path / "p_lerp"))
                 .batches(2))
    lat = batch["latents"]
    np.testing.assert_allclose(batch["teacher_latents"][:, 0], 0.5 * (lat[:, 0] + lat[:, 2]),
                               atol=1e-6)


def _sinkhorn_ckpt(tmp_path):
    """A sinkhorn_interp checkpoint written by JAX's save_checkpoint (no
    global alignment: its five angles would triple the JAX compile, and the
    phase correlation is held to JAX in tests/test_torch_interpolators.py)."""
    meta = {"stage": "sinkhorn_interp", "in_channels": 4, "patch_size": 2, "win_size": 3,
            "sinkhorn_iters": 5, "global_mode": "none", "sinkhorn_tau": 0.05,
            "dustbin_logit": -2.0, "learn_tau": 1, "learn_dustbin": 1, "fb_sigma": 2.0,
            "d_match": 0}
    path = str(tmp_path / "sk" / "ckpt_1")
    jckpt.save_checkpoint(path, {"tau_raw": jnp.asarray(-2.7, jnp.float32),
                                 "dustbin": jnp.asarray(-1.6, jnp.float32)}, None, 1, None, meta)
    return path


@pytest.mark.parametrize("interp", ["lerp", "flow", "sinkhorn"])
def test_eval_interpolators_report_matches_jax(tmp_path, fast_flax_init, interp):
    argv = ["--interpolator", interp, "--T", "9", "--K", "3", "--latent_c", "4", "--latent_h",
            "8", "--latent_w", "8", "--batch", "2", "--num_batches", "2"]
    if interp != "lerp":
        argv += ["--ckpt", FLOW if interp == "flow" else _sinkhorn_ckpt(tmp_path)]
    got, want = _both_reports(argv)
    if interp == "lerp":
        assert got["l1_vs_lerp_pct"] == 0.0


def _both_reports(argv, batch=2, T=9, n_batches=2):
    """The JAX CLI's report and the port's (on the CPU, with the JAX CLI's
    anchor draws: one split of its key per batch), held key by key at 1e-4
    relative, counts and names equal."""
    want = jeval.main(argv)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(n_batches):
        key, k = jax.random.split(key)
        draws.append({"idx_rand": np.asarray(jax.random.uniform(k, (batch, T - 2)))})
    got = peval.main(argv + ["--device", "cpu"], draws=draws)
    assert set(got) == set(want) | {"samples_per_sec"}
    for k, v in want.items():
        if isinstance(v, int) or isinstance(v, str):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, got[k], v)
    return got, want


SD_NARROW = (32, 32)


@pytest.fixture
def narrow_sd_vae(monkeypatch):
    """Both CLIs' SD VAE, and the safetensors loader of each package, at two
    levels of 32 channels: at SD 1.x width a 64x64 frame decodes in ~1 s on
    the CPU in each framework, and a report decodes every frame three times.
    The full width is held to the card's CPU forward by chip_smoke.py."""

    class JaxNarrow(jsd.SDVAE):
        block_out: Sequence[int] = SD_NARROW

    class PortNarrow(psd.SDVAE):
        def __init__(self, block_out=SD_NARROW, **kw):
            super().__init__(block_out, **kw)

    monkeypatch.setattr(jsd, "SDVAE", JaxNarrow)
    monkeypatch.setattr(psd, "SDVAE", PortNarrow)
    for mod in (jsd, psd):
        monkeypatch.setattr(mod, "load_sd_vae_safetensors", functools.partial(
            mod.load_sd_vae_safetensors, block_out=SD_NARROW))
    return JaxNarrow


@pytest.mark.parametrize("interp", ["flow", "sinkhorn"])
def test_eval_interpolators_rgb_report_matches_jax(tmp_path, fast_flax_init, narrow_sd_vae,
                                                   interp):
    """`--rgb 1 --vae_sd FILE`: one diffusers-named safetensors file of
    seeded SDVAE params, read by both CLIs; the four rgb_* keys (and every
    other) at 1e-4, on pixel values that are neither saturated nor the lerp's."""
    params = jparams(narrow_sd_vae(), np.zeros((1, 1, 3, 16, 16), np.float32), seed=5)
    vae_file = str(tmp_path / "vae.safetensors")
    write_safetensors(vae_file, {k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in psd.export_sd_vae_state_dict(params).items()})
    argv = ["--interpolator", interp, "--ckpt", FLOW if interp == "flow" else
            _sinkhorn_ckpt(tmp_path), "--T", "5", "--K", "3", "--latent_c", "4", "--latent_h",
            "8", "--latent_w", "8", "--batch", "2", "--num_batches", "1", "--rgb", "1",
            "--vae_sd", vae_file]
    got, want = _both_reports(argv, T=5, n_batches=1)
    rgb = ("rgb_psnr", "rgb_psnr_lerp", "rgb_ssim", "rgb_ssim_lerp")
    assert all(k in want for k in rgb)
    assert 0.0 < got["rgb_psnr"] < 60.0 and got["rgb_psnr"] != got["rgb_psnr_lerp"]


def test_full_finetune_bf16_matches_jax():
    from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
    from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
    from interpolated_diffusion_tpu_torch.models.wan_dit import WanDiT
    from interpolated_diffusion_tpu_torch.train import wansynth_common as pcommon
    import argparse

    cfg = dict(dim=48, n_layers=2, n_heads=4, ffn_dim=96, in_channels=4, out_channels=4,
               text_dim=32)
    r = np.random.default_rng(0)
    lat = r.normal(size=(2, 4, 3, 8, 8)).astype(np.float32)
    t = np.array([999, 111], np.int32)
    ctx = r.normal(size=(2, 5, 32)).astype(np.float32)
    fi = np.array([[0, 7, 20], [2, 3, 15]], np.int32)
    w = r.normal(size=lat.shape).astype(np.float32)
    jm = JWanDiT(attn_mode="dense", layer_mode="loop", dtype=jnp.bfloat16, **cfg)
    params = jparams(jm, lat, t, ctx, fi)

    def loss(p):
        out = jm.apply({"params": p}, *map(jnp.asarray, (lat, t, ctx, fi)))
        return jnp.sum(out.astype(jnp.float32) * w)

    ref_loss, ref = jax.jit(jax.value_and_grad(loss))(params)
    pm = WanDiT(attn_mode="dense", **cfg)
    pm.load_state_dict(wan_params_to_state_dict(params)[0], strict=True)
    args = argparse.Namespace(lora_rank=0, ffn_mode="dense", lora_form="runtime")
    trainable, base = pcommon.init_wan_trainables(args, pm, None, bf16=True)
    assert base is None and set(trainable) == {"wan"}
    leaves = trainable["wan"]
    assert all(p.dtype == torch.float32 and p.requires_grad for p in leaves.values())
    out = pm(*map(torch.tensor, (lat, t, ctx, fi)))
    got_loss = (out * torch.tensor(w)).sum()
    grads = dict(zip(leaves, torch.autograd.grad(got_loss, list(leaves.values()))))
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert abs(got_loss.item() - float(ref_loss)) <= 1e-2 * abs(float(ref_loss))
    want = wan_params_to_state_dict(jax.tree_util.tree_map(np.asarray, ref))[0]
    assert want.keys() == grads.keys()
    worst = max((rel(grads[k].numpy(), want[k].numpy()), k) for k in want)
    assert worst[0] <= 5e-2, worst


def test_a_jax_full_finetune_checkpoint_reads_and_matches(tmp_path):
    """A keypoints_wansynth checkpoint whose tree holds `wan` (every weight
    trained, no LoRA) and the frame projector, written by JAX's
    save_checkpoint, loads through the port's load_wansynth_model; its
    forward equals JAX's (f32, dense attention, 1e-4 of the output scale)."""
    from interpolated_diffusion_tpu.models.wan_dit import FrameCondProjector as JFrameCond
    from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT

    cfg = dict(dim=48, n_layers=2, n_heads=4, ffn_dim=96, in_channels=4, out_channels=4,
               text_dim=32)
    r = np.random.default_rng(1)
    lat = r.normal(size=(2, 4, 3, 8, 8)).astype(np.float32)
    t = np.array([700, 30], np.int32)
    ctx = r.normal(size=(2, 5, 32)).astype(np.float32)
    feat = r.uniform(size=(2, 3, 5)).astype(np.float32)
    jfc = JFrameCond(feat_dim=5, text_dim=32)
    fc_params = jparams(jfc, feat)
    extra = jfc.apply({"params": fc_params}, jnp.asarray(feat))
    jm = JWanDiT(attn_mode="dense", layer_mode="loop", **cfg)
    wan_params = jparams(jm, lat, t, ctx, None, extra, seed=2)
    ref = jax.jit(jm.apply)({"params": wan_params}, *map(jnp.asarray, (lat, t, ctx)), None, extra)
    meta = {"stage": "keypoints_wansynth", "use_wan": 1, "wan_dim": 48, "wan_layers": 2,
            "wan_heads": 4, "wan_ffn": 96, "latent_c": 4, "text_dim": 32, "T": 3,
            "lora_rank": 0, "attn_mode": "dense", "frame_cond": 1, "layer_mode": "loop",
            "wan_head_mod": "t_emb"}
    path = str(tmp_path / "ckpt_1")
    jckpt.save_checkpoint(path, {"wan": wan_params, "frame_cond": fc_params}, None, 1, None,
                          meta)
    wan, fc, _ = loading.load_wansynth_model(path, "keypoints_wansynth", bf16=False,
                                             device="cpu")
    with torch.no_grad():
        out = wan(*map(torch.tensor, (lat, t, ctx)), None, fc(torch.tensor(feat)))
    assert rel(out.numpy(), ref) <= 1e-4
