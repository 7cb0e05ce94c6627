"""The Wan path's small ops in the port against the JAX package, f32 on the
CPU, same numpy-seeded inputs: video tokens, frame features, 3D RoPE,
RMSNorm, runtime LoRA, the parameter-free LayerNorm and the dense attention
over a cross-attention key length.

Tolerance: max|port - jax| <= 1e-5 * max(1, max|jax|) (the same f32 math,
summed in another order); token reshapes and the LUT-free integer paths are
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from interpolated_diffusion_tpu.models import transformer as jtr
from interpolated_diffusion_tpu.models import wan_dit as jwd
from interpolated_diffusion_tpu.utils.frame_features import frame_features_from_mask as j_ff
from interpolated_diffusion_tpu.utils.video_tokens import patchify_latents as j_patchify
from interpolated_diffusion_tpu.utils.video_tokens import unpatchify_tokens as j_unpatchify
from interpolated_diffusion_tpu_torch.models import transformer as ptr
from interpolated_diffusion_tpu_torch.models import wan_dit as pwd
from interpolated_diffusion_tpu_torch.utils.frame_features import frame_features_from_mask
from interpolated_diffusion_tpu_torch.utils.video_tokens import patchify_latents, unpatchify_tokens


def close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("p", [1, 2])
def test_video_tokens_roundtrip_matches_jax(p):
    lat = np.random.default_rng(p).normal(size=(2, 3, 4, 6, 10)).astype(np.float32)
    tok, spatial = patchify_latents(torch.tensor(lat), p)
    jtok, jspatial = j_patchify(jnp.asarray(lat), p)
    assert spatial == jspatial
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    back = unpatchify_tokens(tok, p, spatial)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_unpatchify(jtok, p, jspatial)))
    np.testing.assert_array_equal(back.numpy(), lat)


def test_frame_features_match_jax():
    r = np.random.default_rng(0)
    mask = r.uniform(size=(6, 21)) < 0.25
    mask[3] = False                      # no anchor: endpoint fallback
    mask[4] = False
    mask[4, 7] = True                    # one interior anchor
    for include_time in (True, False):
        out = frame_features_from_mask(torch.tensor(mask), include_time)
        close(out, j_ff(jnp.asarray(mask), include_time))


@pytest.mark.parametrize("head_dim", [12, 128])
def test_rope_tables_and_freqs_match_jax(head_dim):
    tables, dims = pwd.wan_rope_tables(64, head_dim)
    jtables, jdims = jwd.wan_rope_tables(64, head_dim)
    assert dims == jdims
    for axis in "thw":
        for i in (0, 1):
            close(tables[axis][i], jtables[axis][i])
    fi = np.array([[0, 7, 20], [2, 3, 15]], np.int32)
    for frame_indices in (None, fi):
        cos, sin = pwd.build_rope_freqs(tables, dims, 3, 4, 5,
                                        None if frame_indices is None else torch.tensor(fi))
        jcos, jsin = jwd.build_rope_freqs(jtables, jdims, 3, 4, 5,
                                          None if frame_indices is None else jnp.asarray(fi), 2)
        close(cos, jcos)
        close(sin, jsin)


def test_apply_rope_matches_jax():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 3, 60, 12)).astype(np.float32)
    tables, dims = pwd.wan_rope_tables(64, 12)
    jtables, _ = jwd.wan_rope_tables(64, 12)
    fi = np.array([[1, 9, 30], [0, 4, 5]], np.int32)
    cos, sin = pwd.build_rope_freqs(tables, dims, 3, 4, 5, torch.tensor(fi))
    jcos, jsin = jwd.build_rope_freqs(jtables, dims, 3, 4, 5, jnp.asarray(fi), 2)
    close(pwd.apply_rope(torch.tensor(x), cos, sin), jwd.apply_rope(jnp.asarray(x), jcos, jsin))


def test_rmsnorm_and_lora_linear_match_jax():
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 7, 24)).astype(np.float32)
    jn = jwd.RMSNorm(24)
    scale = (1 + 0.1 * r.normal(size=24)).astype(np.float32)
    ref = jn.apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    pn = pwd.RMSNorm(24)
    pn.weight.data = torch.tensor(scale)
    with torch.no_grad():
        close(pn(torch.tensor(x)), ref)

    jl = jwd.LoRADense(features=16, rank=3, alpha=8.0)
    p = {"kernel": r.normal(size=(24, 16)) * 0.2, "bias": r.normal(size=16) * 0.1,
         "lora_A": r.normal(size=(24, 3)) / 3, "lora_B": r.normal(size=(3, 16)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ref = jl.apply({"params": {k: jnp.asarray(v) for k, v in p.items()}}, jnp.asarray(x))
    pl = pwd.LoRALinear(24, 16, rank=3, alpha=8.0)
    pl.load_state_dict({"weight": torch.tensor(p["kernel"].T.copy()), "bias": torch.tensor(p["bias"]),
                        "lora_A": torch.tensor(p["lora_A"].T.copy()),
                        "lora_B": torch.tensor(p["lora_B"].T.copy())})
    with torch.no_grad():
        close(pl(torch.tensor(x)), ref)


def test_layernorm_without_affine_matches_flax():
    x = (np.random.default_rng(3).normal(size=(2, 5, 48)) * 3 + 1).astype(np.float32)
    ref = nn.LayerNorm(use_bias=False, use_scale=False).apply({}, jnp.asarray(x))
    ln = ptr.LayerNorm(48, affine=False)
    assert not list(ln.parameters())
    close(ln(torch.tensor(x)), ref)


def test_dense_attention_cross_length_matches_jax():
    """The port's packed dense attention with Lk != Lq (cross-attention)
    against the JAX [B, H, L, Dh] dense_attention."""
    r = np.random.default_rng(4)
    B, H, L, Lk, dh = 2, 4, 9, 13, 8
    q = r.normal(size=(B, H, L, dh)).astype(np.float32)
    k, v = (r.normal(size=(B, H, Lk, dh)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jtr.dense_attention(*map(jnp.asarray, (q, k, v))))
    packed = lambda t: torch.tensor(t).transpose(1, 2).reshape(B, t.shape[2], H * dh)
    out = ptr.dense_attention(packed(q), packed(k), packed(v), H)
    close(out, ref.transpose(0, 2, 1, 3).reshape(B, L, H * dh))


def test_wan_port_import_pulls_in_no_jax():
    """The slice's modules, and chip_smoke.py, import neither JAX (nor flax, optax or
    msgpack) nor the JAX package."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import chip_smoke, interpolated_diffusion_tpu_torch.sample.wan_anchors, "
            "interpolated_diffusion_tpu_torch.train.wansynth_common, "
            "interpolated_diffusion_tpu_torch.models.jax_import, "
            "interpolated_diffusion_tpu_torch.models.hunyuan_video, "
            "interpolated_diffusion_tpu_torch.kernels.sla, "
            "interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth, "
            "interpolated_diffusion_tpu_torch.train.state, "
            "interpolated_diffusion_tpu_torch.data.wan_synth, "
            "interpolated_diffusion_tpu_torch.data.dataset, "
            "interpolated_diffusion_tpu_torch.utils.checkpoint, "
            "interpolated_diffusion_tpu_torch.utils.ema, "
            "interpolated_diffusion_tpu_torch.utils.prefetch, "
            "interpolated_diffusion_tpu_torch.utils.memguard, "
            "interpolated_diffusion_tpu_torch.ops.video_keyframes, "
            "interpolated_diffusion_tpu_torch.ops.normalize, "
            "interpolated_diffusion_tpu_torch.kernels.small_mha, "
            "interpolated_diffusion_tpu_torch.kernels.fused_block, "
            "interpolated_diffusion_tpu_torch.models.loading, "
            "interpolated_diffusion_tpu_torch.data.maze, "
            "interpolated_diffusion_tpu_torch.data.astar, "
            "interpolated_diffusion_tpu_torch.data.trajectories, "
            "interpolated_diffusion_tpu_torch.train.batches, "
            "interpolated_diffusion_tpu_torch.train.common, "
            "interpolated_diffusion_tpu_torch.train.train_keypoints, "
            "interpolated_diffusion_tpu_torch.train.train_interp_levels, "
            "interpolated_diffusion_tpu_torch.train.train_segment_cost, "
            "interpolated_diffusion_tpu_torch.train.train_keypoint_selector, "
            "interpolated_diffusion_tpu_torch.data.native, "
            "interpolated_diffusion_tpu_torch.data.prepare_dp_keypoints, "
            "interpolated_diffusion_tpu_torch.ops.selection, "
            "interpolated_diffusion_tpu_torch.ops.oracle_segment_cost, "
            "interpolated_diffusion_tpu_torch.models.selector, "
            "interpolated_diffusion_tpu_torch.sample.generate, "
            "interpolated_diffusion_tpu_torch.serve.service, "
            "interpolated_diffusion_tpu_torch.serve.server, "
            "interpolated_diffusion_tpu_torch.serve.client, "
            "interpolated_diffusion_tpu_torch.eval.visualize, "
            "interpolated_diffusion_tpu_torch.utils.jax_checkpoint, "
            "interpolated_diffusion_tpu_torch.sample.generate_causal, "
            "interpolated_diffusion_tpu_torch.sample.sample_causal, "
            "interpolated_diffusion_tpu_torch.sample.sample_fullseq, "
            "interpolated_diffusion_tpu_torch.sample.sample_keypoints, "
            "interpolated_diffusion_tpu_torch.train.train_interp_levels_causal, "
            "interpolated_diffusion_tpu_torch.train.train_causal, "
            "interpolated_diffusion_tpu_torch.train.train_fullseq, "
            "interpolated_diffusion_tpu_torch.train.train_interp_levels_wansynth, "
            "interpolated_diffusion_tpu_torch.data.make_synth_tars, "
            "interpolated_diffusion_tpu_torch.data.precompute_phase1_anchors, "
            "interpolated_diffusion_tpu_torch.diagnostics.eval_wansynth_stage2, "
            "interpolated_diffusion_tpu_torch.models.lora, "
            "interpolated_diffusion_tpu_torch.models.wan_convert, "
            "interpolated_diffusion_tpu_torch.models.video_denoisers, "
            "interpolated_diffusion_tpu_torch.utils.safetensors, "
            "interpolated_diffusion_tpu_torch.ops.image, "
            "interpolated_diffusion_tpu_torch.models.flow_interpolator, "
            "interpolated_diffusion_tpu_torch.models.straightener, "
            "interpolated_diffusion_tpu_torch.models.sinkhorn_warp, "
            "interpolated_diffusion_tpu_torch.models.video_selector, "
            "interpolated_diffusion_tpu_torch.train.interp_common, "
            "interpolated_diffusion_tpu_torch.train.train_flow_interpolator_wansynth, "
            "interpolated_diffusion_tpu_torch.train.train_latent_straightener_wansynth, "
            "interpolated_diffusion_tpu_torch.train.train_sinkhorn_interp_wansynth, "
            "interpolated_diffusion_tpu_torch.train.train_segment_cost_wansynth, "
            "interpolated_diffusion_tpu_torch.train.train_video_selector_wansynth, "
            "interpolated_diffusion_tpu_torch.teachers.teacher, "
            "interpolated_diffusion_tpu_torch.data.precompute_teacher, "
            "interpolated_diffusion_tpu_torch.diagnostics.eval_interpolators, "
            "interpolated_diffusion_tpu_torch.data.toy_video, "
            "interpolated_diffusion_tpu_torch.data.didemo, "
            "interpolated_diffusion_tpu_torch.data.precompute_clip_cache, "
            "interpolated_diffusion_tpu_torch.models.interpolators, "
            "interpolated_diffusion_tpu_torch.models.sd_vae, "
            "interpolated_diffusion_tpu_torch.models.frame_vae, "
            "interpolated_diffusion_tpu_torch.models.clip_text, "
            "interpolated_diffusion_tpu_torch.train.train_keypoints_toy_video, "
            "interpolated_diffusion_tpu_torch.train.train_interp_levels_toy_video, "
            "interpolated_diffusion_tpu_torch.train.train_video_interpolator, "
            "interpolated_diffusion_tpu_torch.train.train_video_interpolator_wansynth, "
            "interpolated_diffusion_tpu_torch.train.train_keypoints_didemo, "
            "interpolated_diffusion_tpu_torch.utils.seed, "
            "interpolated_diffusion_tpu_torch.utils.logging, "
            "interpolated_diffusion_tpu_torch.utils.profiling, "
            "interpolated_diffusion_tpu_torch.kernels.tuning, "
            "interpolated_diffusion_tpu_torch.data.d4rl, "
            "interpolated_diffusion_tpu_torch.data.maze2d_synth, "
            "interpolated_diffusion_tpu_torch.data.mujoco_walls, "
            "interpolated_diffusion_tpu_torch.data.d4rl_live, "
            "interpolated_diffusion_tpu_torch.data.native_tar, "
            "interpolated_diffusion_tpu_torch.diagnostics.eval_wan_sla_gap, "
            "interpolated_diffusion_tpu_torch.diagnostics.eval_wan_fullseq_eps, "
            "interpolated_diffusion_tpu_torch.diagnostics.diagnose_stage2_masks, "
            "interpolated_diffusion_tpu_torch.diagnostics.diagnose_stage2_model_error, "
            "interpolated_diffusion_tpu_torch.diagnostics.diagnose_oracle_dp, "
            "interpolated_diffusion_tpu_torch.diagnostics.diagnose_selector, "
            "interpolated_diffusion_tpu_torch.diagnostics.diagnose_selector_per_maze, "
            "interpolated_diffusion_tpu_torch.diagnostics.diagnose_latent_straightness, "
            "interpolated_diffusion_tpu_torch.diagnostics.diagnose_sinkhorn_outliers, "
            "interpolated_diffusion_tpu_torch.parallel.multihost, "
            "interpolated_diffusion_tpu_torch.parallel.mesh, "
            "interpolated_diffusion_tpu_torch.parallel.collectives, "
            "interpolated_diffusion_tpu_torch.parallel.ring, "
            "interpolated_diffusion_tpu_torch.parallel.ring_sla, "
            "interpolated_diffusion_tpu_torch.parallel.ep, "
            "interpolated_diffusion_tpu_torch.parallel.tp, "
            "interpolated_diffusion_tpu_torch.parallel.pp, "
            "interpolated_diffusion_tpu_torch.models.moe, "
            "interpolated_diffusion_tpu_torch.models.wan_pp, "
            "interpolated_diffusion_tpu_torch.utils.checkpoint_sharded, "
            "interpolated_diffusion_tpu_torch.train.train_interp_levels_didemo, "
            "interpolated_diffusion_tpu_torch.sample.sample_toy_video; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'msgpack') "
            "or m.startswith(('jax.', 'flax.', 'optax.', 'msgpack.')) "
            "or m == 'interpolated_diffusion_tpu' or m.startswith('interpolated_diffusion_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
