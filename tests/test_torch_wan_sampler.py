"""The port's Phase-1 anchor sampler (sample/wan_anchors.make_anchor_sampler)
against the same composition built from JAX pieces, as
data/precompute_phase1_anchors.py builds it: WanDiT.apply,
FrameCondProjector, frame_features_from_mask, patchify / unpatchify and
ops.ddpm.run_solver, with the same injected noise and anchor indices.

Tiny model as tests/test_torch_wan_model.py (dim 48, 2 layers, LoRA rank 2,
non-zero zero-init leaves), T = 9, K = 3, latents 4 x 16 x 16 with outer
patch 2 (tokens [2, 3, 64, 16], L = 192 in WanDiT), linear schedule
N_train = 1000, DDIM on make_timesteps(1000, 4, "quadratic") = [999, 444,
111, 0]: 3 model evaluations. f32. Tolerance, as max|port - jax| / max|jax|:
1e-4 with dense attention; 2^-8 under sla, whose sparse branch is bf16 in
both packages (see tests/test_torch_wan_model.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models.wan_dit import FrameCondProjector as JFrameCond
from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
from interpolated_diffusion_tpu.ops.ddpm import make_timesteps as j_make_timesteps
from interpolated_diffusion_tpu.ops.ddpm import run_solver as j_run_solver
from interpolated_diffusion_tpu.ops.schedules import make_schedule as j_make_schedule
from interpolated_diffusion_tpu.utils.frame_features import frame_features_from_mask as j_ff
from interpolated_diffusion_tpu.utils.video_tokens import patchify_latents as j_patchify
from interpolated_diffusion_tpu.utils.video_tokens import unpatchify_tokens as j_unpatchify
from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
from interpolated_diffusion_tpu_torch.models.wan_dit import FrameCondProjector, WanDiT
from interpolated_diffusion_tpu_torch.sample.wan_anchors import AnchorConfig, make_anchor_sampler
from test_torch_wan_model import BF16_TOL, REL_TOL, TINY, _nonzero_leaves, rel_err

CFG = AnchorConfig(T=9, K=3, latent_c=4, latent_h=16, latent_w=16, patch_size=2,
                   n_train=1000, schedule="linear", ddim_steps=4)


def _jax_sampler(wan, params, fc, fc_params, cfg):
    spatial = cfg.spatial
    schedule = j_make_schedule(cfg.schedule, cfg.n_train)
    times = jnp.asarray(j_make_timesteps(cfg.n_train, cfg.ddim_steps, "quadratic"))

    def sample(z, idx, text):
        B = idx.shape[0]

        def eps_fn(z_t, t):
            mask = jnp.zeros((B, cfg.T), dtype=bool).at[jnp.arange(B)[:, None], idx].set(True)
            feat = jnp.take_along_axis(j_ff(mask), idx[..., None], axis=1)
            extra = fc.apply({"params": fc_params}, feat)
            lat_in = jnp.transpose(j_unpatchify(z_t, cfg.patch_size, spatial), (0, 2, 1, 3, 4))
            pred = wan.apply({"params": params}, lat_in, t, text, idx, extra)
            return j_patchify(jnp.transpose(pred, (0, 2, 1, 3, 4)), cfg.patch_size)[0]

        z, _ = j_run_solver("ddim", lambda z, t: eps_fn(z.astype(jnp.float32), t), z, times,
                            schedule)
        return j_unpatchify(z, cfg.patch_size, spatial)

    return sample


@pytest.mark.parametrize("attn_mode,tol", [("dense", REL_TOL), ("sla", BF16_TOL)])
def test_sample_anchors_matches_jax(attn_mode, tol):
    r = np.random.default_rng(5)
    B, (hp, wp) = 2, CFG.spatial
    z = r.normal(size=(B, CFG.K, hp * wp, CFG.latent_c * CFG.patch_size ** 2)).astype(np.float32)
    idx = np.array([[0, 4, 8], [1, 2, 6]], np.int32)
    text = r.normal(size=(B, 5, TINY["text_dim"])).astype(np.float32)

    wan = JWanDiT(attn_mode=attn_mode, dtype=jnp.float32, **TINY)
    fc = JFrameCond(feat_dim=5, text_dim=TINY["text_dim"])
    lat0 = jnp.zeros((1, CFG.latent_c, CFG.K, CFG.latent_h, CFG.latent_w))
    params = wan.init(jax.random.PRNGKey(0), lat0, jnp.zeros((1,), jnp.int32),
                      jnp.zeros((1, 5, TINY["text_dim"])), jnp.zeros((1, CFG.K), jnp.int32),
                      jnp.zeros((1, CFG.K, TINY["text_dim"])))["params"]
    params = _nonzero_leaves(params, r)
    fc_params = _nonzero_leaves(
        fc.init(jax.random.PRNGKey(1), jnp.zeros((1, CFG.K, 5)))["params"], r)
    ref = _jax_sampler(wan, params, fc, fc_params, CFG)(
        jnp.asarray(z), jnp.asarray(idx), jnp.asarray(text))

    sd, fc_sd = wan_params_to_state_dict(params, frame_cond=fc_params)
    model = WanDiT(attn_mode=attn_mode, extra_context=True, **TINY).eval()
    model.load_state_dict(sd, strict=True)
    proj = FrameCondProjector(feat_dim=5, text_dim=TINY["text_dim"]).eval()
    proj.load_state_dict(fc_sd, strict=True)
    out = make_anchor_sampler(CFG, model, proj)(torch.tensor(z), torch.tensor(idx),
                                                torch.tensor(text))
    assert out.shape == (B, CFG.K, CFG.latent_c, CFG.latent_h, CFG.latent_w)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert rel_err(out, ref) <= tol, rel_err(out, ref)
