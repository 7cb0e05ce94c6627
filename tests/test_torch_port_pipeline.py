"""The port's make_pipeline against the JAX make_pipeline, end to end.

Small models (d 64, 2 layers, 8 heads — so Stage-2 H*L = 512 > 256 and the
"fused" policy really reaches small_mha_packed), T=64, K=8, 3 levels, 5 DDIM
steps, a nonzero Stage-2 head, and the random draws JAX made injected into
the port. Tolerance: atol 1e-4 / rtol 1e-3 in f32 — looser than one module's
2e-5 because four DDIM steps and three Stage-2 levels feed each model output
back in, and the x0-from-eps divide (by sqrt(alpha_bar) ~ 0.6 at t=99)
amplifies the per-module rounding differences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.ops.schedules import make_schedule as jmake_schedule
from interpolated_diffusion_tpu.sample import generate as jgen
from interpolated_diffusion_tpu_torch.models import denoisers
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.sample import generate

KW = dict(d_model=64, n_layers=2, n_heads=8, d_ff=128, d_cond=32, data_dim=2,
          maze_channels=(8, 16))
B, T_, K, LEVELS, G = 4, 64, 8, 3, 11
CFG = dict(T=T_, K=K, levels=LEVELS, K_min=K, ddim_steps=5, pos_clip=True)


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


@pytest.fixture(scope="module")
def setup():
    r = np.random.default_rng(0)
    inner = np.stack([np.sort(r.choice(np.arange(1, T_ - 1), K - 2, replace=False))
                      for _ in range(B)])
    idx = np.concatenate([np.zeros((B, 1), int), inner, np.full((B, 1), T_ - 1)], 1)
    occ = (r.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32)
    sg = r.uniform(size=(B, 4)).astype(np.float32)
    cond = {"occ": jnp.asarray(occ), "start_goal": jnp.asarray(sg)}
    cond1 = {k: v[:1] for k, v in cond.items()}
    kp = jden.KeypointDenoiser(**KW)
    kp_p = jax.tree.map(np.asarray, kp.init(
        jax.random.PRNGKey(1), jnp.zeros((1, K, 2)), jnp.zeros((1,), jnp.int32),
        jnp.asarray(idx[:1], jnp.int32), jnp.zeros((1, K, 2), bool), cond1, T_)["params"])

    def port(cls, p, kind, **kw):
        m = build_model(cls, generator=torch.Generator().manual_seed(0), **KW, **kw)
        m.load_state_dict(params_to_state_dict(p, kind), strict=True)
        return m.eval()

    out = dict(idx=idx, occ=occ, sg=sg, cond=cond, kp=kp, kp_p=kp_p,
               kp_t=port(denoisers.KeypointDenoiser, kp_p, "keypoint"))
    # Stage 2 takes [mask_s, mask_{s-1}] in adj mode and mask_s in x0 mode
    for mode, ch in (("adj", 2), ("x0", 1)):
        it = jden.InterpLevelDenoiser(**KW, mask_channels=ch)
        it_p = jax.tree.map(np.asarray, it.init(
            jax.random.PRNGKey(2), jnp.zeros((1, T_, 2)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, T_, ch)), cond1)["params"])
        it_p["out"]["kernel"] = (r.normal(size=it_p["out"]["kernel"].shape) * 0.05).astype(np.float32)
        it_p["out"]["bias"] = (r.normal(size=it_p["out"]["bias"].shape) * 0.01).astype(np.float32)
        out[mode] = (it, it_p, port(denoisers.InterpLevelDenoiser, it_p, "interp",
                                    mask_channels=ch))
    return out


@pytest.mark.parametrize("policy,mode,clamp", [("block", "adj", "endpoints"),
                                               ("fused", "adj", "endpoints"),
                                               ("fused", "x0", "all_anchors")])
def test_pipeline_matches_jax(setup, policy, mode, clamp, monkeypatch):
    s = setup
    monkeypatch.setenv("ID_TPU_SMALL_ATTN", policy)
    jcfg = jgen.PipelineConfig(**CFG, stage2_mode=mode, clamp_policy=clamp)
    it, it_p, it_t = s[mode]
    jpipe = jax.jit(jgen.make_pipeline(s["kp"], it, jmake_schedule("linear", 100), jcfg, 2))
    key = jax.random.PRNGKey(3)
    ref = jpipe(s["kp_p"], it_p, key, jnp.asarray(s["idx"], jnp.int32), s["cond"])
    # the draws the JAX pipeline made (generate.py: k1, k2 = split(key))
    k1, k2 = jax.random.split(key)
    z_init = np.asarray(jax.random.normal(k1, (B, K, 2)))
    mask_rand = np.asarray(jax.random.uniform(k2, (B, T_)))

    s["kp_t"].set_attn_policy(policy)
    it_t.set_attn_policy(policy)
    cfg = generate.PipelineConfig(**CFG, stage2_mode=mode, clamp_policy=clamp)
    pipe = generate.make_pipeline(s["kp_t"], it_t, make_schedule("linear", 100), cfg, 2)
    out = pipe(torch.tensor(s["idx"]), {"occ": torch.tensor(s["occ"]),
                                        "start_goal": torch.tensor(s["sg"])},
               z_init=torch.tensor(z_init), mask_rand=torch.tensor(mask_rand))
    for name, a, b in zip(("x_interp", "x_refined", "z_pred"), out, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    x_interp, x_ref, z_pred = out
    # Stage 2 really refined, and the invariants hold
    assert not torch.allclose(x_ref, x_interp)
    assert torch.equal(x_ref[:, 0, :2], torch.tensor(s["sg"][:, :2]))
    assert ((x_ref[..., :2] >= 0) & (x_ref[..., :2] <= 1)).all()


def test_pipeline_generator_draws_are_reproducible(setup):
    s = setup
    cfg = generate.PipelineConfig(**CFG)
    pipe = generate.make_pipeline(s["kp_t"], s["adj"][2], make_schedule("linear", 100), cfg, 2)
    idx = torch.tensor(s["idx"])
    cond = {"occ": torch.tensor(s["occ"]), "start_goal": torch.tensor(s["sg"])}
    a = pipe(idx, cond, generator=torch.Generator().manual_seed(0))
    b = pipe(idx, cond, generator=torch.Generator().manual_seed(0))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        pipe(idx, cond)


def test_pipeline_config_has_the_jax_fields_and_defaults():
    """Every keyword of the JAX PipelineConfig exists in the port's with the
    same default (a caller's config then builds in both packages), and the
    port adds none of its own."""
    import dataclasses
    import inspect

    params = inspect.signature(jgen.PipelineConfig.__init__).parameters
    jax_fields = {n: p.default for n, p in params.items() if n != "self"}
    port_fields = {f.name: f.default for f in dataclasses.fields(generate.PipelineConfig)}
    assert set(port_fields) == set(jax_fields)
    for name, default in jax_fields.items():
        want = dataclasses.MISSING if default is inspect.Parameter.empty else default
        assert port_fields[name] == want and type(port_fields[name]) is type(want), name
    # every field is ported, kp_feat_dim included
    generate.check_supported(generate.PipelineConfig(**CFG))
    generate.check_supported(generate.PipelineConfig(**CFG, kp_feat_dim=3))
