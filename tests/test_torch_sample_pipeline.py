"""The port's make_pipeline under each sampling knob against the JAX
make_pipeline, end to end on the CPU in f32.

Small models (d 32, 2 layers, 4 heads), T=32, K=8, 2 levels, 5 DDIM steps,
a nonzero Stage-2 head, and the draws JAX made injected into the port:
z_init = normal(k1, (B, K, D)) (under best-of, normal(keys[n], ...) over
keys = split(k1, N)), mask_rand = uniform(k2, (B, T)) and the Stage-2 noise
normal(split(fold_in(k2, 7), levels + 1)[s], (B, T, 2)), with k1, k2 =
split(key). Each case sets the knob its id names, plus what the knob needs
to act (a soft clamp needs the anchor-confidence channel, a noise sigma needs
a noise mode). Tolerance: atol 1e-4 / rtol 1e-3 in f32, as
tests/test_torch_port_pipeline.py's: the DDIM steps and the levels feed each
model output back in.
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

KW = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64, d_cond=16, data_dim=2,
          maze_channels=(8, 8))
B, T_, K, LEVELS, G = 4, 32, 8, 2, 9
CFG = dict(T=T_, K=K, levels=LEVELS, K_min=K, ddim_steps=5, pos_clip=True)
CONF = dict(anchor_conf=True)
SOFT = dict(anchor_conf=True, soft_anchor_clamp=True)


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
    sg = r.uniform(0.05, 0.95, size=(B, 4)).astype(np.float32)
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

    interp = {}

    def stage2(ch):
        if ch not in interp:
            it = jden.InterpLevelDenoiser(**KW, mask_channels=ch)
            it_p = jax.tree.map(np.asarray, it.init(
                jax.random.PRNGKey(2), jnp.zeros((1, T_, 2)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, T_, ch)), cond1)["params"])
            rr = np.random.default_rng(ch)
            it_p["out"]["kernel"] = (rr.normal(size=it_p["out"]["kernel"].shape)
                                     * 0.05).astype(np.float32)
            it_p["out"]["bias"] = (rr.normal(size=it_p["out"]["bias"].shape)
                                   * 0.01).astype(np.float32)
            interp[ch] = (it, it_p, port(denoisers.InterpLevelDenoiser, it_p, "interp",
                                         mask_channels=ch))
        return interp[ch]

    return dict(idx=idx, occ=occ, sg=sg, cond=cond, kp=kp, kp_p=kp_p,
                kp_t=port(denoisers.KeypointDenoiser, kp_p, "keypoint"), stage2=stage2)


def _jax_draws(key, cfg):
    k1, k2 = jax.random.split(key)
    if cfg.get("stage1_best_of", 1) > 1 and not cfg.get("collect_steps"):
        keys = jax.random.split(k1, cfg["stage1_best_of"])
        z = np.stack([np.asarray(jax.random.normal(k, (B, K, 2))) for k in keys])
    else:
        z = np.asarray(jax.random.normal(k1, (B, K, 2)))
    noise_keys = jax.random.split(jax.random.fold_in(k2, 7), LEVELS + 1)
    return {"z_init": torch.tensor(z),
            "mask_rand": torch.tensor(np.asarray(jax.random.uniform(k2, (B, T_)))),
            "s2_noise": torch.tensor(np.stack([np.asarray(jax.random.normal(k, (B, T_, 2)))
                                               for k in noise_keys]))}


def run_both(s, extra, z_override=None, selector_logits=None, seed=3):
    cfg = dict(CFG, **extra)
    mode = cfg.get("stage2_mode", "adj")
    ch = (2 if mode == "adj" else 1) + (1 if cfg.get("anchor_conf") else 0)
    it, it_p, it_t = s["stage2"](ch)
    jpipe = jax.jit(jgen.make_pipeline(s["kp"], it, jmake_schedule("linear", 100),
                                       jgen.PipelineConfig(**cfg), 2))
    key = jax.random.PRNGKey(seed)
    ref = jpipe(s["kp_p"], it_p, key, jnp.asarray(s["idx"], jnp.int32), s["cond"],
                None if z_override is None else jnp.asarray(z_override),
                None if selector_logits is None else jnp.asarray(selector_logits))
    pipe = generate.make_pipeline(s["kp_t"], it_t, make_schedule("linear", 100),
                                  generate.PipelineConfig(**cfg), 2)
    out = pipe(torch.tensor(s["idx"]), {"occ": torch.tensor(s["occ"]),
                                        "start_goal": torch.tensor(s["sg"])},
               z_override=None if z_override is None else torch.tensor(z_override),
               selector_logits=None if selector_logits is None else torch.tensor(selector_logits),
               **_jax_draws(key, cfg))
    return out, ref


def check(out, ref):
    flat = lambda o: [*o[:3], *(o[3] if len(o) > 3 else ())]
    got, want = flat(out), flat(ref)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-3, err_msg=str(i))


KNOBS = [
    ("anchor_conf", True, {}), ("soft_anchor_clamp", True, CONF),
    ("s2_noise_mode", "level", dict(s2_noise_sigma=0.05)), ("logit_space", True, {}),
    ("collect_steps", True, {}), ("stage1_cache_interval", 2, {}),
    ("stage1_solver", "pfdiff", {}), ("stage1_objective", "rf", {}),
    ("stage1_best_of", 4, {}), ("s2_delta_smooth", 2, {}),
    ("anchor_conf_anneal_mode", "linear", CONF), ("anchor_conf_teacher", 0.5, SOFT),
    ("anchor_conf_endpoints", 0.9, CONF), ("anchor_conf_missing", 0.1, SOFT),
    ("soft_clamp_schedule", "cosine", SOFT), ("soft_clamp_max", 0.25, SOFT),
    ("s2_noise_sigma", 0.1, dict(s2_noise_mode="constant")),
    ("s2_noise_scale", 0.5, dict(s2_noise_mode="constant", s2_noise_sigma=0.1)),
    ("s2_sigma_min", 0.04, dict(s2_noise_mode="level", s2_noise_sigma=0.05)),
    ("s2_sigma_pow", 2.0, dict(s2_noise_mode="level", s2_noise_sigma=0.05)),
    ("logit_eps", 1e-4, dict(logit_space=True)),
    ("stage1_best_of_mode", "dp", dict(stage1_best_of=4)),
]


@pytest.mark.parametrize("knob,value,extra", KNOBS, ids=[f"{k}-{v}" for k, v, _ in KNOBS])
def test_pipeline_knob_matches_jax(setup, knob, value, extra):
    cfg = dict(extra, **{knob: value})
    out, ref = run_both(setup, cfg)
    check(out, ref)
    if not cfg.get("logit_space"):   # (pos_clip clips logits there, in JAX as here)
        assert torch.equal(out[1][:, 0, :2], torch.tensor(setup["sg"][:, :2]))


@pytest.mark.parametrize("extra", [
    dict(stage1_solver="dpm"),
    dict(stage1_solver="pfdiff", collect_steps=True, x0_clip=1.0),
    dict(stage1_objective="rf", collect_steps=True, logit_space=True),
    dict(stage1_cache_interval=3, collect_steps=True),
    dict(stage2_mode="x0", clamp_policy="all_anchors", **SOFT, anchor_conf_anneal_mode="cosine"),
    dict(stage1_best_of=3, stage1_best_of_mode="dp", logit_space=True, s2_noise_mode="level",
         s2_noise_sigma=0.05, s2_delta_smooth=1, **SOFT),
    dict(stage1_best_of=3, recompute_vel=True, clamp_dims="all", clamp_policy="none"),
], ids=["dpm", "pfdiff-collect", "rf-collect-logit", "fora3-collect", "x0-conf-soft",
        "best_of-dp-all-knobs", "best_of-set-other-clamps"])
def test_pipeline_knob_combinations_match_jax(setup, extra):
    check(*run_both(setup, extra))


def test_pipeline_z_override_and_selector_logits_match_jax(setup):
    r = np.random.default_rng(4)
    z = r.uniform(size=(B, K, 2)).astype(np.float32)
    logits = r.normal(size=(B, T_)).astype(np.float32)
    check(*run_both(setup, {}, z_override=z))
    check(*run_both(setup, dict(stage2_mask_policy="selector"), selector_logits=logits))
    out, _ = run_both(setup, dict(collect_steps=True), z_override=z)
    assert torch.equal(out[2], torch.tensor(z)) and out[3][0].shape == (1, B, K, 2)


def test_best_of_runs_the_candidates_as_one_batch(setup):
    """Best-of-N folds N into the batch: every Stage-1 evaluation sees N * B rows."""
    s = setup
    rows = []
    kp = s["kp_t"]
    handle = kp.transformer.register_forward_hook(lambda m, a, o: rows.append(a[0].shape[0]))
    try:
        cfg = generate.PipelineConfig(**CFG, stage1_best_of=4, stage1_best_of_mode="dp")
        pipe = generate.make_pipeline(kp, s["stage2"](2)[2], make_schedule("linear", 100), cfg, 2)
        draws = generate.make_draws(cfg, B, 2, torch.Generator().manual_seed(0))
        assert draws["z_init"].shape == (4, B, K, 2) and "s2_noise" not in draws
        pipe(torch.tensor(s["idx"]), {"occ": torch.tensor(s["occ"]),
                                      "start_goal": torch.tensor(s["sg"])}, **draws)
    finally:
        handle.remove()
    assert rows == [4 * B] * 4      # 5 DDIM timesteps: 4 evaluations


def test_fora_cached_steps_skip_the_block_stack(setup):
    s = setup
    calls = []
    handle = s["kp_t"].transformer.register_forward_hook(lambda m, a, o: calls.append(1))
    try:
        cfg = generate.PipelineConfig(**dict(CFG, ddim_steps=20), stage1_cache_interval=2)
        pipe = generate.make_pipeline(s["kp_t"], s["stage2"](2)[2],
                                      make_schedule("linear", 100), cfg, 2)
        pipe(torch.tensor(s["idx"]), {"occ": torch.tensor(s["occ"]),
                                      "start_goal": torch.tensor(s["sg"])},
             generator=torch.Generator().manual_seed(0))
    finally:
        handle.remove()
    assert len(calls) == 10         # 19 transitions, the stack at the even ones
