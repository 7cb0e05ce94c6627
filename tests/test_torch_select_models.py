"""The port's selection models (models/selector.py), their loaders
(models/loading.py) and the sampler's selection knobs against the JAX
package, on the CPU.

D_phi and the keypoint selector are built from a seed in the port; the JAX
package's own converters (models/torch_import.convert_segment_cost /
convert_keypoint_selector, which read the reference's torch state_dict
names) carry the same weights into JAX params. Both are also held to the
recorded reference models `dphi/` and `sel/` of
tests/golden/reference_models.npz. Tolerance: atol 3e-5 / rtol 1e-4 in f32
(tests/test_torch_import.py's for the same models). The pipeline cases use
tests/test_torch_port_pipeline.py's: atol 1e-4 / rtol 1e-3 in f32.
"""
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models import denoisers as jden
from interpolated_diffusion_tpu.models import selector as jselm
from interpolated_diffusion_tpu.models.torch_import import (convert_keypoint_selector,
                                                            convert_segment_cost)
from interpolated_diffusion_tpu.ops import selection as jsel
from interpolated_diffusion_tpu.ops.schedules import make_schedule as jmake_schedule
from interpolated_diffusion_tpu.sample import generate as jgen
from interpolated_diffusion_tpu_torch.models import denoisers, loading
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.models.selector import KeypointSelector, SegmentCostPredictor
from interpolated_diffusion_tpu_torch.ops import selection as psel
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.sample import generate
from interpolated_diffusion_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "tests", "golden", "reference_models.npz")
B, G = 3, 9


def _cond(seed=0, sdf=False, level=False):
    r = np.random.default_rng(seed)
    cond = {"occ": (r.uniform(size=(B, 1, G, G)) < 0.25).astype(np.float32),
            "start_goal": r.uniform(size=(B, 4)).astype(np.float32)}
    if sdf:
        cond["sdf"] = r.normal(size=(B, 1, G, G)).astype(np.float32)
    if level:
        cond["level"] = r.uniform(size=(B, 1)).astype(np.float32)
    return cond


def _port(cls, seed, **kw):
    m = build_model(cls, generator=torch.Generator().manual_seed(seed), **kw)
    return m.eval()


def _jax_params(model, convert, **kw):
    return jax.tree.map(jnp.asarray, convert(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, **kw))


t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("use_sdf,use_sg", [(False, True), (True, False)])
def test_segment_cost_predictor_matches_jax(use_sdf, use_sg):
    kw = dict(d_cond=16, seg_feat_dim=3, hidden_dim=24, n_layers=3, use_sdf=use_sdf,
              use_start_goal=use_sg, maze_channels=(4, 8))
    model = _port(SegmentCostPredictor, 1, **kw)
    jm = jselm.SegmentCostPredictor(**kw)
    params = _jax_params(model, convert_segment_cost)
    cond = _cond(1, sdf=use_sdf)
    idx = np.array([[0, 3, 9, 15], [0, 1, 2, 15], [0, 7, 8, 15]])
    for seg in (np.asarray(jsel.build_segment_features(16, *map(jnp.asarray, np.triu_indices(16, 1)))),
                np.asarray(jsel.build_segment_features_from_idx(jnp.asarray(idx), 16))):
        want = jm.apply({"params": params}, j(cond), jnp.asarray(seg))
        got = model(t(cond), torch.as_tensor(np.array(seg)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


SEL_CASES = {
    "default": dict(),
    "sigma0_sdf_level": dict(sg_map_sigma=0.0, use_sdf=True, use_level=True),
    "gd_bias_memory": dict(use_goal_dist_token=True, use_cond_bias=True, use_sg_token=False),
    "bias_encoder_no_map": dict(use_cond_bias=True, cond_bias_mode="encoder", use_sg_map=False,
                                maze_channels=(4, 16)),
}


@pytest.mark.parametrize("case", list(SEL_CASES))
def test_keypoint_selector_matches_jax(case):
    """The selector's options: gaussian and rounded start/goal maps, SDF,
    level conditioning, the goal-distance token, the condition bias from the
    memory or from its own encoder, no sg token, no spatial projection
    (last maze channel = d_model)."""
    kw = dict(T=12, d_model=16, n_heads=2, d_ff=32, n_layers=2, pos_dim=8,
              maze_channels=(4, 8))
    kw.update(SEL_CASES[case])
    model = _port(KeypointSelector, 2, **kw)
    jm = jselm.KeypointSelector(**kw)
    params = _jax_params(model, convert_keypoint_selector, n_heads=2)
    cond = _cond(2, sdf=kw.get("use_sdf", False), level=kw.get("use_level", False))
    if case == "sigma0_sdf_level":
        cond["start_goal"][0] = [0.0, 1.0, 0.5, 0.25]   # cells on the rounding edges
    want = jm.apply({"params": params}, j(cond))
    got = model(t(cond))
    assert got.shape == (B, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


def test_models_match_the_reference_goldens():
    g = np.load(MODELS)
    sd = lambda p: {k[len(p) + 4:]: torch.as_tensor(g[k]) for k in g.files
                    if k.startswith(p + "/sd/")}
    cond = {"occ": torch.as_tensor(g["kp/in/occ"]),
            "start_goal": torch.as_tensor(g["kp/in/start_goal"])}
    sel = KeypointSelector(T=24, d_model=32, n_heads=4, d_ff=64, n_layers=2, pos_dim=16,
                           use_goal_dist_token=True, use_cond_bias=True, use_level=True,
                           maze_channels=(8, 16))
    sel.load_state_dict(sd("sel"), strict=True)
    out = sel(dict(cond, level=torch.as_tensor(g["sel/in/level"])))
    np.testing.assert_allclose(out.detach().numpy(), g["sel/out"], atol=3e-5, rtol=1e-4)
    dphi = SegmentCostPredictor(d_cond=32, hidden_dim=48, n_layers=3, maze_channels=(8, 16))
    dphi.load_state_dict(sd("dphi"), strict=True)
    out = dphi(cond, torch.as_tensor(g["dphi/in/seg_feat"]))
    np.testing.assert_allclose(out.detach().numpy(), g["dphi/out"], atol=3e-5, rtol=1e-4)


def test_bf16_compute_stays_near_f32():
    """Under set_compute_dtype(bfloat16) both models compute in bf16 over f32
    masters: within bf16 rounding of the f32 outputs (2^-8 of the scale,
    times the few layers between)."""
    from interpolated_diffusion_tpu_torch.models.transformer import set_compute_dtype

    cond = t(_cond(3))
    for model, args in ((_port(KeypointSelector, 3, T=12, d_model=16, n_heads=2, d_ff=32,
                                n_layers=2, pos_dim=8, maze_channels=(4, 8)), (cond,)),
                        (_port(SegmentCostPredictor, 3, d_cond=16, hidden_dim=24,
                               maze_channels=(4, 8)), (cond, torch.rand(7, 3)))):
        with torch.no_grad():
            ref = model(*args)
            set_compute_dtype(model, torch.bfloat16)
            got = model(*args)
        assert got.dtype == torch.float32 and model.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert float((got - ref).abs().max()) <= 5e-2 * float(ref.abs().max()) + 1e-3


SEL_META = dict(stage="selector", T=12, d_model=16, n_heads=2, d_ff=32, n_layers=2, pos_dim=8,
                use_sdf=0, cond_start_goal=1, use_sg_map=1, use_sg_token=1,
                use_goal_dist_token=0, use_cond_bias=0, cond_bias_mode="memory", use_level=1,
                level_mode="k_norm", sg_map_sigma=1.5, maze_channels="4,8", maze_h=G, maze_w=G)
DPHI_META = dict(stage="segment_cost", T=12, d_cond=16, seg_feat_dim=3, hidden_dim=24,
                 n_layers=3, use_sdf=0, cond_start_goal=1, maze_channels="4,8",
                 normalize_targets=1, target_mean=0.5, target_std=2.0, maze_h=G, maze_w=G)


def test_selection_loaders_rebuild_the_models_from_meta(tmp_path):
    sel = _port(KeypointSelector, 4, T=12, d_model=16, n_heads=2, d_ff=32, n_layers=2, pos_dim=8,
                use_level=True, maze_channels=(4, 8))
    dphi = _port(SegmentCostPredictor, 4, d_cond=16, hidden_dim=24, maze_channels=(4, 8))
    save_checkpoint(str(tmp_path / "sel" / "ckpt_3"), dict(sel.named_parameters()), None, 3,
                    None, SEL_META)
    save_checkpoint(str(tmp_path / "dphi" / "ckpt_3"), dict(dphi.named_parameters()), None, 3,
                    None, DPHI_META)
    cond = t(_cond(4, level=True))
    sel2, meta = loading.load_selector_model(str(tmp_path / "sel"), bf16=False, device="cpu")
    assert meta["stage"] == "selector" and not sel2.training
    assert torch.equal(sel2(cond), sel(cond))
    fn, _ = loading.make_dphi_seg_cost_fn(str(tmp_path / "dphi"), 12, use_sdf=False, bf16=False,
                                          device="cpu")
    idx = torch.tensor([[0, 4, 11], [0, 1, 11], [0, 10, 11]])
    want = dphi(cond, psel.build_segment_features_from_idx(idx, 12))
    assert torch.equal(fn(cond, idx), want) and fn(cond, idx).shape == (B, 2)
    with pytest.raises(ValueError, match="T mismatch"):
        loading.make_dphi_seg_cost_fn(str(tmp_path / "dphi"), 16, device="cpu")
    with pytest.raises(ValueError, match="use_sdf mismatch"):
        loading.make_dphi_seg_cost_fn(str(tmp_path / "dphi"), 12, use_sdf=True, device="cpu")
    with pytest.raises(ValueError, match="selector"):
        loading.load_selector_model(str(tmp_path / "dphi"), device="cpu")
    with pytest.raises(ValueError, match="segment_cost"):
        loading.load_segment_cost_model(str(tmp_path / "sel"), device="cpu")
    for fn_ in (loading.load_selector_model, loading.load_segment_cost_model,
                loading.make_dphi_seg_cost_fn):
        assert inspect.signature(fn_).parameters["device"].default == "cuda"


def test_stage1_loader_rebuilds_kp_feat_models(tmp_path):
    """A Stage-1 checkpoint trained with --use_kp_feat loads with its
    kp_feat_dim (the input projection's width), as in JAX."""
    kw = dict(d_model=16, n_layers=1, n_heads=2, d_ff=32, d_cond=8, data_dim=2,
              maze_channels=(4,), kp_feat_dim=5)
    kp = _port(denoisers.KeypointDenoiser, 5, **kw)
    meta = dict(stage="keypoints", T=12, K=4, N_train=10, schedule="linear", d_model=16,
                n_layers=1, n_heads=2, d_ff=32, d_cond=8, maze_channels="4", use_sdf=0,
                cond_start_goal=1, data_dim=2, use_kp_feat=1, kp_feat_dim=5)
    save_checkpoint(str(tmp_path / "ckpt_1"), dict(kp.named_parameters()), None, 1, None, meta)
    loaded, _ = loading.load_keypoint_model(str(tmp_path), bf16=False, device="cpu")
    assert loaded.kp_feat_dim == 5 and loaded.in_proj.weight.shape == kp.in_proj.weight.shape
    save_checkpoint(str(tmp_path / "off" / "ckpt_1"), {}, None, 1, None, dict(meta, use_kp_feat=0))
    with pytest.raises(RuntimeError):   # use_kp_feat 0: no kp_feat inputs, other widths
        loading.load_keypoint_model(str(tmp_path / "off"), device="cpu")


# --- the sampler's selection knobs ------------------------------------------------

T_, K, LEVELS = 32, 4, 2
PKW = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, d_cond=16, data_dim=2, maze_channels=(4, 8))


@pytest.fixture(scope="module")
def pipes():
    r = np.random.default_rng(6)
    idx = np.stack([np.sort(np.concatenate([[0, T_ - 1], r.choice(np.arange(1, T_ - 1), K - 2,
                                                                  replace=False)]))
                    for _ in range(B)])
    cond = _cond(6)
    c1 = {k: jnp.asarray(v[:1]) for k, v in cond.items()}
    kp = jden.KeypointDenoiser(**PKW, kp_feat_dim=5)
    kp_p = jax.tree.map(np.asarray, kp.init(
        jax.random.PRNGKey(1), jnp.zeros((1, K, 2)), jnp.zeros((1,), jnp.int32),
        jnp.asarray(idx[:1], jnp.int32), jnp.zeros((1, K, 2), bool),
        dict(c1, kp_feat=jnp.zeros((1, K, 5))), T_)["params"])
    it = jden.InterpLevelDenoiser(**PKW, mask_channels=2)
    it_p = jax.tree.map(np.asarray, it.init(
        jax.random.PRNGKey(2), jnp.zeros((1, T_, 2)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, T_, 2)), c1)["params"])
    it_p["out"]["kernel"] = (r.normal(size=it_p["out"]["kernel"].shape) * 0.05).astype(np.float32)

    def port(cls, p, kind, **kw):
        m = build_model(cls, generator=torch.Generator().manual_seed(0), **PKW, **kw)
        m.load_state_dict(params_to_state_dict(p, kind), strict=True)
        return m.eval()

    dphi = _port(SegmentCostPredictor, 7, d_cond=16, hidden_dim=24, maze_channels=(4, 8))
    jdphi = jselm.SegmentCostPredictor(d_cond=16, hidden_dim=24, maze_channels=(4, 8))
    dphi_p = _jax_params(dphi, convert_segment_cost)
    return dict(idx=idx, cond=cond, kp=kp, kp_p=kp_p, it=it, it_p=it_p,
                kp_t=port(denoisers.KeypointDenoiser, kp_p, "keypoint", kp_feat_dim=5),
                it_t=port(denoisers.InterpLevelDenoiser, it_p, "interp", mask_channels=2),
                dphi=lambda c, i: dphi(c, psel.build_segment_features_from_idx(i, T_)),
                jdphi=lambda c, i: jdphi.apply({"params": dphi_p}, c,
                                               jsel.build_segment_features_from_idx(i, T_)),
                logits=r.normal(size=(B, T_)).astype(np.float32))


@pytest.mark.parametrize("case", ["kp_feat_dphi", "kp_feat_zero_costs", "selector_logits",
                                  "selector_without_logits"])
def test_pipeline_selection_knobs_match_jax(pipes, case):
    """kp_feat_dim 5 with D_phi's cost channels (and without D_phi: zeros),
    and stage2_mask_policy="selector" with the selector's logits (and
    without them: the masks grow from idx, as the JAX pipeline does), on the
    draws JAX made."""
    s = pipes
    kw = dict(T=T_, K=K, levels=LEVELS, K_min=K, ddim_steps=3, pos_clip=True, kp_feat_dim=5)
    if case.startswith("selector"):
        kw["stage2_mask_policy"] = "selector"
    dphi = case == "kp_feat_dphi"
    logits = s["logits"] if case == "selector_logits" else None
    jpipe = jgen.make_pipeline(s["kp"], s["it"], jmake_schedule("linear", 10),
                               jgen.PipelineConfig(**kw), 2, s["jdphi"] if dphi else None)
    key = jax.random.PRNGKey(3)
    ref = jpipe(s["kp_p"], s["it_p"], key, jnp.asarray(s["idx"], jnp.int32), j(s["cond"]),
                None, None if logits is None else jnp.asarray(logits))
    k1, k2 = jax.random.split(key)
    pipe = generate.make_pipeline(s["kp_t"], s["it_t"], make_schedule("linear", 10),
                                  generate.PipelineConfig(**kw), 2, s["dphi"] if dphi else None)
    out = pipe(torch.as_tensor(s["idx"]), t(s["cond"]),
               z_init=torch.as_tensor(np.array(jax.random.normal(k1, (B, K, 2)))),
               mask_rand=torch.as_tensor(np.array(jax.random.uniform(k2, (B, T_)))),
               selector_logits=None if logits is None else torch.as_tensor(logits))
    for name, a, b in zip(("x_interp", "x_refined", "z_pred"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-3, err_msg=name)
