"""The two maze trainers' loss, gradients and optimizer steps against the JAX
trainers, on the CPU in f32, from the same weights, batch and random draws.

The JAX model is initialised, its parameters go to the port through
models/jax_import.params_to_state_dict, and JAX trees (gradients, the
TrainState's params and EMA after a step) are compared leaf by leaf in the
port's names through the same converter. JAX's draws are recomputed with the
key-split order of its loss functions (train/train_keypoints.py :157,:190;
train/train_interp_levels.py :497 and sample_level_indices :251) and
injected. The JAX attention policy is whatever its registry gives on the CPU
(its Pallas kernels fall back to their XLA twins there); the port runs the
same policy through its kernels' plain twins.

Tolerances: loss 1e-5 relative; every leaf's gradient 1e-4 of its max; after
two optimizer steps, parameters and EMA 1e-4 of each leaf's max, except on
elements whose gradient was under 1e-6 in magnitude at a step: Adam's first
steps are g / (|g| + 1e-8), so f32 noise in such an element moves its update
by up to the whole step, and those elements are held to 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.ops.schedules import make_schedule as j_make_schedule
from interpolated_diffusion_tpu.train import state as jstate
from interpolated_diffusion_tpu.train import train_interp_levels as js2
from interpolated_diffusion_tpu.train import train_keypoints as js1
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
from interpolated_diffusion_tpu_torch.ops.keyframes import compute_k_schedule
from interpolated_diffusion_tpu_torch.train import batches
from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2
from interpolated_diffusion_tpu_torch.train import train_keypoints as ps1
from interpolated_diffusion_tpu_torch.utils.checkpoint import save_checkpoint

B, T, G = 6, 32, 9
TINY = ["--T", str(T), "--d_model", "32", "--n_layers", "2", "--n_heads", "4", "--d_ff", "64",
        "--d_cond", "16", "--maze_channels", "8,8", "--maze_h", str(G), "--maze_w", str(G),
        "--batch", str(B), "--bf16", "0", "--lr", "1e-3", "--N_train", "50"]
TINY2 = [a for a in TINY if a not in ("--N_train", "50")]
GRAD_TOL, STEP_TOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _no_registry(monkeypatch):
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)


def t(a):
    return torch.tensor(np.array(a))


def _batch(D, seed=0):
    r = np.random.default_rng(seed)
    return {"x": r.uniform(size=(B, T, D)).astype(np.float32),
            "occ": (r.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32),
            "start_goal": r.uniform(size=(B, 4)).astype(np.float32)}


def _randomised(params, seed):
    """flax zero-initialises biases (and the Stage-2 head): perturb every leaf."""
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * r.normal(size=p.shape).astype(np.float32), params)


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-12)


def _check_grads(model, grads_j, kind, loss, loss_j):
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = params_to_state_dict(jax.tree.map(np.asarray, grads_j), kind)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    got = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    for n, g in zip(names, got):
        assert _rel(g, want[n]) <= GRAD_TOL, (n, _rel(g, want[n]))


def _two_steps(jloss, tx, params, model, kind, pstate, pstep, batches_, rngs, draws, lr):
    """Two optimizer steps on each side; params and EMA leaf by leaf."""
    jst = jstate.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jstate.make_train_step(jloss, tx, 0.9, donate=False)
    names = list(pstate.params)
    leaves = [pstate.params[n] for n in names]
    settled = {n: torch.ones_like(p, dtype=torch.bool) for n, p in zip(names, leaves)}
    for b, rng, d in zip(batches_, rngs, draws):
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()}, rng)
        tb = {k: t(v) for k, v in b.items()}
        loss, _ = pstep.loss_fn(None, tb, d)
        for n, g in zip(names, torch.autograd.grad(loss, leaves)):
            settled[n] &= (g == 0) | (g.abs() >= 1e-6)
        pstate, m = pstep(pstate, tb, d)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    assert pstate.step == int(jst.step) == 2
    for tree_j, tree_p in ((jst.params, pstate.params), (jst.ema_params, pstate.ema_params)):
        want = params_to_state_dict(jax.tree.map(np.asarray, tree_j), kind)
        for n in names:
            d = (tree_p[n].detach() - want[n]).abs()
            tol = STEP_TOL * float(want[n].abs().max())
            bound = torch.where(settled[n], torch.tensor(tol), torch.tensor(max(tol, 2 * lr)))
            assert bool((d <= bound).all()), (n, float(d.max()), tol)
    start = params_to_state_dict(params, kind)
    assert all(not torch.equal(pstate.params[n].detach(), start[n]) for n in names)
    assert all(not torch.equal(pstate.ema_params[n], start[n]) for n in names)


class _Step:
    """The port's train step with its loss function kept beside it."""

    def __init__(self, loss_fn, ema_decay):
        from interpolated_diffusion_tpu_torch.train.state import make_train_step

        self.loss_fn = loss_fn
        self.step = make_train_step(loss_fn, ema_decay)

    def __call__(self, *a):
        return self.step(*a)


# --- Stage 1 ---------------------------------------------------------------------

def _s1_draws(rng, args, D, device_policy):
    """train_keypoints.loss_fn: (rng, k_policy = split(rng)) with a device
    policy, then k_t, k_eps = split(rng)."""
    out = {}
    if device_policy is not None:
        rng, k_policy = jax.random.split(rng)
        shape = (B, T - 2) if device_policy == "random" else (B, args.K)
        out["policy_rand"] = t(jax.random.uniform(k_policy, shape))
    k_t, k_eps = jax.random.split(rng)
    out["t"] = t(jax.random.randint(k_t, (B,), 0, args.N_train))
    out["eps"] = t(jax.random.normal(k_eps, (B, args.K, D)))
    return out


def _s1_setup(flags, D, seed=0):
    jargs = js1.build_argparser().parse_args(TINY + ["--K", "5", "--with_velocity", str(int(D == 4))]
                                             + flags)
    pargs = ps1.build_argparser().parse_args(TINY + ["--K", "5", "--device", "cpu",
                                                     "--with_velocity", str(int(D == 4))] + flags)
    jmodel = js1.build_model(jargs, D)
    b = _batch(D, seed)
    cond = {"occ": jnp.asarray(b["occ"][:2]), "start_goal": jnp.asarray(b["start_goal"][:2])}
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, 5, D)), jnp.zeros((2,), jnp.int32),
                         jnp.zeros((2, 5), jnp.int32), jnp.zeros((2, 5, D), bool), cond,
                         T)["params"]
    params = _randomised(params, seed)
    model = ps1.build_model(pargs, D, torch.device("cpu"))
    model.load_state_dict(params_to_state_dict(params, "keypoint"), strict=True)
    return jargs, pargs, jmodel, params, model, b


@pytest.mark.parametrize("flags,D,policy", [
    ([], 2, "random"),
    (["--idx_policy", "uniform:1.0", "--uniform_jitter", "0.6", "--logit_space", "1"], 4, "uniform"),
    (["--idx_policy", "dp:0.5,random:0.5", "--clamp_endpoints", "0"], 2, None)])
def test_stage1_loss_and_gradients_match_jax(flags, D, policy):
    jargs, pargs, jmodel, params, model, b = _s1_setup(flags, D)
    assert ps1.device_policy_of(pargs) == policy
    if policy is None:
        b["idx"] = ps1.sample_idx_policy(np.random.RandomState(0), pargs.idx_policy, B, T, 5,
                                         np.sort(np.random.default_rng(0).choice(
                                             T, (B, 5), replace=True), axis=1))
    jloss = js1.make_loss_fn(jmodel, jargs, j_make_schedule(jargs.schedule, jargs.N_train), policy)
    rng = jax.random.PRNGKey(40)
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in b.items()}, rng)
    ploss = ps1.make_loss_fn(model, pargs, ps1.make_schedule(pargs.schedule, pargs.N_train), policy)
    loss, aux = ploss(None, {k: t(v) for k, v in b.items()}, _s1_draws(rng, pargs, D, policy))
    assert aux == {}
    _check_grads(model, grads_j, "keypoint", loss, loss_j)


def test_stage1_two_optimizer_steps_match_jax():
    jargs, pargs, jmodel, params, model, _ = _s1_setup([], 2, seed=1)
    jloss = js1.make_loss_fn(jmodel, jargs, j_make_schedule(jargs.schedule, jargs.N_train), "random")
    tx = jstate.make_optimizer(jargs.lr, jargs.weight_decay, jargs.grad_clip)
    pargs.steps_per_call, pargs.ema_decay = 1, 0.9
    pstate, _, _ = ps1.make_trainer(pargs, torch.device("cpu"), 2, model)
    pstep = _Step(ps1.make_loss_fn(model, pargs, ps1.make_schedule(pargs.schedule, pargs.N_train),
                                   "random"), 0.9)
    rngs = [jax.random.PRNGKey(50), jax.random.PRNGKey(51)]
    _two_steps(jloss, tx, params, model, "keypoint", pstate, pstep, [_batch(2, 2), _batch(2, 3)],
               rngs, [_s1_draws(r, pargs, 2, "random") for r in rngs], pargs.lr)


# --- Stage 2 ---------------------------------------------------------------------

def _corrupt_draws(key, Kn, jitter):
    k_jit, k_use, k_anchor, k_noise = jax.random.split(key, 4)
    return {"jit": t(jax.random.randint(k_jit, (B, Kn), -jitter, jitter + 1)) if jitter else None,
            "use": t(jax.random.uniform(k_use, (B, Kn))),
            "anchor": t(jax.random.normal(k_anchor, (B, Kn, 2))),
            "noise": t(jax.random.normal(k_noise, (B, T, 2)))}


def _s2_draws(rng, args, D, K_boot=None):
    """train_interp_levels.loss_fn: k_mask, k_s, k_batch, k_boot, k_rep =
    split(rng, 5); a policy mix splits k_mask again; the batch functions split
    k_batch into (k_masks, k_s, k_lvls) and k_lvls per level."""
    k_mask, k_s, k_batch, k_boot, k_rep = jax.random.split(rng, 5)
    k_m1, k_m2 = jax.random.split(k_mask) if args.mask_policy_mix else (k_mask, k_mask)
    k1, k2 = jax.random.split(k_s)
    kn = compute_k_schedule(T, args.K_min, args.levels, args.k_schedule)
    lvl_keys = jax.random.split(jax.random.split(k_batch, 3)[2], args.levels + 1)
    out = {"mask_rand": t(jax.random.uniform(k_m1, (B, T - 2))),
           "base_rand": t(jax.random.uniform(k_m2, (B, T))),
           "s_uni": t(jax.random.randint(k1, (B,), 1, args.levels + 1)),
           "s_high": t(jax.random.uniform(k2, (B,))),
           "boot_rep": t(jax.random.uniform(k_rep, (B,))),
           "levels": [_corrupt_draws(lvl_keys[s], kn[s], batches.compute_jitter_for_level(
               kn[s], args.K_min, args.corrupt_index_jitter_max, args.corrupt_index_jitter_pow))
               for s in range(args.levels + 1)]}
    if K_boot:
        out["boot_z"] = t(jax.random.normal(k_boot, (B, K_boot, D)))
    return out


def _s2_setup(flags, D, seed=0):
    base = TINY2 + ["--K_min", "4", "--levels", "2", "--with_velocity", str(int(D == 4))] + flags
    jargs = js2.build_argparser().parse_args(base)
    pargs = ps2.build_argparser().parse_args(base + ["--device", "cpu"])
    jmodel = js2.build_model(jargs, D)
    b = _batch(D, seed)
    mc = js2.mask_channels_for(jargs)
    assert mc == ps2.mask_channels_for(pargs)
    cond = {"occ": jnp.asarray(b["occ"][:2]), "start_goal": jnp.asarray(b["start_goal"][:2])}
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, T, D)), jnp.zeros((2,), jnp.int32),
                         jnp.zeros((2, T, mc)) if mc > 1 else jnp.zeros((2, T), bool),
                         cond)["params"]
    params = _randomised(params, seed)
    model = ps2.build_model(pargs, D, torch.device("cpu"))
    model.load_state_dict(params_to_state_dict(params, "interp"), strict=True)
    return jargs, pargs, jmodel, params, model, b


CORRUPT = ["--corrupt_mode", "dist", "--corrupt_sigma_max", "0.05", "--corrupt_sigma_min", "0.01",
           "--corrupt_anchor_frac", "0.5", "--corrupt_index_jitter_max", "2",
           "--corrupt_index_jitter_prob", "0.5", "--pos_clip", "1"]


@pytest.mark.parametrize("flags,D", [
    ([], 2),                                                     # adj, random_nested, defaults
    (["--mode", "x0", "--level_sampling", "uniform"], 2),
    (["--anchor_conf", "1", "--anchor_conf_anneal", "1", "--anchor_conf_anneal_mode", "cosine",
      "--w_anchor", "2.0", "--w_missing", "0.5", "--smooth_weight", "0.3"] + CORRUPT, 4),
    (["--mode", "x0", "--anchor_conf", "1", "--anchor_conf_anneal", "1", "--mask_policy",
      "uniform", "--corrupt_vel", "1", "--k_schedule", "linear"] + CORRUPT, 4),
    (["--mask_policy", "dp", "--clean_target", "0", "--w_anchor", "3.0",
      "--clamp_endpoints", "0"] + CORRUPT, 2),
    (["--mask_policy_mix", "uniform:0.4,random:0.3,dp:0.3", "--recompute_vel", "0"], 4),
    (["--causal", "1", "--anchor_conf", "1"], 2)])                # the causal trainer
def test_stage2_loss_and_gradients_match_jax(flags, D):
    jargs, pargs, jmodel, params, model, b = _s2_setup(flags, D)
    kp_idx = np.sort(np.stack([np.random.default_rng(i).choice(T, 4, replace=False)
                               for i in range(B)]), axis=1)
    kp_idx[:, 0], kp_idx[:, -1] = 0, T - 1
    host = ps2.host_batch(pargs, dict(b, kp_idx=kp_idx), 0, np.random.RandomState(1))
    assert ("idx_base" in host) == (pargs.mask_policy in ("dp", "uniform")
                                    or bool(pargs.mask_policy_mix))
    jloss = js2.make_loss_fn(jmodel, jargs)
    rng = jax.random.PRNGKey(60)
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in host.items()}, rng)
    ploss = ps2.make_loss_fn(model, pargs)
    loss, _ = ploss(None, {k: t(v) for k, v in host.items()}, _s2_draws(rng, pargs, D))
    _check_grads(model, grads_j, "interp", loss, loss_j)


def test_stage2_bootstrap_loss_matches_jax(tmp_path):
    """--bootstrap_ckpt: the same Stage-1 weights as a JAX checkpoint and as a
    port checkpoint; the student anchors, their scatter into x0 and the
    student confidence give the JAX loss and gradients."""
    D = 2
    j1, p1, _, kp_params, _, _ = _s1_setup(["--schedule", "cosine"], D, seed=3)
    meta = js1.make_meta(j1, D)
    assert meta == ps1.make_meta(p1, D)
    jckpt.save_checkpoint(str(tmp_path / "j" / "ckpt_1"), jax.tree.map(jnp.asarray, kp_params),
                          None, 1, None, meta)
    save_checkpoint(str(tmp_path / "p" / "ckpt_1"), params_to_state_dict(kp_params, "keypoint"),
                    None, 1, None, meta)
    flags = ["--anchor_conf", "1", "--pos_clip", "1", "--bootstrap_ddim_steps", "3",
             "--bootstrap_warmup_steps", "2"]
    jargs, pargs, jmodel, params, model, b = _s2_setup(flags, D, seed=4)
    jargs.bootstrap_ckpt, pargs.bootstrap_ckpt = str(tmp_path / "j"), str(tmp_path / "p")
    host = ps2.host_batch(pargs, b, 0, np.random.RandomState(1))
    assert host["bootstrap_p"] == np.float32(0.25)
    host["bootstrap_p"] = np.float32(0.6)
    jsample, K = js2.make_bootstrap_sampler(jargs, D)
    psample, pK = ps2.make_bootstrap_sampler(pargs, D, torch.device("cpu"))
    assert K == pK == 5
    jloss = js2.make_loss_fn(jmodel, jargs, jsample)
    rng = jax.random.PRNGKey(70)
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in host.items()}, rng)
    ploss = ps2.make_loss_fn(model, pargs, psample)
    # the coarsest level has K_min = 4 anchors: the student samples those
    loss, _ = ploss(None, {k: t(v) for k, v in host.items()}, _s2_draws(rng, pargs, D, K_boot=4))
    _check_grads(model, grads_j, "interp", loss, loss_j)


def test_stage2_two_optimizer_steps_match_jax():
    flags = ["--anchor_conf", "1"] + CORRUPT
    jargs, pargs, jmodel, params, model, _ = _s2_setup(flags, 2, seed=5)
    jloss = js2.make_loss_fn(jmodel, jargs)
    tx = jstate.make_optimizer(jargs.lr, jargs.weight_decay, jargs.grad_clip)
    pargs.steps_per_call = 1
    pstate, _, _ = ps2.make_trainer(pargs, torch.device("cpu"), 2, model)
    pstep = _Step(ps2.make_loss_fn(model, pargs), 0.9)
    rngs = [jax.random.PRNGKey(80), jax.random.PRNGKey(81)]
    _two_steps(jloss, tx, params, model, "interp", pstate, pstep, [_batch(2, 6), _batch(2, 7)],
               rngs, [_s2_draws(r, pargs, 2) for r in rngs], pargs.lr)


# --- the selection options (kp_feat, D_phi, the selector policies) ------------------

SEL_META = dict(stage="selector", T=T, K=4, d_model=16, n_heads=2, d_ff=32, n_layers=2,
                pos_dim=8, use_sdf=0, cond_start_goal=1, use_sg_map=1, use_sg_token=1,
                use_goal_dist_token=0, use_cond_bias=0, cond_bias_mode="memory", use_level=1,
                level_mode="k_norm", levels=2, k_schedule="doubling", k_geom_gamma=None,
                sg_map_sigma=1.5, maze_channels="4,8", maze_h=G, maze_w=G)
DPHI_META = dict(stage="segment_cost", T=T, d_cond=16, seg_feat_dim=3, hidden_dim=24, n_layers=3,
                 use_sdf=0, cond_start_goal=1, maze_channels="4,8", normalize_targets=0,
                 target_mean=0.0, target_std=1.0, maze_h=G, maze_w=G)


@pytest.fixture(scope="module")
def sel_ckpts(tmp_path_factory):
    """A seeded keypoint selector and D_phi, saved as a port checkpoint and,
    through the JAX package's converters, as a JAX checkpoint of the same
    weights: {"sel": (jax dir, port dir), "dphi": (...)}."""
    from interpolated_diffusion_tpu.models.torch_import import (convert_keypoint_selector,
                                                                convert_segment_cost)
    from interpolated_diffusion_tpu_torch.models.init import build_model
    from interpolated_diffusion_tpu_torch.models.selector import (KeypointSelector,
                                                                  SegmentCostPredictor)

    root = tmp_path_factory.mktemp("sel_ckpts")
    models = {
        "sel": (build_model(KeypointSelector, generator=torch.Generator().manual_seed(8), T=T,
                            d_model=16, n_heads=2, d_ff=32, n_layers=2, pos_dim=8,
                            use_level=True, maze_channels=(4, 8)),
                lambda sd: convert_keypoint_selector(sd, n_heads=2), SEL_META),
        "dphi": (build_model(SegmentCostPredictor, generator=torch.Generator().manual_seed(9),
                             d_cond=16, hidden_dim=24, maze_channels=(4, 8)),
                 convert_segment_cost, DPHI_META)}
    out = {}
    for name, (model, convert, meta) in models.items():
        sd = {k: v.detach() for k, v in model.state_dict().items()}
        save_checkpoint(str(root / f"p_{name}" / "ckpt_1"), sd, None, 1, None, meta)
        jckpt.save_checkpoint(str(root / f"j_{name}" / "ckpt_1"), jax.tree.map(
            jnp.asarray, convert({k: v.numpy() for k, v in sd.items()})), None, 1, None, meta)
        out[name] = (str(root / f"j_{name}"), str(root / f"p_{name}"))
    return out


@pytest.mark.parametrize("case", ["kp_feat", "kp_feat_dphi", "selector_policy"])
def test_stage1_selection_options_match_jax(case, sel_ckpts):
    """--use_kp_feat (index features only; with --dphi_ckpt, the D_phi cost
    channels) and the selector entry of --idx_policy (the selector's top-K
    anchors, mixed per sample on the host) against the JAX trainer."""
    from interpolated_diffusion_tpu.models.loading import make_dphi_seg_cost_fn as j_dphi
    from interpolated_diffusion_tpu.models.loading import load_selector_model as j_sel
    from interpolated_diffusion_tpu.models.selector import select_topk_indices as j_topk
    from interpolated_diffusion_tpu.train.common import sample_idx_policy as j_policy
    from interpolated_diffusion_tpu_torch.models.loading import make_dphi_seg_cost_fn as p_dphi

    flags = {"kp_feat": ["--use_kp_feat", "1", "--kp_feat_dim", "3"],
             "kp_feat_dphi": ["--use_kp_feat", "1", "--kp_feat_dim", "5"],
             "selector_policy": ["--idx_policy", "selector:0.5,random:0.5"]}[case]
    jargs, pargs, jmodel, params, model, b = _s1_setup(flags, 2, seed=6)
    jdphi = pdphi = None
    if case == "kp_feat_dphi":
        jdphi, _ = j_dphi(sel_ckpts["dphi"][0], T, False, False)
        pdphi, _ = p_dphi(sel_ckpts["dphi"][1], T, False, False, device="cpu")
    policy = ps1.device_policy_of(pargs)
    if case == "selector_policy":
        pargs.selector_ckpt = sel_ckpts["sel"][1]
        sel_idx = ps1.make_selector_idx_fn(pargs, torch.device("cpu"))(b)
        sel_model, sel_params, _ = j_sel(sel_ckpts["sel"][0], False)
        j_logits = sel_model.apply({"params": sel_params}, {
            "occ": jnp.asarray(b["occ"]), "start_goal": jnp.asarray(b["start_goal"]),
            "level": jnp.full((B, 1), 5 / (T - 1))})
        np.testing.assert_array_equal(sel_idx, np.asarray(j_topk(j_logits, 5)))
        host = ps1.host_batch(pargs, dict(b, kp_idx=sel_idx), None, np.random.RandomState(2),
                              lambda _: sel_idx)
        np.testing.assert_array_equal(host["idx"], j_policy(
            np.random.RandomState(2), jargs.idx_policy, B, T, 5, sel_idx, 0.0, sel_idx))
        assert (host["idx"] == sel_idx).all(axis=1).any()
        b = host
    jloss = js1.make_loss_fn(jmodel, jargs, j_make_schedule(jargs.schedule, jargs.N_train),
                             policy, jdphi)
    rng = jax.random.PRNGKey(42)
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in b.items()}, rng)
    ploss = ps1.make_loss_fn(model, pargs, ps1.make_schedule(pargs.schedule, pargs.N_train),
                             policy, dphi_fn=pdphi)
    loss, _ = ploss(None, {k: t(v) for k, v in b.items()}, _s1_draws(rng, pargs, 2, policy))
    _check_grads(model, grads_j, "keypoint", loss, loss_j)


@pytest.mark.parametrize("case", ["selector", "selector_level", "mix_selector",
                                  "bootstrap_kp_feat_dphi"])
def test_stage2_selection_options_match_jax(case, sel_ckpts, tmp_path):
    """--mask_policy selector / selector_level (per-level logits of a
    level-conditioned selector), selector in --mask_policy_mix, and a
    bootstrap Stage-1 checkpoint trained with D_phi kp_feat channels (with
    --dphi_ckpt) against the JAX trainer."""
    D = 2
    flags = {"selector": ["--mask_policy", "selector"],
             "selector_level": ["--mask_policy", "selector_level"],
             "mix_selector": ["--mask_policy_mix", "selector:0.5,random:0.3,dp:0.2"],
             "bootstrap_kp_feat_dphi": ["--bootstrap_ddim_steps", "2", "--anchor_conf", "1"]}[case]
    jsample = psample = None
    K_boot = None
    if case == "bootstrap_kp_feat_dphi":
        j1, p1, _, kp_params, _, _ = _s1_setup(["--use_kp_feat", "1", "--kp_feat_dim", "5",
                                                "--dphi_ckpt", "d"], D, seed=7)
        meta = js1.make_meta(j1, D)
        assert meta == ps1.make_meta(p1, D) and meta["kp_feat_dphi"] == 1
        jckpt.save_checkpoint(str(tmp_path / "j" / "ckpt_1"), jax.tree.map(jnp.asarray, kp_params),
                              None, 1, None, meta)
        save_checkpoint(str(tmp_path / "p" / "ckpt_1"),
                        params_to_state_dict(kp_params, "keypoint"), None, 1, None, meta)
    jargs, pargs, jmodel, params, model, b = _s2_setup(flags, D, seed=8)
    jsel_fn = psel_fn = None
    if case == "bootstrap_kp_feat_dphi":
        jargs.bootstrap_ckpt, pargs.bootstrap_ckpt = str(tmp_path / "j"), str(tmp_path / "p")
        with pytest.raises(ValueError, match="dphi_ckpt"):
            ps2.make_bootstrap_sampler(pargs, D, torch.device("cpu"))
        jargs.dphi_ckpt, pargs.dphi_ckpt = sel_ckpts["dphi"]
        jsample, _ = js2.make_bootstrap_sampler(jargs, D)
        psample, K_boot = ps2.make_bootstrap_sampler(pargs, D, torch.device("cpu"))
    else:
        jargs.selector_ckpt, pargs.selector_ckpt = sel_ckpts["sel"]
        jsel_fn = js2.make_selector_logits_fn(jargs)
        psel_fn = ps2.make_selector_logits_fn(pargs, torch.device("cpu"))
    kp_idx = np.sort(np.stack([np.random.default_rng(i).choice(T, 4, replace=False)
                               for i in range(B)]), axis=1)
    kp_idx[:, 0], kp_idx[:, -1] = 0, T - 1
    host = ps2.host_batch(pargs, dict(b, kp_idx=kp_idx), 0, np.random.RandomState(1))
    if case == "bootstrap_kp_feat_dphi":
        host["bootstrap_p"] = np.float32(0.6)
    jloss = js2.make_loss_fn(jmodel, jargs, jsample, jsel_fn)
    rng = jax.random.PRNGKey(61)
    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in host.items()}, rng)
    ploss = ps2.make_loss_fn(model, pargs, psample, psel_fn)
    loss, _ = ploss(None, {k: t(v) for k, v in host.items()},
                    _s2_draws(rng, pargs, D, K_boot=4 if K_boot else None))
    _check_grads(model, grads_j, "interp", loss, loss_j)


# --- what is not ported raises ------------------------------------------------------

@pytest.mark.parametrize("mod,flags,match", [
    (ps1, ["--n_data_shards", "2"], "mesh 2x1 needs 2 processes.*torchrun --nproc_per_node 2"),
    (ps2, ["--n_data_shards", "2"], "mesh 2x1 needs 2 processes.*torchrun --nproc_per_node 2")])
def test_unported_flags_raise_naming_what_is_missing(mod, flags, match, tmp_path):
    """--n_data_shards is ported: more data shards than processes is an error
    that names torchrun (one process per GPU), never a silent shrink."""
    with pytest.raises(ValueError, match=match):
        mod.main(["--device", "cpu", "--out_dir", str(tmp_path)] + flags)


def test_trainers_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (ps1, ps2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--out_dir", str(tmp_path), "--num_samples", "8"])
    from interpolated_diffusion_tpu_torch.train.state import make_optimizer

    with pytest.raises(NotImplementedError, match="muon"):
        make_optimizer(1e-3, optimizer="muon")
