"""The port's five wansynth interpolator / selector trainers against the JAX
trainers' own loss functions, on the CPU in f32: the loss and every leaf's
gradient on the same params, batch and draws.

Each JAX trainer's main runs as it stands until its first step, whose
loss_fn, params, batch and key are captured (the flax init is replaced by
random params in the init's shapes: an op-by-op flax init compiles every
primitive, ~30 s for the flow model). The JAX draws come from that key by
the loss_fn's own splits and are handed to the port's loss; the JAX side's
loss and gradient run under one jit.

Tolerances: losses 1e-5 relative; gradients 1e-4 of each leaf's largest
JAX gradient.
"""
import jax
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.train import train_flow_interpolator_wansynth as jflow
from interpolated_diffusion_tpu.train import train_latent_straightener_wansynth as jstr
from interpolated_diffusion_tpu.train import train_segment_cost_wansynth as jseg
from interpolated_diffusion_tpu.train import train_sinkhorn_interp_wansynth as jsk
from interpolated_diffusion_tpu.train import train_video_selector_wansynth as jsel
from interpolated_diffusion_tpu_torch.models.jax_import import module_tree_to_state_dict
from interpolated_diffusion_tpu_torch.train import train_flow_interpolator_wansynth as pflow
from interpolated_diffusion_tpu_torch.train import train_latent_straightener_wansynth as pstr
from interpolated_diffusion_tpu_torch.train import train_segment_cost_wansynth as pseg
from interpolated_diffusion_tpu_torch.train import train_sinkhorn_interp_wansynth as psk
from interpolated_diffusion_tpu_torch.train import train_video_selector_wansynth as psel

from test_torch_interpolators import jparams

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
DATA = ["--num_samples", "8", "--T", "8", "--latent_c", "4", "--latent_h", "8", "--latent_w",
        "8", "--text_len", "6", "--text_dim", "32", "--batch", "2", "--steps", "1",
        "--prefetch_depth", "0", "--bf16", "0"]


class _Stop(Exception):
    pass


def capture_jax_step(monkeypatch, module, model_cls, argv):
    """(loss_fn, params, batch, key) of a JAX trainer's first step."""
    kept = {}

    def fast_init(self, rngs, *args, method=None, **kwargs):
        return {"params": jparams(self, *args, method=method, **kwargs)}

    def make_train_step(loss_fn, tx, *a, **kw):
        kept["loss_fn"] = loss_fn

        def step(state, batch, key):
            kept.update(params=state.params, batch=batch, key=key)
            raise _Stop

        return step

    monkeypatch.setattr(model_cls, "init", fast_init)
    monkeypatch.setattr(module, "make_train_step", make_train_step)
    with pytest.raises(_Stop):
        module.main(argv)
    np_tree = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x), t)
    return kept["loss_fn"], np_tree(kept["params"]), np_tree(kept["batch"]), kept["key"]


def compare(jax_loss_fn, params, batch, key, port_model, port_loss_fn, draws):
    """Loss and every leaf's gradient, JAX (one jit) against the port."""
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True))(
        params, batch, key)
    port_model.load_state_dict(module_tree_to_state_dict(params), strict=True)
    leaves = dict(port_model.named_parameters())
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _ = port_loss_fn(leaves, tbatch, draws)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(loss.item() - float(ref_loss)) <= LOSS_TOL * abs(float(ref_loss))
    want = module_tree_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert want.keys() == grads.keys()
    worst = max((np.abs(grads[k].numpy() - want[k].numpy()).max()
                 / max(np.abs(want[k].numpy()).max(), 1e-30), k) for k in want)
    assert worst[0] <= GRAD_TOL, worst
    assert all(np.abs(v.numpy()).max() > 0 for v in want.values())    # every leaf acts


def triplet_draws(key, B, T, min_gap=2):
    """The flow / straightener loss_fn's draws from its key."""
    k1, k2 = jax.random.split(key)
    return {"gap": torch.tensor(np.asarray(jax.random.randint(k1, (B,), min_gap, T))),
            "t0": torch.tensor(np.asarray(jax.random.randint(k2, (B,), 0, T)))}


def test_flow_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch):
    """Every optional term on: gap weighting, edge, multi-scale, flow smoothness."""
    flags = DATA + ["--base_channels", "8", "--edge_weight", "0.2", "--ms_weight", "0.3",
                    "--flow_smooth_weight", "0.01", "--gap_weighting", "1"]
    from interpolated_diffusion_tpu.models.flow_interpolator import LatentFlowInterpolator

    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jflow, LatentFlowInterpolator, flags + ["--out_dir", str(tmp_path / "j")])
    args = pflow.build_argparser().parse_args(flags + ["--device", "cpu"])
    model = pflow.build_model(args, torch.device("cpu"))
    compare(loss_fn, params, batch, key, model, pflow.make_loss_fn(model, args),
            triplet_draws(key, 2, 8))


@pytest.mark.parametrize("extra", [["--hidden_channels", "8"],
                                   ["--arch", "token", "--token_patch", "2", "--token_d_model",
                                    "32", "--token_layers", "1", "--loss_type", "l1"]])
def test_straightener_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch, extra):
    from interpolated_diffusion_tpu.models import straightener as jst

    flags = DATA + extra
    cls = jst.LatentStraightenerTokenTransformer if "token" in extra else jst.LatentStraightener
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jstr, cls, flags + ["--out_dir", str(tmp_path / "j")])
    args = pstr.build_argparser().parse_args(flags + ["--device", "cpu"])
    model = pstr.build_model(args, torch.device("cpu"))
    compare(loss_fn, params, batch, key, model, pstr.make_loss_fn(model, args),
            triplet_draws(key, 2, 8))


def test_sinkhorn_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch):
    """4 x 4 tokens, window 3 (tails in both directions), learned tau and
    dustbin, forward-backward confidence. No global alignment: its phase
    correlation is a discrete choice without gradient, held to JAX in
    tests/test_torch_interpolators.py, and its five angles would triple the
    JAX compile."""
    from interpolated_diffusion_tpu.models.sinkhorn_warp import SinkhornWarpInterpolator

    flags = DATA + ["--sinkhorn_patch", "2", "--win_size", "3", "--sinkhorn_iters", "2",
                    "--K", "3", "--global_mode", "none"]
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jsk, SinkhornWarpInterpolator, flags + ["--out_dir", str(tmp_path / "j")])
    args = psk.build_argparser().parse_args(flags + ["--device", "cpu"])
    model = psk.build_model(args, torch.device("cpu"))
    draws = {"idx_rand": torch.tensor(np.asarray(jax.random.uniform(key, (2, 6))))}
    compare(loss_fn, params, batch, key, model, psk.make_loss_fn(model, args), draws)


def test_segment_cost_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch):
    flags = DATA + ["--d_cond", "16", "--hidden_dim", "32"]
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jseg, jseg.VideoSegmentCostPredictor,
        flags + ["--out_dir", str(tmp_path / "j")])
    args = pseg.build_argparser().parse_args(flags + ["--device", "cpu"])
    batch0 = {"latents": batch["latents"]}
    targets = pseg.Targets(args, batch0, torch.device("cpu"))
    model = pseg.build_model(args, torch.device("cpu"))
    compare(loss_fn, params, batch, key, model, pseg.make_loss_fn(model, targets), None)


def test_video_selector_trainer_loss_and_grads_match_jax(tmp_path, monkeypatch):
    """Level-conditioned; the batch's DP targets are JAX's, and the port's
    dp_labels give the same keyframes on the same clips."""
    from interpolated_diffusion_tpu.models.video_selector import VideoKeyframeSelector

    flags = DATA + ["--K", "3", "--d_model", "32", "--d_cond", "16", "--n_sel_layers", "2",
                    "--n_heads", "2", "--d_ff", "64", "--use_level", "1"]
    loss_fn, params, batch, key = capture_jax_step(
        monkeypatch, jsel, VideoKeyframeSelector, flags + ["--out_dir", str(tmp_path / "j")])
    args = psel.build_argparser().parse_args(flags + ["--device", "cpu"])
    model = psel.build_model(args, torch.device("cpu"))
    compare(loss_fn, params, batch, key, model, psel.make_loss_fn(model, args), None)
    # the labels: the same DP keyframes from the same clips
    from interpolated_diffusion_tpu.train.wansynth_common import make_wansynth_loader
    from interpolated_diffusion_tpu_torch.ops.oracle_segment_cost import (
        build_oracle_seg_precompute)

    jargs = jsel.build_argparser().parse_args(flags)
    lat = next(make_wansynth_loader(jargs, jargs.seed))["latents"]
    target, _ = psel.dp_labels(torch.as_tensor(lat), build_oracle_seg_precompute(8), 3)
    assert np.array_equal(target.numpy(), batch["target"])
