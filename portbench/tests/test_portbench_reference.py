"""Each plain reference against the port at small widths on the CPU, in
float32, on the same weights and inputs."""
import torch

from pb_tiny import tiny_maze, tiny_wan
from portbench.generators import wan_train
from portbench.harness import core
from portbench.harness.weights import make_weights
from portbench.reference import wan_ref
from portbench.reference.numerics import Numerics


def test_maze_reference_matches_the_port_in_float32():
    cell = tiny_maze("fused")
    cell.config = dict(cell.config, weights_dtype="float32")
    out = core.generator_module(cell).run(cell, 11, 0.2, False, device="cpu")
    gaps = {c.name: c.value for c in out.checks}
    # the same float32 arithmetic in another order: rounding, through 19 DDIM steps
    assert gaps["refined_gap_max"] < 1e-4 and gaps["keypoint_gap_max"] < 1e-4, gaps


def test_wan_reference_forward_matches_the_port():
    cell = tiny_wan()
    cfg, tr = cell.config, cell.traffic
    weights = {n: w.float() for n, w in make_weights(wan_ref.param_spec(cfg), 3, "cpu").items()}
    wan, fc = wan_train.build_program(cfg, weights, "cpu")
    wan = wan.float()
    g = torch.Generator().manual_seed(4)
    C, H, W = tr["latents"]
    lat = torch.randn((2, C, tr["K"], H, W), generator=g)
    t = torch.tensor([3, 700])
    text = torch.randn((2, tr["text_len"], cfg["text_dim"]), generator=g) * 0.02
    idx = torch.tensor([[0, 3, 7], [1, 4, 6]])
    extra = torch.randn((2, tr["K"], cfg["text_dim"]), generator=g)
    with torch.no_grad():
        got = wan(lat, t, text, idx, extra)
        ref = wan_ref.Ref(weights, cfg, Numerics("f32")).forward(lat, t, text, idx, extra,
                                                                remat=False)
    # the port's sparse branch runs on bf16 q/k/v (the kernels' contract) even in
    # f32: ~1e-4 here; dense attention in its place reads ~1e-2
    err = (got - ref).abs().max() / ref.abs().max()
    assert err < 1e-3, float(err)
