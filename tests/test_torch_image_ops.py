"""The port's image ops (ops/image.py) against the golden group `img/` (the
original PyTorch reference's F.grid_sample, F.interpolate and F.avg_pool2d)
and against the JAX package's ops/image.py, on the CPU in f32, tolerance
1e-5 relative. `resize_bilinear` is jax.image.resize: half-pixel bilinear
when it grows, antialiased (a triangle filter widened by the factor) when
it shrinks, so the downsampling cases matter.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.ops import image as jimg
from interpolated_diffusion_tpu_torch.ops import image as pimg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5


def rel(out, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(ROOT, "tests", "golden", "reference_golden.npz"))


def test_golden_img_group(g):
    x = torch.tensor(g["img/x"])
    assert rel(pimg.grid_sample_bilinear(x, torch.tensor(g["img/grid"])),
               g["img/grid_sample_border"]) <= OP_TOL
    assert rel(pimg.resize_bilinear(x, (16, 20)), g["img/resize_up"]) <= OP_TOL
    assert rel(pimg.avg_pool2d(x, 2), g["img/avg_pool2"]) <= OP_TOL


@pytest.mark.parametrize("out_hw", [(13, 20), (5, 7), (4, 13), (17, 5)])
def test_resize_matches_jax_up_down_and_mixed(out_hw):
    """From 9 x 13: up by a non-integer factor, down on both axes (the
    antialiased case), and one axis each way."""
    x = np.random.default_rng(0).normal(size=(2, 3, 9, 13)).astype(np.float32)
    ref = jimg.resize_bilinear(jnp.asarray(x), out_hw)
    assert rel(pimg.resize_bilinear(torch.tensor(x), out_hw), ref) <= OP_TOL


def test_warp_cost_volume_and_normalize_match_jax():
    r = np.random.default_rng(1)
    z0, z1 = (r.normal(size=(2, 4, 8, 12)).astype(np.float32) for _ in range(2))
    flow = (r.normal(size=(2, 2, 8, 12)) * 3).astype(np.float32)   # reaches past the border
    j = lambda f, *a, **k: np.asarray(f(*map(jnp.asarray, a), **k))
    assert rel(pimg.warp(torch.tensor(z0), torch.tensor(flow)), j(jimg.warp, z0, flow)) <= OP_TOL
    assert rel(pimg.flow_to_grid(torch.tensor(flow)), j(jimg.flow_to_grid, flow)) <= OP_TOL
    for radius, down, norm in ((2, 2, True), (1, 1, False)):
        got = pimg.cost_volume(torch.tensor(z0), torch.tensor(z1), radius, down, norm)
        assert got.shape == (2, (2 * radius + 1) ** 2, 8, 12)
        assert rel(got, j(jimg.cost_volume, z0, z1, radius, down, norm)) <= OP_TOL
    assert rel(pimg.l2_normalize(torch.tensor(z0)), j(jimg.l2_normalize, z0)) <= OP_TOL
