"""Port modules against the recordings of the original PyTorch reference.

tests/golden/reference_golden.npz holds outputs produced by running the
reference (scripts/make_golden_reference.py) on fixed inputs. The four port
modules below are held to the same recordings as their JAX counterparts, at
the tolerances of tests/test_golden_parity.py (test_normalize,
test_frame_features, test_video_tokens_roundtrip, test_video_interp_helpers):
f32 on the CPU, so what differs is the order of a few f32 operations.
"""
import os

import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu_torch.ops.normalize import logit_pos, sigmoid_pos
from interpolated_diffusion_tpu_torch.ops.video_keyframes import (distance_alpha,
                                                                  interpolate_video_from_indices,
                                                                  smooth_latents)
from interpolated_diffusion_tpu_torch.utils.frame_features import frame_features_from_mask
from interpolated_diffusion_tpu_torch.utils.video_tokens import (patchify_latents,
                                                                 unpatchify_tokens)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_golden.npz")


@pytest.fixture(scope="module")
def g():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden file missing (run scripts/make_golden_reference.py)")
    return np.load(GOLDEN)


def t(a):
    return torch.from_numpy(np.asarray(a))


# name -> (function of the recordings, key of the recorded output, atol)
CASES = {
    "norm/logit": (lambda g: logit_pos(t(g["norm/x"])), "norm/logit", 1e-4),
    "norm/sigmoid": (lambda g: sigmoid_pos(logit_pos(t(g["norm/x"]))), "norm/sigmoid", 1e-5),
    "ff/with_time": (lambda g: frame_features_from_mask(t(g["ff/mask"]), include_time=True),
                     "ff/with_time", 1e-5),
    "ff/no_time": (lambda g: frame_features_from_mask(t(g["ff/mask"]), include_time=False),
                   "ff/no_time", 1e-5),
    "tok/tokens": (lambda g: patchify_latents(t(g["tok/latents"]), 2)[0], "tok/tokens", 1e-7),
    "tok/spatial": (lambda g: torch.tensor(patchify_latents(t(g["tok/latents"]), 2)[1]),
                    "tok/spatial", 0.0),
    "tok/roundtrip": (lambda g: unpatchify_tokens(*_tokens(g)), "tok/roundtrip", 1e-7),
    "video/distance_alpha": (lambda g: distance_alpha(t(g["interp/idx"]), 32),
                             "video/distance_alpha", 1e-6),
    "video/smooth": (lambda g: smooth_latents(t(g["video/z_flat"]), t(g["video/smooth_kernel"])),
                     "video/smooth", 1e-5),
    "video/interp_linear": (lambda g: interpolate_video_from_indices(
        t(g["interp/idx"]), t(g["video/vals6"]), 32, mode="linear"), "video/interp_linear", 1e-6),
    "video/interp_smooth": (lambda g: interpolate_video_from_indices(
        t(g["interp/idx"]), t(g["video/vals6"]), 32, mode="smooth",
        smooth_kernel=t(g["video/smooth_kernel"])), "video/interp_smooth", 1e-5),
}


def _tokens(g):
    tokens, spatial = patchify_latents(t(g["tok/latents"]), 2)
    return tokens, 2, spatial


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_reference_recording(g, name):
    fn, key, atol = CASES[name]
    out = fn(g).numpy()
    want = g[key]
    assert out.shape == want.shape
    np.testing.assert_allclose(out.astype(np.float64), want.astype(np.float64),
                               atol=atol, rtol=1e-5)
