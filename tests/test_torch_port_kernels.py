"""Port kernels (interpolated_diffusion_tpu_torch.kernels) against the JAX
Pallas kernels, run in interpret mode as tests/test_fused_block.py runs them,
and against the JAX plain-XLA twins.

On the CPU each wrapper runs its plain PyTorch twin; the CUDA kernels run
only on the card, in tests/test_torch_port_gpu.py and chip_smoke.py. Sizes
are tests/test_fused_block.py's (B=8, D=48, H=4, F=96). Tolerance: f32 atol 2e-5 / rtol 1e-4 — the same f32 math, summed in
another order.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.kernels import fused_block as jfb
from interpolated_diffusion_tpu.kernels import small_mha as jsm
from interpolated_diffusion_tpu_torch.kernels import fused_block, small_mha

B, D, H, F = 8, 48, 4, 96
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(a, b, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def _block_params(L, seed=0):
    """Flax-layout block tensors (Dense kernels [in, out]) as numpy."""
    r = np.random.default_rng(seed)
    n = lambda *s, scale=1.0: (r.normal(size=s) * scale).astype(np.float32)
    return dict(
        x=n(B, L, D), gb1=n(B, 2 * D, scale=0.1), gb2=n(B, 2 * D, scale=0.1),
        ln1s=1 + n(D, scale=0.1), ln1b=n(D, scale=0.1),
        ln2s=1 + n(D, scale=0.1), ln2b=n(D, scale=0.1),
        wqkv=n(D, 3 * D, scale=D ** -0.5), bqkv=n(3 * D, scale=0.1),
        wout=n(D, D, scale=D ** -0.5), bout=n(D, scale=0.1),
        wff1=n(D, F, scale=D ** -0.5), bff1=n(F, scale=0.1),
        wff2=n(F, D, scale=F ** -0.5), bff2=n(D, scale=0.1))


_ORDER = ("gb1", "gb2", "ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv", "wout", "bout",
          "wff1", "bff1", "wff2", "bff2")


def _torch_args(p, device="cpu"):
    """Port argument order; Dense kernels transposed to the Linear layout."""
    return [torch.tensor(np.ascontiguousarray(p[k].T if k.startswith("w") else p[k]),
                         device=device) for k in _ORDER]


@pytest.mark.parametrize("L", [8, 64])
@pytest.mark.parametrize("group_b", [4, 3])
@pytest.mark.parametrize("film", [True, False])
def test_fused_film_block_matches_pallas_interpret(L, group_b, film):
    p = _block_params(L, seed=L + group_b)
    jargs = [jnp.asarray(p[k]) for k in _ORDER]
    ref = jfb.fused_film_block(jnp.asarray(p["x"]), *jargs, n_heads=H, group_b=group_b,
                               use_film=film, interpret=True)
    twin = jfb._xla_block(jnp.asarray(p["x"]), *jargs, n_heads=H, use_film=film)
    out = fused_block.fused_film_block(torch.tensor(p["x"]), *_torch_args(p), n_heads=H,
                                       group_b=group_b, use_film=film)
    assert out.shape == (B, L, D) and out.dtype == torch.float32
    close(out, ref)
    close(out, twin)


def test_fused_film_block_bf16_rounding_points():
    """In bf16 the port twin rounds where the JAX twin rounds (h, qkv, p, o,
    SiLU output; f32 residual): agreement within one bf16 ulp of |y|."""
    p = _block_params(64, seed=5)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jargs = [bf(p[k]) if k.startswith(("gb", "w")) else jnp.asarray(p[k]) for k in _ORDER]
    ref = np.asarray(jfb._xla_block(bf(p["x"]), *jargs, n_heads=H, use_film=True)
                     .astype(jnp.float32))
    targs = [t.to(torch.bfloat16) if k.startswith(("gb", "w")) else t
             for k, t in zip(_ORDER, _torch_args(p))]
    out = fused_block.fused_film_block(torch.tensor(p["x"]).to(torch.bfloat16), *targs,
                                       n_heads=H, use_film=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2 ** -7 * np.abs(ref).max(),
                               rtol=0)


@pytest.mark.parametrize("L", [8, 64])
@pytest.mark.parametrize("group_b", [4, 3])
def test_small_mha_packed_matches_pallas_interpret(L, group_b):
    r = np.random.default_rng(L * 10 + group_b)
    q, k, v = (r.normal(size=(B, L, D)).astype(np.float32) for _ in range(3))
    ref = jsm.small_mha_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, group_b,
                               interpret=True)
    twin = jsm._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H)
    out = small_mha.small_mha_packed(torch.tensor(q), torch.tensor(k), torch.tensor(v), H,
                                     group_b)
    close(out, ref)
    close(out, twin)


def test_small_mha_packed_strided_views():
    """q/k/v as slices of one fused qkv tensor, as the transformer passes them."""
    r = np.random.default_rng(9)
    qkv = torch.tensor(r.normal(size=(B, 64, 3 * D)).astype(np.float32))
    q, k, v = qkv.split(D, dim=-1)
    ref = jsm._xla_attention(*(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)), H)
    close(small_mha.small_mha_packed(q, k, v, H), ref)


def test_launch_counters_stay_zero_on_cpu():
    fused_block.fused_film_block.launches = small_mha.small_mha_packed.launches = 0
    p = _block_params(8)
    fused_block.fused_film_block(torch.tensor(p["x"]), *_torch_args(p), n_heads=H)
    x = torch.tensor(p["x"])
    small_mha.small_mha_packed(x, x, x, H)
    assert fused_block.fused_film_block.launches == 0
    assert small_mha.small_mha_packed.launches == 0


def test_wrappers_raise_on_other_devices():
    """No silent path: a tensor neither on the CPU nor on CUDA raises."""
    x = torch.empty((B, 8, D), device="meta")
    with pytest.raises(ValueError):
        small_mha.small_mha_packed(x, x, x, H)
    p = _block_params(8)
    with pytest.raises(ValueError):
        fused_block.fused_film_block(x, *_torch_args(p, device="meta"), n_heads=H)


def test_port_import_pulls_in_no_jax():
    code = ("import sys; import interpolated_diffusion_tpu_torch.sample.generate, "
            "interpolated_diffusion_tpu_torch.models.jax_import; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax')) "
            "or m == 'interpolated_diffusion_tpu' or m.startswith('interpolated_diffusion_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax():
    pkg = os.path.join(ROOT, "interpolated_diffusion_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                for bad in ("import jax", "from jax", "import flax", "from flax",
                            "import optax", "from optax",
                            "from interpolated_diffusion_tpu.", "import interpolated_diffusion_tpu\n"):
                    assert bad not in src, f"{f}: {bad}"
