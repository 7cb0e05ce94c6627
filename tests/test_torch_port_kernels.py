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
                                       use_film=film)
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
    out = small_mha.small_mha_packed(torch.tensor(q), torch.tensor(k), torch.tensor(v), H)
    close(out, ref)
    close(out, twin)


def test_small_mha_packed_strided_views():
    """q/k/v as slices of one fused qkv tensor, as the transformer passes them."""
    r = np.random.default_rng(9)
    qkv = torch.tensor(r.normal(size=(B, 64, 3 * D)).astype(np.float32))
    q, k, v = qkv.split(D, dim=-1)
    ref = jsm._xla_attention(*(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)), H)
    close(small_mha.small_mha_packed(q, k, v, H), ref)


def _compose_block(x, args, film):
    """The block chain out of the GEMM wrapper, one call per epilogue, with
    the LN + FiLM and attention twins between them (csrc/fused_block.cu)."""
    gb1, gb2, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wout, bout, wff1, bff1, wff2, bff2 = args
    Bx, L, Dx = x.shape
    M = Bx * L
    rows = lambda t: t.reshape(M, -1)
    h = fused_block._ln_film(x, ln1s, ln1b, gb1 if film else None).to(x.dtype)
    qkv = fused_block.gemm_bias_act(rows(h), wqkv, bqkv, "bias").reshape(Bx, L, 3 * Dx)
    o = small_mha._torch_attention(*qkv.split(Dx, dim=-1), H)
    x2 = fused_block.gemm_bias_act(rows(o), wout, bout, "resid_f32", rows(x))
    h2 = fused_block._ln_film(x2.reshape(Bx, L, Dx), ln2s, ln2b, gb2 if film else None).to(x.dtype)
    f = fused_block.gemm_bias_act(rows(h2), wff1, bff1, "bias_silu")
    return fused_block.gemm_bias_act(f, wff2, bff2, "resid_out", x2).reshape(Bx, L, Dx)


@pytest.mark.parametrize("L", [8, 64])
@pytest.mark.parametrize("film", [True, False])
def test_gemm_twin_epilogues_compose_to_the_block(L, film):
    """f32 on the CPU: the four epilogues of the GEMM twin, chained as the
    CUDA chain chains its kernels, give `_torch_block`'s result bit for bit,
    and so the JAX fused_film_block's (Pallas kernel in interpret mode) within
    this file's f32 tolerance (atol 2e-5, rtol 1e-4: the same f32 math in
    another operation order)."""
    p = _block_params(L, seed=11 + L)
    x, args = torch.tensor(p["x"]), _torch_args(p)
    out = _compose_block(x, args, film)
    assert torch.equal(out, fused_block._torch_block(x, *args, n_heads=H, use_film=film))
    ref = jfb.fused_film_block(jnp.asarray(p["x"]), *[jnp.asarray(p[k]) for k in _ORDER],
                               n_heads=H, group_b=4, use_film=film, interpret=True)
    close(out, ref)


def test_gemm_twin_epilogues_compose_in_bf16():
    """With bf16 activations and matrices and f32 vectors (the trainers'
    types) the composition still equals `_torch_block` bit for bit: the GEMM
    twin rounds where the block twin rounds."""
    p = _block_params(64, seed=6)
    args = [t.to(torch.bfloat16) if k.startswith(("gb", "w")) else t
            for k, t in zip(_ORDER, _torch_args(p))]
    x = torch.tensor(p["x"]).to(torch.bfloat16)
    out = _compose_block(x, args, True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fused_block._torch_block(x, *args, n_heads=H, use_film=True))


@pytest.mark.parametrize("epilogue", fused_block.EPILOGUES)
def test_gemm_twin_output_types(epilogue):
    r = np.random.default_rng(3)
    a = torch.tensor(r.normal(size=(24, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.tensor(r.normal(size=(128, 64)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.tensor(r.normal(size=128).astype(np.float32))
    resid = {"resid_f32": torch.zeros((24, 128), dtype=torch.bfloat16),
             "resid_out": torch.zeros((24, 128))}.get(epilogue)
    out = fused_block.gemm_bias_act(a, w, bias, epilogue, resid)
    assert out.shape == (24, 128)
    assert out.dtype == (torch.float32 if epilogue == "resid_f32" else torch.bfloat16)
    fused_block._check_gemm(a, w, bias, epilogue, resid)   # a shape the CUDA kernel takes


@pytest.mark.parametrize("case", ["epilogue", "n", "k", "a_f32", "w_f32", "bias_shape",
                                  "bias_f16", "resid_missing", "resid_unwanted",
                                  "resid_dtype", "resid_shape", "strided", "ranks"])
def test_gemm_shape_checks_raise(case):
    """What the CUDA GEMM refuses raises ValueError before any launch (the
    check needs no card)."""
    bf = torch.bfloat16
    a, w, bias = torch.zeros((16, 128), dtype=bf), torch.zeros((64, 128), dtype=bf), torch.zeros(64)
    epilogue, resid = "bias", None
    if case == "epilogue":
        epilogue = "gelu"
    elif case == "n":
        w, bias = torch.zeros((96, 128), dtype=bf), torch.zeros(96)
    elif case == "k":
        a, w = torch.zeros((16, 96), dtype=bf), torch.zeros((64, 96), dtype=bf)
    elif case == "a_f32":
        a = a.float()
    elif case == "w_f32":
        w = w.float()
    elif case == "bias_shape":
        bias = torch.zeros(65)
    elif case == "bias_f16":
        bias = bias.half()
    elif case == "resid_missing":
        epilogue = "resid_out"
    elif case == "resid_unwanted":
        resid = torch.zeros((16, 64))
    elif case == "resid_dtype":
        epilogue, resid = "resid_f32", torch.zeros((16, 64))
    elif case == "resid_shape":
        epilogue, resid = "resid_out", torch.zeros((16, 65))
    elif case == "strided":
        a = torch.zeros((16, 256), dtype=bf)[:, ::2]
    elif case == "ranks":
        a = torch.zeros((2, 8, 128), dtype=bf)
    with pytest.raises(ValueError):
        fused_block._check_gemm(a, w, bias, epilogue, resid)


def _cuda_typed_block(L=8, d=64, f=128, masters=True):
    """Block tensors in the types the CUDA chain takes: bf16 x, FiLM rows and
    matrices (f32 masters if asked), f32 vectors."""
    bf = torch.bfloat16
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype)
    mat = torch.float32 if masters else bf
    args = [z(B, 2 * d, dtype=bf), z(B, 2 * d, dtype=bf), z(d), z(d), z(d), z(d),
            z(3 * d, d, dtype=mat), z(3 * d), z(d, d, dtype=mat), z(d), z(f, d, dtype=mat), z(f),
            z(d, f, dtype=mat), z(d)]
    return z(B, L, d, dtype=bf), args


def test_block_check_accepts_and_casts_masters():
    x, args = _cuda_typed_block()
    ins = fused_block._check_block(x, args, 2)
    assert len(ins) == 15 and all(t.is_contiguous() for t in ins)
    assert [t.dtype for t in ins[7::2]] == [torch.bfloat16] * 4      # the four matrices
    assert all(t.dtype == torch.float32 for t in ins[3:7])            # LN vectors as they are
    assert ins[0] is x                                                # nothing copied needlessly


@pytest.mark.parametrize("case", ["width", "ffn_width", "head_dim", "length", "x_f32",
                                  "film_f32", "mixed_vectors", "vectors_f16", "matrix_f16",
                                  "matrix_shape", "bias_shape"])
def test_block_shape_checks_raise(case):
    """What the CUDA chain refuses raises ValueError before any launch."""
    kw, heads = {}, 2
    if case == "width":
        kw = dict(d=96)
    elif case == "ffn_width":
        kw = dict(f=96)
    elif case == "head_dim":
        heads = 4           # 64 / 4 = 16
    elif case == "length":
        kw = dict(L=257)
    x, args = _cuda_typed_block(**kw)
    if case == "x_f32":
        x = x.float()
    elif case == "film_f32":
        args[0] = args[0].float()
    elif case == "mixed_vectors":
        args[7] = args[7].to(torch.bfloat16)
    elif case == "vectors_f16":
        args = [a.half() if a.dim() == 1 else a for a in args]
    elif case == "matrix_f16":
        args[6] = args[6].half()
    elif case == "matrix_shape":
        args[8] = args[8][:, :32]
    elif case == "bias_shape":
        args[9] = args[9][:32]
    with pytest.raises(ValueError):
        fused_block._check_block(x, args, heads)


def test_launch_counters_stay_zero_on_cpu():
    fused_block.fused_film_block.launches = small_mha.small_mha_packed.launches = 0
    fused_block.gemm_bias_act.launches = 0
    fused_block.fused_film_block.launches_by_len.clear()
    p = _block_params(8)
    fused_block.fused_film_block(torch.tensor(p["x"]), *_torch_args(p), n_heads=H)
    x = torch.tensor(p["x"])
    small_mha.small_mha_packed(x, x, x, H)
    fused_block.gemm_bias_act(x[0], torch.tensor(p["wout"]), torch.tensor(p["bout"]))
    assert fused_block.fused_film_block.launches == 0
    assert fused_block.fused_film_block.launches_by_len == {}
    assert fused_block.gemm_bias_act.launches == 0
    assert small_mha.small_mha_packed.launches == 0


def test_wrappers_raise_on_other_devices():
    """No silent path: a tensor neither on the CPU nor on CUDA raises."""
    x = torch.empty((B, 8, D), device="meta")
    with pytest.raises(ValueError):
        small_mha.small_mha_packed(x, x, x, H)
    p = _block_params(8)
    with pytest.raises(ValueError):
        fused_block.fused_film_block(x, *_torch_args(p, device="meta"), n_heads=H)
    with pytest.raises(ValueError):
        fused_block.gemm_bias_act(x[0], torch.empty((D, D), device="meta"),
                                  torch.empty(D, device="meta"))


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
                            "import optax", "from optax", "import msgpack", "from msgpack",
                            "from interpolated_diffusion_tpu.", "import interpolated_diffusion_tpu\n"):
                    assert bad not in src, f"{f}: {bad}"
