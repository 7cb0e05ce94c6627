"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
mode). This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q

(--noconftest: tests/conftest.py sets up JAX for the CPU suite.) Shapes are
the bench's main path; tolerances are chip_smoke.py's, as max|kernel - twin|
over max|twin| in bf16: 2e-2 for the block, 1e-2 for the attention.
"""
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu_torch.kernels import fused_block, small_mha

D, H, F = 384, 12, 1536


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins are f32 references
    return torch.device("cuda")


def _block_args(B, L, film, device, seed=0, D=D, F=F):
    r = np.random.default_rng(seed)
    n = lambda *s, scale=1.0: torch.tensor((r.normal(size=s) * scale).astype(np.float32),
                                           device=device)
    gb = lambda: n(B, 2 * D, scale=0.1) if film else torch.zeros((B, 2 * D), device=device)
    args = (gb(), gb(), 1 + n(D, scale=0.1), n(D, scale=0.1), 1 + n(D, scale=0.1),
            n(D, scale=0.1), n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.1),
            n(D, D, scale=D ** -0.5), n(D, scale=0.1), n(F, D, scale=D ** -0.5),
            n(F, scale=0.1), n(D, F, scale=F ** -0.5), n(D, scale=0.1))
    return n(B, L, D).to(torch.bfloat16), tuple(a.to(torch.bfloat16) for a in args)


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,film,d,h,f", [
    (1024, 8, True, D, H, F), (1024, 64, True, D, H, F), (1, 8, True, D, H, F),
    (37, 64, True, D, H, F), (37, 8, False, D, H, F),
    # widths the 128-wide GEMM tile does not divide (N = 320, 960) and Dh = 64
    (64, 64, True, 320, 10, 1280), (64, 64, True, 384, 6, 1536)])
def test_fused_film_block_matches_twin(cuda, B, L, film, d, h, f):
    x, args = _block_args(B, L, film, cuda, D=d, F=f)
    before = fused_block.fused_film_block.launches
    with torch.inference_mode():
        out = fused_block.fused_film_block(x, *args, n_heads=h, use_film=film)
        ref = fused_block._torch_block(x, *args, n_heads=h, use_film=film)
    torch.cuda.synchronize()
    assert fused_block.fused_film_block.launches == before + 1
    assert out.shape == (B, L, d) and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("L,h", [(8, H), (64, H), (100, H), (256, H), (64, 6), (256, 6)])
def test_small_mha_packed_matches_twin(cuda, L, h):
    """h = 6 gives head dim 64; L = 256 with it is the largest shared-memory case."""
    g = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn((64, L, 3 * D), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    before = small_mha.small_mha_packed.launches
    with torch.inference_mode():
        out = small_mha.small_mha_packed(q, k, v, h)
        ref = small_mha._torch_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert small_mha.small_mha_packed.launches == before + 1
    assert _rel(out, ref) <= 1e-2


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn((2, 8, D), device=cuda)
    with pytest.raises(ValueError):          # f32 activations: the kernels take bf16
        small_mha.small_mha_packed(x, x, x, H)
    xb = x.to(torch.bfloat16).requires_grad_()
    with pytest.raises(RuntimeError):        # forward only
        small_mha.small_mha_packed(xb, xb, xb, H)
    with pytest.raises(ValueError):          # head dim 384 / 4 = 96 is not 32 or 64
        small_mha.small_mha_packed(xb.detach(), xb.detach(), xb.detach(), 4)
    xb, args = _block_args(2, 8, True, cuda)
    with pytest.raises(ValueError):          # f32 activations
        fused_block.fused_film_block(xb.float(), *args, n_heads=H)
    with pytest.raises(ValueError):          # f32 bias: the kernels take bf16 tensors
        fused_block.fused_film_block(xb, *args[:7], args[7].float(), *args[8:], n_heads=H)
