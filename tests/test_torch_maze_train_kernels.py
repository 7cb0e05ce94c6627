"""The maze kernels' entries under autograd, on the CPU in f32, against
`jax.grad` through the JAX functions.

The port's `small_mha`, `small_mha_packed` and `fused_film_block` are
autograd Functions whose backward recomputes the plain twin; on CPU tensors
the forward is the twin too. The JAX side runs the way its own tests run it
on the CPU: the Pallas kernels in interpret mode where they take the flag
(tests/test_small_mha.py, tests/test_fused_block.py), `small_mha` through its
XLA reference (it has no interpret flag). Inputs are made with numpy from a
seed. Tolerance 1e-5 (absolute, on outputs and gradients of O(1) values: f32
sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.kernels import fused_block as jfb
from interpolated_diffusion_tpu.kernels import small_mha as jsm
from interpolated_diffusion_tpu.models import transformer as jtr
from interpolated_diffusion_tpu_torch.kernels import fused_block, small_mha
from interpolated_diffusion_tpu_torch.models import transformer

TOL = 1e-5


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=tol, rtol=tol)


def _qkv(B, L, HD, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, L, HD)).astype(np.float32) for _ in range(4)]   # q, k, v, do


def _torch_vjp(fn, arrays, cot):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.tensor(cot), allow_unused=True)
    return out.detach().numpy(), [None if g is None else g.numpy() for g in grads]


@pytest.mark.parametrize("B,L,H,Dh", [(3, 64, 12, 8), (2, 8, 4, 16), (2, 300, 2, 8),
                                      (1, 1024, 1, 16),
                                      # the CUDA path's tiled kernel begins at L = 257; the
                                      # widest window is L = 1024 at H = 1
                                      (2, 257, 2, 8), (1, 257, 1, 32), (1, 1024, 1, 32)])
def test_small_mha_and_gradients_match_jax(B, L, H, Dh):
    q, k, v, do = _qkv(B, L, H * Dh, seed=L)
    out, grads = _torch_vjp(lambda a, b, c: small_mha.small_mha(a, b, c, H), (q, k, v), do)
    ref, vjp = jax.vjp(lambda a, b, c: jsm.small_mha(a, b, c, H), *map(jnp.asarray, (q, k, v)))
    close(out, ref)
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        close(g, r)


@pytest.mark.parametrize("B,L,H,Dh,G", [(5, 64, 12, 8, 2), (4, 32, 12, 8, 4), (3, 100, 4, 16, 2)])
def test_small_mha_packed_and_gradients_match_jax_interpret(B, L, H, Dh, G):
    q, k, v, do = _qkv(B, L, H * Dh, seed=L + 1)
    out, grads = _torch_vjp(lambda a, b, c: small_mha.small_mha_packed(a, b, c, H),
                            (q, k, v), do)
    ref, vjp = jax.vjp(lambda a, b, c: jsm.small_mha_packed(a, b, c, H, G, True),
                       *map(jnp.asarray, (q, k, v)))
    close(out, ref)
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        close(g, r)


def _block_arrays(B, L, D, H, F, seed):
    r = np.random.default_rng(seed)
    n = lambda *s, scale=1.0: (r.normal(size=s) * scale).astype(np.float32)
    # JAX layout: kernels [in, out]
    return dict(x=n(B, L, D), gb1=n(B, 2 * D, scale=0.1), gb2=n(B, 2 * D, scale=0.1),
                ln1s=1 + n(D, scale=0.1), ln1b=n(D, scale=0.1), ln2s=1 + n(D, scale=0.1),
                ln2b=n(D, scale=0.1), wqkv=n(D, 3 * D, scale=D ** -0.5), bqkv=n(3 * D, scale=0.1),
                wout=n(D, D, scale=D ** -0.5), bout=n(D, scale=0.1),
                wff1=n(D, F, scale=D ** -0.5), bff1=n(F, scale=0.1),
                wff2=n(F, D, scale=F ** -0.5), bff2=n(D, scale=0.1), dy=n(B, L, D))


_MATS = ("wqkv", "wout", "wff1", "wff2")
_ORDER = ("x", "gb1", "gb2", "ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv", "wout", "bout",
          "wff1", "bff1", "wff2", "bff2")


@pytest.mark.parametrize("L,film,interpret", [(64, True, True), (8, True, True),
                                              (16, False, True), (64, True, False)])
def test_fused_film_block_and_gradients_match_jax(L, film, interpret):
    """interpret=True runs the Pallas kernel in interpret mode (forward) with
    the custom_vjp backward; False runs the JAX package's XLA twin."""
    B, D, H, F, G = 4, 48, 4, 96, 2
    a = _block_arrays(B, L, D, H, F, seed=L)
    # the port takes torch's [out, in] weight layout
    t_in = [a[n].T.copy() if n in _MATS else a[n] for n in _ORDER]
    out, grads = _torch_vjp(
        lambda *t: fused_block.fused_film_block(*t, n_heads=H, use_film=film),
        t_in, a["dy"])
    ref, vjp = jax.vjp(
        lambda *j: jfb.fused_film_block(*j, H, G, film, interpret),
        *[jnp.asarray(a[n]) for n in _ORDER])
    close(out, ref)
    for name, g, r in zip(_ORDER, grads, vjp(jnp.asarray(a["dy"]))):
        r = np.asarray(r)
        if g is None:          # FiLM rows without FiLM: no path, JAX gives zeros
            assert not film and name in ("gb1", "gb2") and not r.any()
            continue
        close(g, r.T if name in _MATS else r)


def test_functions_take_no_grad_inputs_without_autograd():
    """Inputs that need no gradient go straight to the forward (no Function
    node), and only the inputs that need one get one."""
    q, k, v, do = _qkv(2, 8, 16, seed=0)
    tq, tk, tv = torch.tensor(q, requires_grad=True), torch.tensor(k), torch.tensor(v)
    out = small_mha.small_mha_packed(tq, tk, tv, 2)
    out.backward(torch.tensor(do))
    assert tq.grad is not None and tk.grad is None and tv.grad is None
    assert small_mha.small_mha(tk, tk, tv, 2).grad_fn is None


def _jax_block_and_inputs(D, H, F, B, L, d_cond, use_small_mha, seed):
    blk = jtr.TransformerBlock(d_model=D, n_heads=H, d_ff=F, use_small_mha=use_small_mha)
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, L, D)).astype(np.float32)
    cond = r.normal(size=(B, d_cond)).astype(np.float32)
    params = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(cond))["params"]
    # flax zero-initialises biases: randomise every leaf
    params = jax.tree.map(lambda p: np.asarray(p) + 0.1 * r.normal(size=p.shape).astype(np.float32),
                          params)
    return blk, params, x, cond


def _port_block(params, D, H, F, d_cond, **kw):
    from interpolated_diffusion_tpu_torch.models.jax_import import _block

    sd = {}
    _block(sd, "", params)
    blk = transformer.TransformerBlock(D, H, F, d_cond, **kw)
    blk.load_state_dict(sd, strict=True)
    return blk


@pytest.mark.parametrize("L,H", [(64, 4), (8, 4), (300, 2)])
def test_transformer_block_use_small_mha_matches_jax(L, H, monkeypatch):
    """`use_small_mha=True` takes the small_mha route before the packed
    window is tried, as the JAX block does (H*L <= 1024), and gives the JAX
    block's output and parameter gradients."""
    monkeypatch.delenv("ID_TPU_ATTN_TUNE", raising=False)
    monkeypatch.delenv("ID_TPU_SMALL_ATTN", raising=False)
    D, F, B, d_cond = 32, 64, 3, 16
    jblk, params, x, cond = _jax_block_and_inputs(D, H, F, B, L, d_cond, True, seed=L)
    blk = _port_block(params, D, H, F, d_cond, use_small_mha=True)
    calls = []
    monkeypatch.setattr(transformer, "small_mha",
                        lambda *a: calls.append(1) or small_mha.small_mha(*a))
    monkeypatch.setattr(transformer, "small_mha_packed",
                        lambda *a: pytest.fail("packed route taken with use_small_mha"))
    tx = torch.tensor(x, requires_grad=True)
    out = blk(tx, torch.tensor(cond))
    assert calls == [1]
    loss_j = lambda p, xx: (jblk.apply({"params": p}, xx, jnp.asarray(cond)) ** 2).sum()
    close(out.detach(), jblk.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond)),
          tol=2e-5)
    gp, gx = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))
    (out ** 2).sum().backward()
    scale = float(np.abs(np.asarray(gx)).max())
    close(tx.grad / scale, np.asarray(gx) / scale, tol=2e-5)
    from interpolated_diffusion_tpu_torch.models.jax_import import _block

    want = {}
    _block(want, "", jax.tree.map(np.asarray, gp))
    for name, p in blk.named_parameters():
        s = max(float(want[name].abs().max()), 1e-12)
        close(p.grad / s, want[name] / s, tol=2e-5)


def test_transformer_block_small_mha_window(monkeypatch):
    """Outside H*L <= 1024 the opt-in is ignored and the policy decides."""
    blk = transformer.TransformerBlock(32, 4, 64, 16, attn_policy="dense", use_small_mha=True)
    monkeypatch.setattr(transformer, "small_mha", lambda *a: pytest.fail("outside the window"))
    with torch.no_grad():
        out = blk(torch.zeros(1, 300, 32), torch.zeros(1, 16))
    assert out.shape == (1, 300, 32)
