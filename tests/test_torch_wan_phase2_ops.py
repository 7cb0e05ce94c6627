"""The Wan Phase-2 pieces of the port against the JAX package on the CPU:
the video corruption batch builders (ops/video_keyframes.py) under JAX's own
draws, FORA block caching on WanDiT (blocks_delta / return_delta), the
merged LoRA form (models/lora.py), and the Wan2.1 weight converter with its
safetensors reader (models/wan_convert.py, utils/safetensors.py).

Tolerances, as max|port - jax| / max|jax| unless stated:
  - 1e-5 for the batch builders: the same f32 lerp, noise and gathers;
  - 1e-4 for WanDiT forwards and gradients in f32 with dense attention (the
    same arithmetic, other sum order);
  - exact where no arithmetic differs: masks, indices, confidences, the
    converter's maps, bf16 merges, the safetensors round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from interpolated_diffusion_tpu.models import lora as jlora
from interpolated_diffusion_tpu.models import wan_convert as jconvert
from interpolated_diffusion_tpu.models.wan_dit import WanDiT as JWanDiT
from interpolated_diffusion_tpu.ops import video_keyframes as jvk
from interpolated_diffusion_tpu.ops.keyframes import compute_k_schedule
from interpolated_diffusion_tpu_torch.models import lora as plora
from interpolated_diffusion_tpu_torch.models.init import build_model
from interpolated_diffusion_tpu_torch.models import wan_convert as pconvert
from interpolated_diffusion_tpu_torch.models.jax_import import wan_params_to_state_dict
from interpolated_diffusion_tpu_torch.models.wan_dit import WanDiT
from interpolated_diffusion_tpu_torch.ops import video_keyframes as pvk
from interpolated_diffusion_tpu_torch.train import wansynth_common as pcommon
from interpolated_diffusion_tpu_torch.utils.safetensors import read_safetensors, write_safetensors

TINY = dict(dim=48, n_layers=2, n_heads=4, ffn_dim=96, in_channels=4, out_channels=4,
            text_dim=32)
BUILD_TOL, F32_TOL = 1e-5, 1e-4


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# corruption batch builders
# ---------------------------------------------------------------------------

def jax_draws(key, B, T, D, K_min, levels, adjacent):
    """The draws JAX's builders take from `key`, in the layout of
    make_video_interp_draws (the same key splits as the JAX builders)."""
    k_masks, k_s, k_lvls = jax.random.split(key, 3)
    lvl_keys = jax.random.split(k_lvls, levels + 1)
    K_list = compute_k_schedule(T, K_min, levels)
    per = {}
    for s in range(0 if adjacent else 1, levels + 1):
        k_rep, k_na, k_n = jax.random.split(lvl_keys[s], 3)
        per[s] = {"rep": _t(jax.random.uniform(k_rep, (B, K_list[s]))),
                  "noise_a": _t(jax.random.normal(k_na, (B, K_list[s], D))),
                  "noise": _t(jax.random.normal(k_n, (B, T, D)))}
    return {"mask_rand": _t(jax.random.uniform(k_masks, (B, T - 2))),
            "s_idx": _t(jax.random.randint(k_s, (B,), 1, levels + 1)), "levels": per}


def _anchors(rng, B, T, D, Ka=3):
    idx = np.sort(np.stack([rng.choice(T, Ka, replace=False) for _ in range(B)]), axis=1)
    return rng.normal(size=(B, Ka, D)).astype(np.float32), idx.astype(np.int32)


BUILDERS = ["level", "adjacent", "token_level", "token_adjacent"]


@pytest.mark.parametrize("corrupt_mode", ["none", "gauss", "dist"])
@pytest.mark.parametrize("builder", BUILDERS)
def test_batch_builders_match_jax_under_jax_draws(builder, corrupt_mode):
    rng = np.random.default_rng(3 * BUILDERS.index(builder) + ["none", "gauss", "dist"].index(
        corrupt_mode))
    B, T, N, Dt, K_min, levels = 3, 11, 3, 2, 3, 2
    token = builder.startswith("token")
    z0 = rng.normal(size=(B, T, N, Dt) if token else (B, T, N * Dt)).astype(np.float32)
    av, ai = _anchors(rng, B, T, N * Dt)
    if token:
        av = av.reshape(B, -1, N, Dt)
    kw = dict(corrupt_mode=corrupt_mode, corrupt_sigma=0.3, anchor_noise_frac=0.25,
              student_replace_prob=0.6, student_noise_std=0.1, clamp_endpoints=False,
              interp_mode="smooth" if corrupt_mode == "dist" else "linear")
    if corrupt_mode != "none":   # the Phase-1 anchor join on two of the three modes
        kw.update(anchor_values=av, anchor_idx=ai)
    adjacent = builder.endswith("adjacent")
    fn = {"level": "build_video_interp_level_batch",
          "adjacent": "build_video_interp_adjacent_batch",
          "token_level": "build_video_token_interp_level_batch",
          "token_adjacent": "build_video_token_interp_adjacent_batch"}[builder]
    key = jax.random.PRNGKey(7)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = getattr(jvk, fn)(key, jnp.asarray(z0), K_min, levels, **jkw)
    draws = jax_draws(key, B, T, N * Dt, K_min, levels, adjacent)
    pkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = getattr(pvk, fn)(draws, _t(z0), K_min, levels, **pkw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, list):     # idx_levels
            for gi, ri in zip(g, r):
                np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
            continue
        r = np.asarray(r)
        g = g.numpy()
        assert g.shape == r.shape
        if r.dtype.kind in "bi":
            np.testing.assert_array_equal(g, r)
        else:
            assert rel_err(g, r) <= BUILD_TOL


@pytest.mark.parametrize("full_grid", [False, True])
def test_gather_anchor_values_matches_jax(full_grid):
    rng = np.random.default_rng(3)
    B, T, D = 4, 9, 5
    if full_grid:
        av, ai = rng.normal(size=(B, T, D)).astype(np.float32), None
    else:
        av, ai = _anchors(rng, B, T, D, Ka=4)
    idx = np.sort(np.stack([rng.choice(T, 3, replace=False) for _ in range(B)]), 1)
    rv, rvalid = jvk._gather_anchor_values(jnp.asarray(av), None if ai is None else jnp.asarray(ai),
                                           jnp.asarray(idx), T)
    gv, gvalid = pvk._gather_anchor_values(_t(av), None if ai is None else _t(ai), _t(idx), T)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(rvalid))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("clamp,frac", [(True, 0.25), (False, 1.0)])
def test_level_interp_matches_jax_with_endpoint_clamp_and_full_anchor_noise(clamp, frac):
    """One level without anchor values (noisy-teacher students), the endpoint
    clamp of the confidence map and anchor_noise_frac 1."""
    rng = np.random.default_rng(5)
    B, T, D = 3, 10, 6
    z0 = rng.normal(size=(B, T, D)).astype(np.float32)
    idx = np.array([[0, 3, 9], [0, 5, 9], [0, 1, 9]], np.int32)
    mask = np.zeros((B, T), bool)
    np.put_along_axis(mask, idx, True, axis=1)
    key = jax.random.PRNGKey(11)
    opts = dict(jvk._DEFAULTS, corrupt_mode="gauss", corrupt_sigma=0.2, anchor_noise_frac=frac,
                student_replace_prob=0.7, student_noise_std=0.3, clamp_endpoints=clamp)
    ref = jvk._level_video_interp(key, jnp.asarray(z0), jnp.asarray(idx), jnp.asarray(mask), T,
                                  **opts)
    k_rep, k_na, k_n = jax.random.split(key, 3)
    draws = {"rep": _t(jax.random.uniform(k_rep, (B, 3))),
             "noise_a": _t(jax.random.normal(k_na, (B, 3, D))),
             "noise": _t(jax.random.normal(k_n, (B, T, D)))}
    opts.pop("interp_fn")
    got = pvk._level_video_interp(_t(z0), _t(idx), _t(mask), T, draws, **opts)
    assert rel_err(got[0].numpy(), ref[0]) <= BUILD_TOL
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_make_video_interp_draws_shapes():
    g = torch.Generator().manual_seed(0)
    d = pvk.make_video_interp_draws(g, 2, 21, 7, 5, 2, adjacent=True)
    assert d["mask_rand"].shape == (2, 19) and set(d["levels"]) == {0, 1, 2}
    assert [d["levels"][s]["rep"].shape[1] for s in range(3)] == compute_k_schedule(21, 5, 2)
    assert int(d["s_idx"].min()) >= 1 and int(d["s_idx"].max()) <= 2
    assert set(pvk.make_video_interp_draws(g, 2, 21, 7, 5, 2, adjacent=False)["levels"]) == {1, 2}


# ---------------------------------------------------------------------------
# WanDiT: FORA block caching, the merged LoRA form
# ---------------------------------------------------------------------------

def _jax_wan(seed, **over):
    cfg = dict(TINY, **over)
    r = np.random.default_rng(seed)
    lat = r.normal(size=(2, 4, 3, 8, 8)).astype(np.float32)
    t = np.array([900, 40], np.int32)
    ctx = r.normal(size=(2, 5, 32)).astype(np.float32)
    fi = np.array([[0, 4, 9], [1, 2, 8]], np.int32)
    jm = JWanDiT(attn_mode="dense", layer_mode="loop", dtype=jnp.float32, **cfg)
    params = jm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, (lat, t, ctx, fi)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, (lat, t, ctx, fi)


def test_fora_blocks_delta_reproduces_the_forward_and_matches_jax():
    jm, params, inputs = _jax_wan(1)
    j_out, j_delta = jm.apply({"params": params}, *map(jnp.asarray, inputs), return_delta=True)
    j_cached = jm.apply({"params": params}, *map(jnp.asarray, inputs), blocks_delta=j_delta)
    sd, _ = wan_params_to_state_dict(params)
    pm = WanDiT(attn_mode="dense", **TINY).eval()
    pm.load_state_dict(sd, strict=True)
    lat, t, ctx, fi = map(_t, inputs)
    with torch.no_grad():
        out = pm(lat, t, ctx, fi)
        out2, delta = pm(lat, t, ctx, fi, return_delta=True)
        cached = pm(lat, t, ctx, fi, blocks_delta=delta)
    assert torch.equal(out, out2)
    assert rel_err(cached.numpy(), out.numpy()) <= 1e-5
    assert delta.shape == (2, 3 * 4 * 4, TINY["dim"])
    assert rel_err(delta.numpy(), j_delta) <= F32_TOL
    assert rel_err(out.numpy(), j_out) <= F32_TOL
    # the cached step on JAX's residual against JAX's cached step
    with torch.no_grad():
        cached_j = pm(lat, t + 5, ctx, fi, blocks_delta=_t(np.asarray(j_delta)))
    j_cached5 = jm.apply({"params": params}, jnp.asarray(inputs[0]), jnp.asarray(inputs[1] + 5),
                         *map(jnp.asarray, inputs[2:]), blocks_delta=j_delta)
    assert rel_err(cached_j.numpy(), j_cached5) <= F32_TOL
    assert rel_err(np.asarray(j_cached), j_out) <= 1e-5


@pytest.mark.parametrize("group", [1, 2])
def test_remat_group_gives_the_same_gradients(group):
    pm = build_model(WanDiT, generator=torch.Generator().manual_seed(0), zero_init_scale=0.1,
                     attn_mode="dense", lora_rank=2, **TINY)
    ref = build_model(WanDiT, generator=torch.Generator().manual_seed(1), attn_mode="dense",
                      lora_rank=2, **TINY)
    ref.load_state_dict(pm.state_dict())
    pm.use_remat, pm.remat_group = True, group
    lat, t, ctx = torch.randn(2, 4, 3, 8, 8), torch.tensor([5, 600]), torch.randn(2, 5, 32)
    grads = []
    for m in (pm, ref):
        m.zero_grad()
        (m(lat, t, ctx) ** 2).sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _lora_tree(params, rank, seed):
    tree = jlora.init_lora(jax.random.PRNGKey(seed), params, rank, 8.0,
                           filter_regex="(q_proj|k_proj|v_proj|o_proj|ffn_in|ffn_out)")
    r = np.random.default_rng(seed)
    return {k: {"A": np.asarray(v["A"]), "B": r.normal(size=v["B"].shape).astype(np.float32) * 0.1}
            for k, v in tree.items()}


def test_merged_lora_matches_jax_apply_lora_forward_and_gradients():
    jm, params, inputs = _jax_wan(2)
    tree = _lora_tree(params, 2, 3)
    w = np.random.default_rng(4).normal(size=(2, 4, 3, 8, 8)).astype(np.float32)

    def jloss(tr):
        merged = jlora.apply_lora(params, tr, 2, 8.0)
        return jnp.sum(jm.apply({"params": merged}, *map(jnp.asarray, inputs)) * w)

    j_loss, j_grads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, tree))
    sd, _ = wan_params_to_state_dict(params)
    pm = WanDiT(attn_mode="dense", lora_rank=2, lora_alpha=8.0, lora_form="merged", **TINY)
    leaves = plora.tree_to_leaves({k: {n: _t(a) for n, a in v.items()} for k, v in tree.items()})
    pm.load_state_dict({**sd, **leaves}, strict=True)
    lora, base = pcommon.split_lora_state_dict(dict(pm.named_parameters()))
    for p in base.values():
        p.requires_grad_(False)
    loss = (pm(*map(_t, inputs)) * _t(w)).sum()
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= F32_TOL * abs(float(j_loss))
    assert all(p.grad is None for p in base.values())
    got = plora.leaves_to_tree({k: p.grad for k, p in lora.items()})
    assert set(got) == set(tree) == set(plora.lora_param_names(tree))
    for path in tree:
        for leaf in ("A", "B"):
            assert rel_err(got[path][leaf].numpy(), j_grads[path][leaf]) <= F32_TOL, (path, leaf)
    # merged against runtime on the same A, B, and against a merged state_dict
    rt = WanDiT(attn_mode="dense", lora_rank=2, lora_alpha=8.0, lora_form="runtime", **TINY)
    rt.load_state_dict(pm.state_dict())
    plain = WanDiT(attn_mode="dense", **TINY)
    plain.load_state_dict(plora.apply_lora(sd, {k: {n: _t(a) for n, a in v.items()}
                                                for k, v in tree.items()}, 2, 8.0))
    with torch.no_grad():
        ref = pm(*map(_t, inputs))
        assert rel_err(rt(*map(_t, inputs)).numpy(), ref.numpy()) <= 1e-5
        assert rel_err(plain(*map(_t, inputs)).numpy(), ref.numpy()) <= 1e-5


def test_apply_lora_rounds_the_merge_as_jax_under_bf16():
    _, params, _ = _jax_wan(5)
    tree = _lora_tree(params, 4, 6)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    ref = jlora.apply_lora(bf, jax.tree_util.tree_map(jnp.asarray, tree), 4, 16.0)
    sd = {k: v.to(torch.bfloat16) for k, v in wan_params_to_state_dict(params)[0].items()}
    got = plora.apply_lora(sd, {k: {n: _t(a) for n, a in v.items()} for k, v in tree.items()},
                           4, 16.0)
    for path in tree:
        name = plora.port_module(path) + ".weight"
        assert got[name].dtype == torch.bfloat16
        kernel = traverse_util.flatten_dict(ref)[tuple(path.split("/")) + ("kernel",)]
        want = torch.from_numpy(np.asarray(kernel.astype(jnp.float32)).T.copy())
        assert torch.equal(got[name].float(), want), path


def test_lora_paths_map_both_ways_and_init_matches_jax_shapes():
    _, params, _ = _jax_wan(7)
    sd, _ = wan_params_to_state_dict(params)
    jtree = jlora.init_lora(jax.random.PRNGKey(0), params, 3)
    ptree = plora.init_lora(torch.Generator().manual_seed(0), sd, 3)
    assert set(ptree) == set(jtree)
    for path in jtree:
        assert plora.jax_path(plora.port_module(path)) == path
        assert tuple(ptree[path]["A"].shape) == jtree[path]["A"].shape
        assert tuple(ptree[path]["B"].shape) == jtree[path]["B"].shape
        assert not ptree[path]["B"].any()
    with pytest.raises(ValueError, match="no kernels matched"):
        plora.init_lora(torch.Generator(), sd, 2, filter_regex="nothing_here")


# ---------------------------------------------------------------------------
# Wan2.1 weights: the converter and the safetensors reader
# ---------------------------------------------------------------------------

def _diffusers_sd():
    _, params, inputs = _jax_wan(9)
    return params, inputs, jconvert.export_wan_state_dict(params, (1, 2, 2), in_channels=4)


def test_convert_matches_the_jax_map_and_round_trips():
    params, _, sd = _diffusers_sd()
    got = pconvert.convert_wan_state_dict(sd)
    want, _ = wan_params_to_state_dict(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # the row flip: diffusers' [cos | sin] columns become the port's [sin | cos]
    w = sd[pconvert.TIME_FC1]
    half = w.shape[1] // 2
    np.testing.assert_array_equal(got[pconvert.TIME_FC1].numpy()[:, :half], w[:, half:])
    back = pconvert.export_wan_state_dict(got)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_convert_is_strict_on_unknown_and_i2v_keys():
    _, _, sd = _diffusers_sd()
    i2v = dict(sd, **{"blocks.0.attn2.add_k_proj.weight": np.zeros((4, 4), np.float32)})
    with pytest.raises(ValueError, match="I2V"):
        pconvert.convert_wan_state_dict(i2v)
    unknown = dict(sd, **{"blocks.0.attn1.extra.weight": np.zeros((4, 4), np.float32)})
    with pytest.raises(ValueError, match="does not have"):
        pconvert.convert_wan_state_dict(unknown)
    for bad in (i2v, unknown):
        assert set(pconvert.convert_wan_state_dict(bad, strict=False)) == set(
            pconvert.convert_wan_state_dict(sd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_safetensors_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    tensors = {"a.weight": torch.randn(5, 3, generator=g).to(dtype),
               "b": torch.randn(2, 2, 4, generator=g).to(dtype),
               "idx": torch.arange(7, dtype=torch.int64), "scalar": torch.tensor(3.5)}
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, tensors, metadata={"format": "pt"})
    got = read_safetensors(path)
    assert set(got) == set(tensors)
    for k in tensors:
        assert got[k].dtype == tensors[k].dtype and torch.equal(got[k], tensors[k]), k
    raw = open(path, "rb").read()
    n = int.from_bytes(raw[:8], "little")
    assert (8 + n) % 8 == 0 and b'"BF16"' in raw[8:8 + n] if dtype == torch.bfloat16 else True
    try:   # the reference implementation reads the file too, when it is installed
        from safetensors.torch import load_file, save_file
    except ImportError:
        return
    ref = load_file(path)
    assert all(torch.equal(ref[k], tensors[k]) for k in tensors)
    other = str(tmp_path / "y.safetensors")
    save_file(tensors, other)
    assert all(torch.equal(read_safetensors(other)[k], tensors[k]) for k in tensors)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wan_pretrained_loads_a_synthetic_checkpoint(tmp_path, dtype):
    """--wan_pretrained: a diffusers-named safetensors file (one shard in a
    directory) becomes the base of build_wan's model; LoRA leaves keep their
    values; the forward equals JAX's on the same weights (f32) or on the
    bf16-rounded weights within bf16's step (bf16 file)."""
    params, inputs, sd = _diffusers_sd()
    d = tmp_path / "wan"
    d.mkdir()
    write_safetensors(str(d / "model-00001.safetensors"),
                      {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in sd.items()})
    ns = pcommon.wan_args_from_meta(dict(wan_dim=48, wan_layers=2, wan_heads=4, wan_ffn=96,
                                         latent_c=4, text_dim=32, T=3, lora_rank=2,
                                         lora_form="runtime", frame_cond=0),
                                    wan_pretrained=str(d))
    wan, _ = pcommon.build_wan(ns, False, generator=torch.Generator().manual_seed(0))
    lora_before = {k: v.clone() for k, v in wan.state_dict().items() if "lora" in k}
    got = wan.state_dict()
    for k, v in pconvert.convert_wan_state_dict(
            {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in sd.items()}).items():
        assert torch.equal(got[k], v.float()), k
    assert all(torch.equal(got[k], v) for k, v in lora_before.items())
    jm = JWanDiT(attn_mode="dense", layer_mode="loop", dtype=jnp.float32, **TINY)
    jparams = params if dtype == torch.float32 else jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), params)
    ref = jm.apply({"params": jparams}, *map(jnp.asarray, inputs))
    with torch.no_grad():
        for p in (m for n, m in wan.named_parameters() if n.endswith("lora_B")):
            p.zero_()
        out = wan(*map(_t, inputs))
    assert rel_err(out.numpy(), ref) <= F32_TOL
    # a checkpoint with a third block: its tensors name no parameter of the model
    write_safetensors(str(d / "model-00002.safetensors"),
                      {k.replace("blocks.1.", "blocks.2."): torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items() if k.startswith("blocks.1.")})
    with pytest.raises(ValueError, match="not in model"):
        pcommon.load_pretrained_into(wan, ns)
