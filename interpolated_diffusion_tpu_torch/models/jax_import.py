"""JAX (flax) params -> port state_dicts, and the trainable leaves back.

`params_to_state_dict` is the inverse of interpolated_diffusion_tpu/models/
torch_import.py::convert_state_dict for the two maze denoisers (causal or
not: the causal mask has no parameters); `selector_to_state_dict` and
`segment_cost_to_state_dict` invert its convert_keypoint_selector and
convert_segment_cost; `wan_params_to_state_dict` converts a WanDiT (and
FrameCondProjector) tree and `lora_params_to_state_dict` a Wan trainer's LoRA
tree; `module_tree_to_state_dict` converts the modules that keep the flax
names, `tiny_interpolator_to_state_dict` the temporal-conv interpolator
(depthwise kernel [k, 1, D] -> Conv1d weight [D, 1, k]) and
`sd_vae_params_to_state_dict` an SDVAE (to the diffusers names).
`checkpoint_to_state_dict` picks the converter from a checkpoint's meta
(utils/jax_checkpoint.py reads the trees).
`lora_to_params` / `frame_cond_to_params` go the other way for the leaves the
Wan trainer updates (values or gradients), so that a test compares them with
the JAX trees leaf by leaf. All take or give param trees with numpy (or
array-like) leaves, so they need no JAX:

  Dense kernel [in, out]         -> Linear weight [out, in]
  Conv kernel [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  qkv Dense                      -> attn.in_proj_weight / in_proj_bias
                                    (rows [q; k; v], each split H x Dh)
  Embed embedding                -> Embedding weight, as it is
  LayerNorm scale / bias         -> weight / bias
  MultiHeadDotProductAttention   -> attn.in_proj_weight / in_proj_bias
    query/key/value [d, H, Dh]      (rows [q; k; v]) and attn.out_proj
    out [H, Dh, d]
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _linear(sd: Dict[str, torch.Tensor], prefix: str, p: Params) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd, prefix: str, p: Params) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix: str, p: Params) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _cond_enc(sd, p: Params) -> None:
    maze = p["maze"]
    n_convs = sum(1 for k in maze if k.startswith("conv_"))
    for n in range(n_convs):
        _conv(sd, f"cond_enc.maze.convs.{2 * n}", maze[f"conv_{n}"])
    _linear(sd, "cond_enc.maze.fc", maze["fc"])
    if "sg" in p:
        _linear(sd, "cond_enc.sg.mlp.0", p["sg"]["fc1"])
        _linear(sd, "cond_enc.sg.mlp.2", p["sg"]["fc2"])


def _block(sd, pre: str, blk: Params) -> None:
    """One TransformerBlock; `pre` is the key prefix ("" for a bare block)."""
    _layernorm(sd, f"{pre}norm1", blk["norm1"])
    _layernorm(sd, f"{pre}norm2", blk["norm2"])
    sd[f"{pre}attn.in_proj_weight"] = _t(np.asarray(blk["qkv"]["kernel"]).T)
    sd[f"{pre}attn.in_proj_bias"] = _t(blk["qkv"]["bias"])
    _linear(sd, f"{pre}attn.out_proj", blk["attn_out"])
    _linear(sd, f"{pre}ff.0", blk["ff1"])
    _linear(sd, f"{pre}ff.2", blk["ff2"])
    if "film1" in blk:
        _linear(sd, f"{pre}film1", blk["film1"])
        _linear(sd, f"{pre}film2", blk["film2"])


def _transformer(sd, p: Params) -> None:
    n_layers = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layers):
        _block(sd, f"transformer.layers.{i}.", p[f"block_{i}"])


_KINDS = ("keypoint", "interp", "video_keypoint", "video_interp")


def params_to_state_dict(params: Params, kind: str) -> Dict[str, torch.Tensor]:
    """flax params of a KeypointDenoiser ("keypoint"), InterpLevelDenoiser
    ("interp"), VideoTokenKeypointDenoiser ("video_keypoint") or
    VideoTokenInterpLevelDenoiser ("video_interp") -> state_dict of the
    port's module of the same name (the video denoisers' text encoder
    text_enc/fc{1,2} -> cond_enc.proj.{0,2})."""
    if kind not in _KINDS:
        raise ValueError(f"unknown model kind {kind!r}; one of {list(_KINDS)}")
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "in_proj", params["in_proj"])
    if kind.endswith("keypoint"):
        _linear(sd, "t_embed.0", params["t_fc1"])
        _linear(sd, "t_embed.2", params["t_fc2"])
    else:
        sd["level_emb.weight"] = _t(params["level_emb"]["embedding"])
        _linear(sd, "level_proj.0", params["lvl_fc1"])
        _linear(sd, "level_proj.2", params["lvl_fc2"])
    if "cond_enc" in params:
        _cond_enc(sd, params["cond_enc"])
    if "text_enc" in params:
        _linear(sd, "cond_enc.proj.0", params["text_enc"]["fc1"])
        _linear(sd, "cond_enc.proj.2", params["text_enc"]["fc2"])
    _linear(sd, "cond_proj", params["cond_proj"])
    _transformer(sd, params["transformer"])
    _linear(sd, "out", params["out"])
    return sd


# ---------------------------------------------------------------------------
# WanDiT
# ---------------------------------------------------------------------------

_WAN_TOP = (("time_fc1", "condition_embedder.time_embedder.linear_1"),
            ("time_fc2", "condition_embedder.time_embedder.linear_2"),
            ("time_proj", "condition_embedder.time_proj"),
            ("text_fc1", "condition_embedder.text_embedder.linear_1"),
            ("text_fc2", "condition_embedder.text_embedder.linear_2"),
            ("extra_fc1", "condition_embedder.extra_embedder.linear_1"),
            ("extra_fc2", "condition_embedder.extra_embedder.linear_2"),
            ("proj_out", "proj_out"))
_WAN_ATTN = (("q_proj", "to_q"), ("k_proj", "to_k"), ("v_proj", "to_v"), ("o_proj", "to_out.0"))


def _lora_linear(sd, prefix: str, p: Params) -> None:
    """Dense or LoRADense; lora_A [in, r] / lora_B [r, out] -> [r, in] / [out, r]."""
    _linear(sd, prefix, p)
    if "lora_A" in p:
        sd[f"{prefix}.lora_A"] = _t(np.asarray(p["lora_A"]).T)
        sd[f"{prefix}.lora_B"] = _t(np.asarray(p["lora_B"]).T)


def _wan_attention(sd, pre: str, p: Params) -> None:
    for jax_name, name in _WAN_ATTN:
        _lora_linear(sd, f"{pre}.{name}", p[jax_name])
    sd[f"{pre}.norm_q.weight"] = _t(p["q_norm"]["scale"])
    sd[f"{pre}.norm_k.weight"] = _t(p["k_norm"]["scale"])
    if "sla" in p:
        _linear(sd, f"{pre}.sla.proj_l", p["sla"]["proj_l"])


def _wan_block(sd, pre: str, blk: Params) -> None:
    sd[f"{pre}scale_shift_table"] = _t(blk["scale_shift_table"])
    _wan_attention(sd, f"{pre}attn1", blk["self_attn"])
    _wan_attention(sd, f"{pre}attn2", blk["cross_attn"])
    _layernorm(sd, f"{pre}norm2", blk["norm2"])
    if "moe_ffn" in blk:   # SwitchFFN: the router a Dense, the experts stacked [E, ...]
        moe = blk["moe_ffn"]
        _linear(sd, f"{pre}moe_ffn.router", moe["router"])
        for leaf in ("ffn_in", "ffn_in_bias", "ffn_out"):
            sd[f"{pre}moe_ffn.{leaf}"] = _t(moe[leaf])
        return
    _lora_linear(sd, f"{pre}ffn.net.0.proj", blk["ffn_in"])
    _lora_linear(sd, f"{pre}ffn.net.2", blk["ffn_out"])


def _wan_blocks(params: Params):
    """Per-block trees in layer order from any of the JAX layouts: loop
    (block_{i}), remat groups (group_{g}/block_{j}) or scan (blocks/block,
    every leaf stacked on axis 0, unstacked here in numpy)."""
    if "blocks" in params:
        stacked = params["blocks"]["block"]

        def take(tree, i):
            if isinstance(tree, dict):
                return {k: take(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        n = len(np.asarray(stacked["scale_shift_table"]))
        return [take(stacked, i) for i in range(n)]
    if "block_0" in params:
        n = sum(1 for k in params if k.startswith("block_"))
        return [params[f"block_{i}"] for i in range(n)]
    blocks, g = [], 0
    while f"group_{g}" in params:
        grp, j = params[f"group_{g}"], 0
        while f"block_{j}" in grp:
            blocks.append(grp[f"block_{j}"])
            j += 1
        g += 1
    return blocks


def wan_params_to_state_dict(params: Params, frame_cond: Optional[Params] = None,
                             patch_size=(1, 2, 2)
                             ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """flax params of a WanDiT (+ its FrameCondProjector) -> state_dicts of the
    port's WanDiT and FrameCondProjector (None without `frame_cond`).

    Covers runtime-form LoRA (lora_A / lora_B), the SLA projection
    (self_attn/sla/proj_l) and the extra-context MLP. The patch-embed kernel
    [C*pt*ph*pw, dim] becomes the Conv3d-shaped weight [dim, C, pt, ph, pw].
    """
    sd: Dict[str, torch.Tensor] = {}
    kernel = np.asarray(params["patch_embed"]["kernel"])
    dim = kernel.shape[1]
    channels = kernel.shape[0] // int(np.prod(patch_size))
    sd["patch_embedding.weight"] = _t(kernel.T.reshape(dim, channels, *patch_size))
    sd["patch_embedding.bias"] = _t(params["patch_embed"]["bias"])
    for jax_name, name in _WAN_TOP:
        if jax_name in params:
            _linear(sd, name, params[jax_name])
    sd["scale_shift_table"] = _t(params["head_scale_shift"])
    for i, blk in enumerate(_wan_blocks(params)):
        _wan_block(sd, f"blocks.{i}.", blk)
    fc_sd = None
    if frame_cond is not None:
        fc_sd = {}
        for name, p in frame_cond.items():
            _linear(fc_sd, name, p)
    return sd, fc_sd


def lora_to_params(lora: Dict[str, torch.Tensor], layer_mode: str = "loop") -> Params:
    """The port's LoRA leaves ({"blocks.i.attn1.to_q.lora_A": [r, in], ...};
    values or gradients) -> the JAX trainer's `lora` tree with numpy leaves:
    block_{i}/self_attn/q_proj/lora_A [in, r], lora_B [r, out] (transposed
    back), or under blocks/block stacked on axis 0 for layer_mode "scan"."""
    names = {f"{pre}.{name}": (jax_pre, jax_name)
             for pre, jax_pre in (("attn1", "self_attn"), ("attn2", "cross_attn"))
             for jax_name, name in _WAN_ATTN}
    names["ffn.net.0.proj"] = (None, "ffn_in")
    names["ffn.net.2"] = (None, "ffn_out")
    blocks: Dict[int, Params] = {}
    for key, value in lora.items():
        _, i, rest = key.split(".", 2)
        module, leaf = rest.rsplit(".", 1)
        group, jax_name = names[module]
        node = blocks.setdefault(int(i), {})
        if group is not None:
            node = node.setdefault(group, {})
        node.setdefault(jax_name, {})[leaf] = value.detach().cpu().float().numpy().T.copy()
    if layer_mode != "scan":
        return {f"block_{i}": blocks[i] for i in sorted(blocks)}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    return {"blocks": {"block": stack([blocks[i] for i in sorted(blocks)])}}


def frame_cond_to_params(fc: Dict[str, torch.Tensor]) -> Params:
    """The port's FrameCondProjector leaves ({"fc_0.weight": [out, in], ...})
    -> the JAX tree {"fc_0": {"kernel": [in, out], "bias"}, ...}."""
    out: Params = {}
    for key, value in fc.items():
        module, leaf = key.rsplit(".", 1)
        a = value.detach().cpu().float().numpy()
        out.setdefault(module, {})["kernel" if leaf == "weight" else "bias"] = (
            a.T.copy() if leaf == "weight" else a.copy())
    return out


def lora_params_to_state_dict(lora: Params) -> Dict[str, torch.Tensor]:
    """A JAX Wan trainer's `lora` tree -> the port's LoRA leaves
    ({"blocks.i.attn1.to_q.lora_A": [r, in], "...lora_B": [out, r]}), the
    inverse of `lora_to_params`.

    Takes every layout the JAX trainer writes: runtime LoRA (LoRADense leaves
    lora_A [in, r] / lora_B [r, out] under block_{i}/..., remat groups
    group_{g}/block_{j}/... or blocks/block/... stacked on a leading layer
    axis) and the merged form (init_lora: A / B under the kernel's path, a
    "block_{i}/self_attn/q_proj" string key). Both forms compute x W + (alpha
    / r) (x A) B, so the leaves map one to one."""
    names = {("self_attn" if pre == "attn1" else "cross_attn", jax_name): f"{pre}.{name}"
             for pre in ("attn1", "attn2") for jax_name, name in _WAN_ATTN}
    names.update({(None, "ffn_in"): "ffn.net.0.proj", (None, "ffn_out"): "ffn.net.2"})
    leaf_names = {"A": "lora_A", "lora_A": "lora_A", "B": "lora_B", "lora_B": "lora_B"}
    flat: Dict[Tuple[str, ...], Any] = {}

    def walk(tree, path):
        for key, value in tree.items():
            sub = path + tuple(str(key).split("/"))
            if isinstance(value, dict):
                walk(value, sub)
            else:
                flat[sub] = value

    walk(lora, ())

    def block_key(path):   # ("block_3",) or ("group_1", "block_2"): the path down to the block
        cut = next((i for i, q in enumerate(path) if q.startswith("block_")), None)
        return None if cut is None or path[:2] == ("blocks", "block") else path[:cut + 1]

    # loop and remat-group blocks in layer order: block_{i}, or group_{g}/block_{j} by (g, j)
    keys = sorted({block_key(p) for p in flat} - {None},
                  key=lambda b: [int(q.rsplit("_", 1)[1]) for q in b])
    layer_of = {b: i for i, b in enumerate(keys)}
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        a, key = np.asarray(value), block_key(path)
        if key is None:      # scan: blocks/block/..., stacked on the layer axis
            layers, rest = range(a.shape[0]), path[2:]
        else:
            layers, rest, a = [layer_of[key]], path[len(key):], a[None]
        group = rest[0] if rest[0] in ("self_attn", "cross_attn") else None
        module = names[(group, rest[-2])]
        for n, i in enumerate(layers):
            sd[f"blocks.{i}.{module}.{leaf_names[rest[-1]]}"] = _t(a[n].T)
    return sd


def selector_to_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """flax params of a KeypointSelector -> the port's KeypointSelector
    state_dict (the inverse of convert_keypoint_selector)."""
    sd: Dict[str, torch.Tensor] = {}
    n_convs = sum(1 for k in params if k.startswith("conv_"))
    for n in range(n_convs):
        _conv(sd, f"spatial_conv.{2 * n}", params[f"conv_{n}"])
    if "proj" in params:
        _conv(sd, "spatial_proj", params["proj"])
    for jax_pre, name in (("sg", "sg_token"), ("gd", "goal_dist_token"), ("lvl", "level_mlp"),
                          ("bias", "cond_bias")):
        if f"{jax_pre}_fc1" in params:
            _linear(sd, f"{name}.0", params[f"{jax_pre}_fc1"])
            _linear(sd, f"{name}.2", params[f"{jax_pre}_fc2"])
    _linear(sd, "time_proj", params["time_proj"])
    if "cond_enc" in params:
        _cond_enc(sd, params["cond_enc"])
    n_blocks = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_blocks):
        blk, pre = params[f"block_{i}"], f"blocks.{i}."
        _layernorm(sd, f"{pre}norm1", blk["norm1"])
        _layernorm(sd, f"{pre}norm2", blk["norm2"])
        att = blk["attn"]
        d = np.asarray(att["query"]["kernel"]).shape[0]
        sd[f"{pre}attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(att[n]["kernel"]).reshape(d, d).T for n in ("query", "key", "value")]))
        sd[f"{pre}attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(att[n]["bias"]).reshape(d) for n in ("query", "key", "value")]))
        sd[f"{pre}attn.out_proj.weight"] = _t(np.asarray(att["out"]["kernel"]).reshape(d, d).T)
        sd[f"{pre}attn.out_proj.bias"] = _t(att["out"]["bias"])
        _linear(sd, f"{pre}ff.0", blk["ff1"])
        _linear(sd, f"{pre}ff.2", blk["ff2"])
    _linear(sd, "out", params["out"])
    return sd


def segment_cost_to_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """flax params of a SegmentCostPredictor (D_phi) -> the port's state_dict
    (the inverse of convert_segment_cost): fc_{n} -> mlp.{2n}, out last."""
    sd: Dict[str, torch.Tensor] = {}
    _cond_enc(sd, params["cond_enc"])
    n_hidden = sum(1 for k in params if k.startswith("fc_"))
    for n in range(n_hidden):
        _linear(sd, f"mlp.{2 * n}", params[f"fc_{n}"])
    _linear(sd, f"mlp.{2 * n_hidden}", params["out"])
    return sd


def module_tree_to_state_dict(params: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax params of a module whose port keeps the flax names (the flow
    interpolator, the straighteners, the Sinkhorn interpolator, the video
    selector and the video D_phi) -> its state_dict: a Dense or Conv leaf
    dict becomes `<path>.weight` / `<path>.bias` (conv kernels to OIHW), a
    TransformerEncoder (`transformer`, `tr`) `<path>.layers.{i}.*`, a
    TextConditionEncoder (`text_enc`) `<path>.proj.{0,2}`, a bare array
    (time_embed, tau_raw, dustbin) its own entry."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        path = f"{prefix}{name}"
        if not isinstance(p, dict):
            sd[path] = _t(p)
        elif "kernel" in p:
            (_conv if np.asarray(p["kernel"]).ndim == 4 else _linear)(sd, path, p)
        elif name in ("transformer", "tr"):
            for i in range(sum(1 for k in p if k.startswith("block_"))):
                _block(sd, f"{path}.layers.{i}.", p[f"block_{i}"])
        elif name == "text_enc":
            _linear(sd, f"{path}.proj.0", p["fc1"])
            _linear(sd, f"{path}.proj.2", p["fc2"])
        else:
            sd.update(module_tree_to_state_dict(p, f"{path}."))
    return sd


def tiny_interpolator_to_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """flax TinyTemporalInterpolator params (dwconv_i kernel [k, 1, D]) ->
    the port's state_dict (net.{2i}.weight [D, 1, k], the reference's names)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(sum(1 for k in params if k.startswith("dwconv_"))):
        p = params[f"dwconv_{i}"]
        sd[f"net.{2 * i}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        sd[f"net.{2 * i}.bias"] = _t(p["bias"])
    return sd


def sd_vae_params_to_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """flax SDVAE params -> the port's SDVAE state_dict (the diffusers names)."""
    from .sd_vae import export_sd_vae_state_dict

    return {k: _t(v) for k, v in export_sd_vae_state_dict(params).items()}


# stages whose port keeps the flax module names
_FLAX_NAMED_STAGES = ("flow_interpolator", "straightener", "sinkhorn_interp", "video_selector",
                      "segment_cost_wansynth")
# stages of the token denoisers (text-conditioned) and of the toy-video denoisers
_TOKEN_STAGES = {"keypoints_wansynth": "video_keypoint", "interp_levels_wansynth": "video_interp",
                 "keypoints_didemo": "video_keypoint", "interp_levels_didemo": "video_interp"}
_TOY_STAGES = {"keypoints_toy_video": "keypoint", "interp_levels_toy_video": "interp"}


def _numpy_tree(tree):
    """Tensor leaves (utils/jax_checkpoint) -> numpy; bf16 widens to f32 (exact)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return tree


def checkpoint_to_state_dict(meta: Dict, params: Params) -> Dict[str, Any]:
    """A JAX checkpoint's params (or EMA) tree -> what the port's checkpoint
    of the same stage holds under `params`: the model's state_dict for the
    maze stages (keypoints, interp_levels causal or not, segment_cost,
    selector), the video interpolators' stages (flow_interpolator,
    straightener, sinkhorn_interp, video_selector, segment_cost_wansynth,
    video_interpolator), the toy-video denoisers (keypoints_toy_video,
    interp_levels_toy_video), the DiDeMo token denoisers (keypoints_didemo,
    interp_levels_didemo) and the wansynth stages under use_wan 0; for
    keypoints_wansynth / interp_levels_wansynth with use_wan the LoRA
    partition the Wan trainer saves ({"lora": LoRA leaves, "frame_cond":
    projector state_dict, "wan_base" and, for a run that trained every
    weight, "wan": WanDiT state_dicts). Other stages (every stage of the JAX
    package has a port), and a Wan tree with other leaves, raise
    NotImplementedError naming what is missing."""
    stage = meta.get("stage")
    params = _numpy_tree(params)
    if stage == "keypoints":
        return params_to_state_dict(params, "keypoint")
    if stage == "interp_levels":
        return params_to_state_dict(params, "interp")
    if stage == "selector":
        return selector_to_state_dict(params)
    if stage == "segment_cost":
        return segment_cost_to_state_dict(params)
    if stage in _FLAX_NAMED_STAGES:
        return module_tree_to_state_dict(params)
    if stage == "video_interpolator":
        return tiny_interpolator_to_state_dict(params)
    if stage in _TOY_STAGES:
        return params_to_state_dict(params, _TOY_STAGES[stage])
    if stage in _TOKEN_STAGES:
        if stage.endswith("_didemo") or not meta.get("use_wan", 1):
            return params_to_state_dict(params, _TOKEN_STAGES[stage])
        extra = sorted(set(params) - {"lora", "frame_cond", "wan_base", "wan"})
        if extra:
            raise NotImplementedError(f"JAX {stage} checkpoint with {extra}: only the LoRA, "
                                      "frame-projector and WanDiT trees are read")
        out: Dict[str, Any] = {}
        if "lora" in params:
            out["lora"] = lora_params_to_state_dict(params["lora"])
        if "frame_cond" in params:
            out["frame_cond"] = {}
            for name, p in params["frame_cond"].items():
                _linear(out["frame_cond"], name, p)
        for key in ("wan_base", "wan"):
            if key in params:
                out[key] = wan_params_to_state_dict(params[key])[0]
        return out
    raise NotImplementedError(f"JAX checkpoint of stage {stage!r}: the module of that stage "
                              "is not ported, so its parameters have no counterpart in the port")
