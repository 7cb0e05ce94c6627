"""JAX (flax) params -> port state_dicts, and the trainable leaves back.

`params_to_state_dict` is the inverse of interpolated_diffusion_tpu/models/
torch_import.py::convert_state_dict for the two maze denoisers;
`wan_params_to_state_dict` converts a WanDiT (and FrameCondProjector) tree.
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


def _cond_enc(sd, p: Params) -> None:
    maze = p["maze"]
    n_convs = sum(1 for k in maze if k.startswith("conv_"))
    for n in range(n_convs):
        conv = maze[f"conv_{n}"]
        sd[f"cond_enc.maze.convs.{2 * n}.weight"] = _t(
            np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        sd[f"cond_enc.maze.convs.{2 * n}.bias"] = _t(conv["bias"])
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


def params_to_state_dict(params: Params, kind: str) -> Dict[str, torch.Tensor]:
    """flax params of a KeypointDenoiser ("keypoint") or InterpLevelDenoiser
    ("interp") -> state_dict of the port's module of the same name."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "in_proj", params["in_proj"])
    if kind == "keypoint":
        _linear(sd, "t_embed.0", params["t_fc1"])
        _linear(sd, "t_embed.2", params["t_fc2"])
    elif kind == "interp":
        sd["level_emb.weight"] = _t(params["level_emb"]["embedding"])
        _linear(sd, "level_proj.0", params["lvl_fc1"])
        _linear(sd, "level_proj.2", params["lvl_fc2"])
    else:
        raise ValueError(f"unknown model kind {kind!r}; one of ['interp', 'keypoint']")
    if "cond_enc" in params:
        _cond_enc(sd, params["cond_enc"])
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
    if "moe_ffn" in blk:
        raise NotImplementedError("WanDiT ffn_mode='moe' is not ported yet")
    sd[f"{pre}scale_shift_table"] = _t(blk["scale_shift_table"])
    _wan_attention(sd, f"{pre}attn1", blk["self_attn"])
    _wan_attention(sd, f"{pre}attn2", blk["cross_attn"])
    _layernorm(sd, f"{pre}norm2", blk["norm2"])
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
