"""JAX (flax) denoiser params -> port state_dict.

The inverse of interpolated_diffusion_tpu/models/torch_import.py::
convert_state_dict for the two maze denoisers. Takes the flax param tree with
numpy (or array-like) leaves, so it needs no JAX:

  Dense kernel [in, out]         -> Linear weight [out, in]
  Conv kernel [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  qkv Dense                      -> attn.in_proj_weight / in_proj_bias
                                    (rows [q; k; v], each split H x Dh)
  Embed embedding                -> Embedding weight, as it is
  LayerNorm scale / bias         -> weight / bias
"""
from __future__ import annotations

from typing import Any, Dict

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
