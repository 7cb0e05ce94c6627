"""Wan2.1 pretrained weights: diffusers state dict <-> the port's WanDiT
(port of models/wan_convert.py).

The port's WanDiT carries the names of diffusers' WanTransformer3DModel
(models/wan_dit.py), so the map is the identity with one exception: the time
embedder's first linear layer. diffusers' Timesteps emits [cos | sin]
(flip_sin_to_cos), the port's timestep_embedding [sin | cos], so the input
columns of `condition_embedder.time_embedder.linear_1.weight` swap halves.
Every weight keeps its layout (torch [out, in], the Conv3d patch embedding
[dim, C, pt, ph, pw]) and its dtype.

Keys outside the T2V-1.3B family raise under `strict`: the I2V
image-context projections (attn2.add_k_proj / add_v_proj / norm_added_k)
and anything else the model does not have; with strict=False they are
skipped. Leaves diffusers lacks (LoRA, attn1.sla.proj_l, the extra-context
MLP) keep their initial values in `load_pretrained_into`.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.safetensors import read_safetensors

__all__ = ["convert_wan_state_dict", "export_wan_state_dict", "load_wan_safetensors"]

TIME_FC1 = "condition_embedder.time_embedder.linear_1.weight"
_TOP = ("patch_embedding.weight", "patch_embedding.bias", TIME_FC1,
        "condition_embedder.time_embedder.linear_1.bias",
        "condition_embedder.time_embedder.linear_2.weight",
        "condition_embedder.time_embedder.linear_2.bias",
        "condition_embedder.time_proj.weight", "condition_embedder.time_proj.bias",
        "condition_embedder.text_embedder.linear_1.weight",
        "condition_embedder.text_embedder.linear_1.bias",
        "condition_embedder.text_embedder.linear_2.weight",
        "condition_embedder.text_embedder.linear_2.bias",
        "scale_shift_table", "proj_out.weight", "proj_out.bias")
_BLOCK = (["scale_shift_table", "norm2.weight", "norm2.bias", "ffn.net.0.proj.weight",
           "ffn.net.0.proj.bias", "ffn.net.2.weight", "ffn.net.2.bias"]
          + [f"{a}.{p}.{leaf}" for a in ("attn1", "attn2")
             for p in ("to_q", "to_k", "to_v", "to_out.0") for leaf in ("weight", "bias")]
          + [f"{a}.norm_{n}.weight" for a in ("attn1", "attn2") for n in ("q", "k")])


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, copy=True))


def _flip_sincos_cols(w: torch.Tensor) -> torch.Tensor:
    """Swap the two halves of the input columns: [cos | sin] <-> [sin | cos]."""
    half = w.shape[1] // 2
    return torch.cat([w[:, half:], w[:, :half]], dim=1)


def _n_layers(sd) -> int:
    ids = [int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k))]
    return 1 + max(ids) if ids else 0


def wan_keys(n_layers: int):
    """The diffusers T2V state dict's keys for n_layers blocks."""
    return list(_TOP) + [f"blocks.{i}.{k}" for i in range(n_layers) for k in _BLOCK]


def convert_wan_state_dict(sd: Dict[str, object], n_layers: Optional[int] = None,
                           strict: bool = True) -> Dict[str, torch.Tensor]:
    """diffusers WanTransformer3DModel state dict (torch tensors or numpy
    arrays) -> the port's WanDiT state dict for those keys."""
    if n_layers is None:
        n_layers = _n_layers(sd)
    keys = wan_keys(n_layers)
    if strict:
        i2v = [k for k in sd if "add_k_proj" in k or "add_v_proj" in k or "norm_added" in k]
        if i2v:
            raise ValueError(f"I2V image-context weights present ({i2v[:2]}...); the T2V "
                             "WanDiT has no image cross-attention: pass strict=False to skip")
        unknown = sorted(set(sd) - set(keys))
        if unknown:
            raise ValueError(f"keys the WanDiT does not have: {unknown[:3]} "
                             f"({len(unknown)} in all); pass strict=False to skip")
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"Wan state dict lacks {missing[:3]} ({len(missing)} in all)")
    out = {k: _tensor(sd[k]) for k in keys}
    out[TIME_FC1] = _flip_sincos_cols(out[TIME_FC1])
    return out


def export_wan_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of convert_wan_state_dict: the diffusers keys of a port
    WanDiT state dict (the port-only leaves dropped), time embedder flipped
    back."""
    out = {k: state_dict[k] for k in wan_keys(_n_layers(state_dict))}
    out[TIME_FC1] = _flip_sincos_cols(out[TIME_FC1])
    return out


def load_wan_safetensors(path: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A diffusers Wan transformer checkpoint (a directory of .safetensors
    shards, or one file) -> the port's WanDiT state dict."""
    files = ([path] if path.endswith(".safetensors") else sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return convert_wan_state_dict(sd, strict=strict)
