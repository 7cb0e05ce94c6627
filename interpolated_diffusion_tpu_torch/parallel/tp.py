"""Tensor parallelism for WanDiT over a `model` group (port of
parallel/tp.py).

The JAX package splits parameters by owner name and lets GSPMD insert the
collectives. The port has the same owner lists and writes the collectives
Megatron's way (parallel/collectives.copy_to / reduce_from):

  column (output features split): q_proj, k_proj, v_proj, ffn_in
  row (input features split, partial outputs summed): o_proj, ffn_out

(JAX's lists also name the maze transformer's ff1 / ff2 / attn_out and the
time MLPs t_fc1 / t_fc2, lvl_fc1 / lvl_fc2 and fc1 / fc2; WanDiT has none of
those owners and the port splits WanDiT only. The maze block's fused qkv
stays whole, as in JAX.) Every rank loads the full weights and keeps its
slice, so the same JAX parameters give the same function on 1 and on N
ranks. Attention then runs on the rank's heads (the SLA LUT is per (b, h),
so a rank's LUT is the head slice of the global one), and WanDiT's q / k
RMSNorms, which normalise over the full `dim`, sum their mean square over
the group: GSPMD inserts that psum in JAX, here it is written.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .collectives import Group, axis_index, axis_size

COL_PARALLEL = ("ff1", "t_fc1", "lvl_fc1", "fc1", "q_proj", "k_proj", "v_proj", "ffn_in")
ROW_PARALLEL = ("attn_out", "ff2", "t_fc2", "lvl_fc2", "fc2", "o_proj", "ffn_out")
# WanDiT's owners under the port's (diffusers') module names
WAN_OWNERS = {"to_q": "q_proj", "to_k": "k_proj", "to_v": "v_proj", "to_out.0": "o_proj",
              "ffn.net.0.proj": "ffn_in", "ffn.net.2": "ffn_out"}


def _owner(name: str) -> str:
    for suffix, owner in WAN_OWNERS.items():
        if name == suffix or name.endswith("." + suffix):
            return owner
    return ""


def _keep(p: nn.Parameter, dim: int, n: int, r: int) -> nn.Parameter:
    size = p.shape[dim] // n
    return nn.Parameter(p.detach().narrow(dim, r * size, size).clone(),
                        requires_grad=p.requires_grad)


def _split_dims(model: nn.Module) -> Dict[str, int]:
    """{state-dict name: the dimension split over the model group} of the
    leaves apply_tp splits (torch's [out, in] weight layout)."""
    from ..models.wan_dit import RMSNorm

    dims: Dict[str, int] = {}
    for name, m in model.named_modules():
        owner = _owner(name)
        if owner in COL_PARALLEL:
            dims[f"{name}.weight"] = dims[f"{name}.bias"] = 0
            if getattr(m, "rank", 0) > 0:
                dims[f"{name}.lora_B"] = 0
        elif owner in ROW_PARALLEL:
            dims[f"{name}.weight"] = 1
            if getattr(m, "rank", 0) > 0:
                dims[f"{name}.lora_A"] = 1
        elif isinstance(m, RMSNorm) and name.rsplit(".", 1)[-1] in ("norm_q", "norm_k"):
            dims[f"{name}.weight"] = 0
    return dims


def apply_tp(model: nn.Module, group: Group) -> nn.Module:
    """Split a WanDiT's attention and FFN weights over `group` (in place):
    this rank keeps its heads and FFN features. Every split leaf gets
    `tp_dim` (the dimension it is split on) so that the optimizer's global
    norm sums it over the group. Heads and the FFN width must divide by the
    group size; merged-form LoRA is not split."""
    from ..models.wan_dit import LoRALinear, RMSNorm, WanAttention

    n, r = axis_size(group), axis_index(group)
    dims = _split_dims(model)
    for name, m in model.named_modules():
        if isinstance(m, WanAttention):
            if m.n_heads % n:
                raise ValueError(f"{m.n_heads} heads do not split over a model group of {n}")
            m.n_heads, m.dim = m.n_heads // n, m.dim // n
        leaves = [leaf for leaf, _ in m.named_parameters(recurse=False)
                  if f"{name}.{leaf}" in dims]
        if not leaves:
            continue
        if isinstance(m, LoRALinear):
            if m.rank > 0 and m.form != "runtime":
                raise ValueError(f"{name}: tensor parallelism takes runtime-form LoRA only")
            m.tp_mode = "column" if _owner(name) in COL_PARALLEL else "row"
            m.tp_group = group
        elif isinstance(m, RMSNorm):
            m.tp_group = group
        for leaf in leaves:
            d = dims[f"{name}.{leaf}"]
            new = _keep(getattr(m, leaf), d, n, r)
            new.tp_dim = d
            setattr(m, leaf, new)
    return model


def tp_global_norm(grads, params, group: Group) -> torch.Tensor:
    """sqrt of the sum of squares of the whole (unsplit) gradient: split
    leaves' squares summed over the group, replicated leaves' counted once."""
    from .collectives import psum

    split = sum((g.float().square().sum() for g, p in zip(grads, params)
                 if getattr(p, "tp_dim", None) is not None), torch.zeros(()))
    whole = sum((g.float().square().sum() for g, p in zip(grads, params)
                 if getattr(p, "tp_dim", None) is None), torch.zeros(()))
    dev = grads[0].device
    return torch.sqrt(psum(split.to(dev), group) + whole.to(dev))
