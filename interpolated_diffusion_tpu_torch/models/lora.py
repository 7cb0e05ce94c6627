"""LoRA adapters in the JAX package's merged form (port of models/lora.py).

The adapter tree is {"path": {"A": [in, r], "B": [r, out]}}, keyed by the
flax kernel path of the adapted Dense ("block_3/self_attn/q_proj"), so that
a JAX merged tree reads without renaming. `apply_lora` merges it into a
WanDiT state_dict at the JAX rounding point: W' = W + ((A @ B) (a/r)) rounded
to W's dtype, the sum in that dtype (the torch weight is the transposed
kernel, so the delta is added transposed). `JAX_TO_PORT` / `jax_path` map
the flax paths to the port's diffusers-style Linear names and back.

In training the same A and B live inside the model as LoRALinear leaves
(`lora_A` = A^T [r, in], `lora_B` = B^T [out, r]) with form "merged", which
computes the merged weight per call, so that gradients reach A and B only and
activation checkpointing recomputes with the same weights
(`tree_to_leaves` / `leaves_to_tree` convert between the two).
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]

DEFAULT_FILTER = r"(qkv|attn_out|ff1|ff2|q_proj|k_proj|v_proj|o_proj)"

# flax names inside a WanDiT block -> the port's module names
JAX_TO_PORT = {"self_attn/q_proj": "attn1.to_q", "self_attn/k_proj": "attn1.to_k",
               "self_attn/v_proj": "attn1.to_v", "self_attn/o_proj": "attn1.to_out.0",
               "cross_attn/q_proj": "attn2.to_q", "cross_attn/k_proj": "attn2.to_k",
               "cross_attn/v_proj": "attn2.to_v", "cross_attn/o_proj": "attn2.to_out.0",
               "ffn_in": "ffn.net.0.proj", "ffn_out": "ffn.net.2"}
# WanDiT's other Dense kernels (the filter may name them too)
_TOP = {"patch_embed": "patch_embedding", "time_fc1": "condition_embedder.time_embedder.linear_1",
        "time_fc2": "condition_embedder.time_embedder.linear_2",
        "time_proj": "condition_embedder.time_proj",
        "text_fc1": "condition_embedder.text_embedder.linear_1",
        "text_fc2": "condition_embedder.text_embedder.linear_2",
        "extra_fc1": "condition_embedder.extra_embedder.linear_1",
        "extra_fc2": "condition_embedder.extra_embedder.linear_2", "proj_out": "proj_out"}
_PORT_TO_JAX = {v: k for k, v in JAX_TO_PORT.items()}
_PORT_TOP = {v: k for k, v in _TOP.items()}


def port_module(path: str) -> str:
    """flax kernel path ("block_3/self_attn/q_proj") -> port module name
    ("blocks.3.attn1.to_q")."""
    if path in _TOP:
        return _TOP[path]
    m = re.fullmatch(r"block_(\d+)/(.+)", path)
    if m is None or m.group(2) not in JAX_TO_PORT:
        raise KeyError(f"no WanDiT Linear at flax path {path!r}")
    return f"blocks.{m.group(1)}.{JAX_TO_PORT[m.group(2)]}"


def jax_path(module: str) -> str:
    """Inverse of port_module."""
    if module in _PORT_TOP:
        return _PORT_TOP[module]
    m = re.fullmatch(r"blocks\.(\d+)\.(.+)", module)
    if m is None or m.group(2) not in _PORT_TO_JAX:
        raise KeyError(f"no flax kernel path for module {module!r}")
    return f"block_{m.group(1)}/{_PORT_TO_JAX[m.group(2)]}"


def _kernels(state_dict: Dict[str, torch.Tensor]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(flax path, weight [out, in]) of every Linear of a WanDiT state_dict
    that has a flax Dense counterpart, in the flax tree's key order."""
    found = []
    for name, w in state_dict.items():
        if not name.endswith(".weight") or w.ndim != 2:
            continue
        try:
            found.append((jax_path(name[:-len(".weight")]), w))
        except KeyError:
            continue
    return iter(sorted(found, key=lambda pw: _order(pw[0])))


def _order(path: str):
    m = re.match(r"block_(\d+)/(.*)", path)
    return (1, int(m.group(1)), m.group(2)) if m else (0, 0, path)


def init_lora(generator: torch.Generator, state_dict: Dict[str, torch.Tensor], rank: int,
              alpha: float = 16.0, filter_regex: str = DEFAULT_FILTER) -> Tree:
    """A LoRA tree for every 2-D Dense kernel whose flax path matches:
    A ~ N(0, 1) / rank [in, r], B = 0 [r, out], f32 on the generator's
    device, so that the adapted model starts exactly at the base model."""
    pat = re.compile(filter_regex)
    lora: Tree = {}
    for path, w in _kernels(state_dict):
        if not pat.search(path):
            continue
        d_out, d_in = w.shape
        lora[path] = {"A": torch.randn((d_in, rank), generator=generator,
                                       device=generator.device) * (1.0 / rank),
                      "B": torch.zeros((rank, d_out), device=generator.device)}
    if not lora:
        raise ValueError(f"no kernels matched LoRA filter {filter_regex!r}")
    return lora


def apply_lora(state_dict: Dict[str, torch.Tensor], lora: Tree, rank: int,
               alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """Merged state_dict: weight += ((A @ B) (a/r)).T rounded to the weight's
    dtype at every adapted path; the other entries are passed through."""
    scale = alpha / max(1, rank)
    out = dict(state_dict)
    for path, ab in lora.items():
        name = f"{port_module(path)}.weight"
        w = state_dict[name]
        delta = (ab["A"].float() @ ab["B"].float()) * scale
        out[name] = w + delta.t().to(device=w.device, dtype=w.dtype)
    return out


def lora_param_names(lora: Tree) -> List[str]:
    return sorted(lora.keys())


def tree_to_leaves(lora: Tree) -> Dict[str, torch.Tensor]:
    """Adapter tree -> the port's LoRALinear leaves
    ({"blocks.3.attn1.to_q.lora_A": A^T [r, in], "...lora_B": B^T [out, r]})."""
    out = {}
    for path, ab in lora.items():
        module = port_module(path)
        out[f"{module}.lora_A"] = ab["A"].t().contiguous()
        out[f"{module}.lora_B"] = ab["B"].t().contiguous()
    return out


def leaves_to_tree(leaves: Dict[str, torch.Tensor]) -> Tree:
    """Inverse of tree_to_leaves."""
    tree: Tree = {}
    for name, value in leaves.items():
        module, leaf = name.rsplit(".", 1)
        key = {"lora_A": "A", "lora_B": "B"}[leaf]
        tree.setdefault(jax_path(module), {})[key] = value.t().contiguous()
    return tree
