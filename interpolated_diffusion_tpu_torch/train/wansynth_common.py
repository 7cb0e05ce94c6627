"""Wan model construction and runtime-LoRA parameter plumbing (port of the
model half of train/wansynth_common.py).

`build_wan` makes the WanDiT (and FrameCondProjector) the wansynth trainers
and the Phase-1 anchor precompute use, from the same argument names, with
seeded parameters (models/init.py). `split_lora_state_dict` /
`join_lora_state_dict` / `merged_wan_params` are the runtime-form LoRA
partition and join. The merge-form adapter tree, the Switch-MoE FFN and the
data loaders are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.init import build_model
from ..models.wan_dit import FrameCondProjector, WanDiT

_LORA_LEAVES = ("lora_A", "lora_B")


def _lora_form(args) -> str:
    return str(getattr(args, "lora_form", "merged"))


def build_wan(args, bf16: bool = True, *, generator: torch.Generator,
              device: Optional[torch.device] = None, zero_init_scale: float = 0.0
              ) -> Tuple[WanDiT, Optional[FrameCondProjector]]:
    """(WanDiT, FrameCondProjector or None) from wansynth arguments
    (wan_dim, wan_layers, wan_heads, wan_ffn, latent_c, text_dim, attn_mode,
    sla_topk, sla_block, lora_rank, lora_alpha, lora_form, lora_targets,
    ffn_mode, frame_cond, frame_cond_dim), parameters drawn from `generator`.

    Runtime-form LoRA lives inside the model (LoRALinear), as in the JAX
    package; zero_init_scale > 0 makes the zero-initialised leaves (lora_B,
    sla.proj_l, the projector's output) small and non-zero.
    """
    if int(args.lora_rank) > 0 and _lora_form(args) != "runtime":
        raise NotImplementedError("lora_form='merged' is not ported yet; use 'runtime'")
    frame_cond = bool(getattr(args, "frame_cond", 0))
    dtype = torch.bfloat16 if bf16 else torch.float32
    wan = build_model(
        WanDiT, generator=generator, device=device, dtype=dtype,
        zero_init_scale=zero_init_scale,
        dim=args.wan_dim, n_layers=args.wan_layers, n_heads=args.wan_heads,
        ffn_dim=args.wan_ffn, in_channels=args.latent_c, out_channels=args.latent_c,
        text_dim=args.text_dim, attn_mode=args.attn_mode, sla_topk=args.sla_topk,
        sla_block=args.sla_block, lora_rank=int(args.lora_rank),
        lora_alpha=float(args.lora_alpha),
        lora_targets=str(getattr(args, "lora_targets", "attn,ffn")),
        ffn_mode=str(getattr(args, "ffn_mode", "dense")), extra_context=frame_cond)
    fc = None
    if frame_cond:
        fc = build_model(FrameCondProjector, generator=generator, device=device, dtype=dtype,
                         zero_init_scale=zero_init_scale,
                         feat_dim=int(getattr(args, "frame_cond_dim", 5)),
                         text_dim=args.text_dim)
    return wan.eval(), (fc.eval() if fc is not None else None)


def split_lora_state_dict(sd: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(LoRA leaves, frozen rest): the rest has exactly the keys of a
    lora_rank=0 WanDiT, so plain base weights interchange with it."""
    lora = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in _LORA_LEAVES}
    return lora, {k: v for k, v in sd.items() if k not in lora}


def join_lora_state_dict(lora: Dict[str, torch.Tensor],
                         base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of split_lora_state_dict: the union of the two partitions."""
    return {**base, **lora}


def merged_wan_params(params: Dict, base: Optional[Dict[str, torch.Tensor]], args
                      ) -> Dict[str, torch.Tensor]:
    """Effective WanDiT state_dict: the frozen base joined with the runtime
    LoRA leaves (params["lora"]), or params["wan"] without LoRA."""
    if int(args.lora_rank) > 0:
        if _lora_form(args) != "runtime":
            raise NotImplementedError("lora_form='merged' is not ported yet; use 'runtime'")
        return join_lora_state_dict(params["lora"], base)
    return params["wan"]
