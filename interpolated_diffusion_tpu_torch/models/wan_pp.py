"""Pipeline-parallel WanDiT forward: the block stack over a `pipe` process
group (port of models/wan_pp.py).

Each rank's stage is its contiguous slice of `model.blocks` (n_layers / S
blocks); the patch / time / text embeds and the modulated head run
replicated on every rank, around parallel/pp.pipeline_blocks. Every rank
loads the full weights (models/jax_import reads JAX's scan layout as its
loop); `keep_stage` then drops the other stages' blocks. Numerics are the
sequential forward's (same layer order); differentiable, so a loss of
`wan_pp_apply`'s output trains the stage's blocks on their rank.

    out = wan_pp_apply(model, latents, t, context, group=pipe, n_microbatches=4)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.collectives import Group, axis_index, axis_size
from ..parallel.pp import pipeline_blocks


def stage_range(model: nn.Module, group: Group) -> range:
    """The block indices of this rank's stage."""
    S, s = axis_size(group), axis_index(group)
    n = len(model.blocks)
    if n % S:
        raise ValueError(f"{n} layers do not split over a pipe group of {S}")
    return range(s * n // S, (s + 1) * n // S)


def keep_stage(model: nn.Module, group: Group) -> nn.Module:
    """Drop every block outside this rank's stage (in place): they become
    nn.Identity, so their weights are freed and the indices stay."""
    mine = stage_range(model, group)
    for i in range(len(model.blocks)):
        if i not in mine:
            model.blocks[i] = nn.Identity()
    return model


def wan_pp_apply(model: nn.Module, latents: torch.Tensor, t: torch.Tensor,
                 context: torch.Tensor, *, group: Group, n_microbatches: int,
                 frame_indices: Optional[torch.Tensor] = None,
                 extra_context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WanDiT's forward with its block stack pipelined over `group`: this
    rank runs its stage, microbatches carry the batched context (text
    tokens, the time modulation); the output is the whole model's on every
    rank."""
    stage = [model.blocks[i] for i in stage_range(model, group)]

    def stage_fn(x, c):
        ctx, t_mod, rope = c
        for block in stage:
            x = block(x, ctx, t_mod, rope)
        return x

    model.blocks_fn = lambda x, ctx, t_mod, rope: pipeline_blocks(
        stage_fn, x, (ctx, t_mod, rope), group, n_microbatches)
    try:
        return model(latents, t, context, frame_indices, extra_context)
    finally:
        model.blocks_fn = None
