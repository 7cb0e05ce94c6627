"""Training state, optimizer and the frozen-base train step (port of the
parts of train/state.py that the Wan Phase-1 trainer uses).

`make_optimizer` is AdamW behind a global-norm clip, held to optax's
arithmetic: the clip scales by clip / max(norm, clip) (not torch's
clip / (norm + 1e-6)); AdamW decays every leaf, eps 1e-8 outside the root;
the learning rate of update n (from 0) is schedule(n). `make_train_step_frozen`
differentiates the loss with respect to the trainable dict only; the frozen
base never requires a gradient. Parameters are updated in place (the
modules own their tensors), so the state returned by a step aliases the one
passed in. `make_train_step` with gradient accumulation and
`make_train_multi_step` come with the maze trainers.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..utils.ema import ema_init, ema_update


class TrainState(NamedTuple):
    step: int
    params: Dict[str, Any]          # (nested) dict of trainable leaf tensors
    opt_state: "Optimizer"
    ema_params: Optional[Dict[str, Any]]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of a (nested) dict, in key order of insertion."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def flatten_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict -> {"a/b": leaf}."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        out.update(flatten_dict(v, f"{prefix}{k}/"))
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares over all leaves), in f32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_lr_schedule(lr: float, warmup_steps: int = 0, total_steps: Optional[int] = None,
                     schedule: str = "constant") -> Callable[[int], float]:
    """count -> learning rate: optax's warmup_cosine_decay_schedule(0, lr,
    warmup, total), linear_schedule(0, lr, warmup), or the constant lr."""
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("schedule='cosine' requires total_steps > 0")

        def cosine(count: int) -> float:
            if count < warmup_steps:
                return lr * count / warmup_steps
            frac = min(1.0, (count - warmup_steps) / max(1, total_steps - warmup_steps))
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return cosine
    if warmup_steps > 0:
        return lambda count: lr * min(count, warmup_steps) / warmup_steps
    return lambda count: lr


class Optimizer:
    """Global-norm clip + AdamW over a fixed list of leaves, in place."""

    def __init__(self, params: List[torch.Tensor], lr_schedule: Callable[[int], float],
                 weight_decay: float, grad_clip: float):
        self.lr_schedule, self.grad_clip = lr_schedule, grad_clip
        self.count = 0
        self.adamw = torch.optim.AdamW(params, lr=lr_schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One update from `grads` (one per leaf, in order); returns the
        gradients' global norm before the clip."""
        norm = global_norm(grads)
        scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
        group = self.adamw.param_groups[0]
        for p, g in zip(group["params"], grads):
            p.grad = (g.float() * scale).to(p.dtype)
        group["lr"] = self.lr_schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        """A copy: torch's own state_dict hands out the live moment tensors."""
        return {"count": self.count, "adamw": copy.deepcopy(self.adamw.state_dict())}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def make_optimizer(lr: float, weight_decay: float = 1e-2, grad_clip: float = 1.0,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   schedule: str = "constant", optimizer: str = "adamw"
                   ) -> Callable[[Dict], Optimizer]:
    """tx(params) -> Optimizer over the leaves of `params`: AdamW behind a
    global-norm clip, with a constant, warm-up or warm-up + cosine schedule."""
    if optimizer == "muon":
        raise NotImplementedError("optimizer='muon' is not ported yet")
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    sched = make_lr_schedule(lr, warmup_steps, total_steps, schedule)
    return lambda params: Optimizer(tree_leaves(params), sched, weight_decay, grad_clip)


def init_train_state(params: Dict, tx: Callable[[Dict], Optimizer],
                     use_ema: bool = True) -> TrainState:
    return TrainState(step=0, params=params, opt_state=tx(params),
                      ema_params=ema_init(params) if use_ema else None)


def make_train_step_frozen(loss_fn, ema_decay: float = 0.999):
    """step(state, frozen, batch, rng) -> (state, metrics) for
    loss_fn(params, frozen, batch, rng) -> (loss, aux dict).

    Differentiates only with respect to the leaves of state.params; `frozen`
    (e.g. a 1.3B LoRA base) is a plain argument whose tensors require no
    gradient and get none. metrics: aux, `loss`, and the pre-clip
    `grad_norm`. `rng` is whatever loss_fn draws from: a torch.Generator or
    a dict of injected draws."""

    def step_fn(state: TrainState, frozen, batch, rng) -> Tuple[TrainState, Dict]:
        leaves = tree_leaves(state.params)
        loss, aux = loss_fn(state.params, frozen, batch, rng)
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = state.opt_state.update(grads)
        ema = (ema_update(state.ema_params, state.params, ema_decay)
               if state.ema_params is not None else None)
        metrics = dict(aux) if isinstance(aux, dict) else {}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, state.opt_state, ema), metrics

    return step_fn
