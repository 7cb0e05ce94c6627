"""Training state, optimizer and the train steps (port of train/state.py).

`make_optimizer` is AdamW behind a global-norm clip, held to optax's
arithmetic: the clip scales by clip / max(norm, clip) (not torch's
clip / (norm + 1e-6)); AdamW decays every leaf, eps 1e-8 outside the root;
the learning rate of update n (from 0) is schedule(n). `make_train_step_frozen`
differentiates the loss with respect to the trainable dict only; the frozen
base never requires a gradient. Parameters are updated in place (the
modules own their tensors), so the state returned by a step aliases the one
passed in. `make_train_step` differentiates with respect to every leaf of
state.params, with microbatch gradient accumulation; `make_train_multi_step`
takes several steps per call from a stacked superbatch.

Tensor parallelism (a mesh with a `model` axis, parallel/tp.apply_tp): the
split leaves' squares are summed over the model group in the global norm.

Data parallelism (`mesh`, parallel/mesh.py, one process per GPU): each rank
runs the loss on its rows of the global batch inside
`parallel.mesh.data_parallel_step` (draws at the global batch, `dp_sum`
over the data group), and the gradients are averaged over the data group
before the global-norm clip, so `loss` and `grad_norm` are the global
batch's and N ranks take the step one process takes at the global batch.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.collectives import psum
from ..parallel.mesh import Mesh, data_parallel_step, replicate, shard_draws
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
    def update(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """One update from `grads` (one per leaf, in order); returns the
        gradients' global norm before the clip (`norm` when the caller gives
        it: a tensor-parallel step sums the split leaves over its group)."""
        norm = global_norm(grads) if norm is None else norm
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


def _local_batch(batch) -> int:
    """Rows of the (local) batch: the leading dimension of its first array."""
    for v in batch.values():
        if hasattr(v, "shape") and len(v.shape):
            return int(v.shape[0])
    return 0


def _dp_call(loss_fn, mesh: Optional[Mesh], batch, rng, *args):
    """loss_fn(*args, batch, rng) on this rank's rows, inside the
    data-parallel step context (global draws, dp_sum)."""
    if mesh is None or mesh.n_data == 1:
        return loss_fn(*args, batch, rng)
    B = _local_batch(batch)
    with data_parallel_step(mesh, rng, B):
        return loss_fn(*args, batch, shard_draws(rng, mesh, B))


def _dp_reduce(mesh: Optional[Mesh], loss, aux, grads):
    """(loss, aux, grads) averaged over the data group, in one flat buffer
    for the gradients (the global batch's gradient before the clip)."""
    if mesh is None or mesh.n_data == 1:
        return loss, aux, grads
    n, g = mesh.n_data, mesh.data_group
    with torch.no_grad():
        flat = torch.cat([x.reshape(-1).float() for x in grads])
        flat = psum(flat, g) / n
        out, off = [], 0
        for x in grads:
            out.append(flat[off:off + x.numel()].view_as(x).to(x.dtype))
            off += x.numel()
        loss = psum(loss.detach().float(), g) / n
        aux = {k: psum(torch.as_tensor(v, dtype=torch.float32, device=loss.device), g) / n
               for k, v in (aux.items() if isinstance(aux, dict) else [])}
    return loss, aux, out


def _tp_norm(mesh: Optional[Mesh], grads, leaves) -> Optional[torch.Tensor]:
    """The whole gradient's global norm under tensor parallelism (None
    without a model group: the optimizer's own)."""
    if mesh is None or mesh.n_model == 1:
        return None
    from ..parallel.tp import tp_global_norm

    return tp_global_norm(grads, leaves, mesh.model_group)


def _replicate_once(state: "TrainState", mesh: Optional[Mesh], done: List[bool]) -> None:
    """Broadcast params and EMA from the data group's first rank before the
    first step (every rank builds them from the same seed; this guards it)."""
    if done or mesh is None or mesh.n_data == 1:
        return
    replicate(state.params, mesh)
    if state.ema_params is not None:
        replicate(state.ema_params, mesh)
    done.append(True)


def make_train_step_frozen(loss_fn, ema_decay: float = 0.999, mesh: Optional[Mesh] = None):
    """step(state, frozen, batch, rng) -> (state, metrics) for
    loss_fn(params, frozen, batch, rng) -> (loss, aux dict).

    Differentiates only with respect to the leaves of state.params; `frozen`
    (e.g. a 1.3B LoRA base) is a plain argument whose tensors require no
    gradient and get none. metrics: aux, `loss`, and the pre-clip
    `grad_norm`. `rng` is whatever loss_fn draws from: a torch.Generator or
    a dict of injected draws. With `mesh`, data parallel as the module
    docstring says."""
    replicated: List[bool] = []

    def step_fn(state: TrainState, frozen, batch, rng) -> Tuple[TrainState, Dict]:
        _replicate_once(state, mesh, replicated)
        leaves = tree_leaves(state.params)
        loss, aux = _dp_call(loss_fn, mesh, batch, rng, state.params, frozen)
        grads = torch.autograd.grad(loss, leaves)
        loss, aux, grads = _dp_reduce(mesh, loss, aux, grads)
        grad_norm = state.opt_state.update(grads, _tp_norm(mesh, grads, leaves))
        ema = (ema_update(state.ema_params, state.params, ema_decay)
               if state.ema_params is not None else None)
        metrics = dict(aux) if isinstance(aux, dict) else {}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, state.opt_state, ema), metrics

    return step_fn


def _split_micro(batch: Dict, grad_accum: int) -> List[Dict]:
    """The batch cut into grad_accum microbatches along the leading axis;
    scalar entries are shared by all."""
    def cut(x, i):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        n = x.shape[0] // grad_accum
        return x[i * n:(i + 1) * n]

    return [{k: cut(v, i) for k, v in batch.items()} for i in range(grad_accum)]


def _rng_at(rng, i: int):
    """The i-th of a sequence of rngs, or the one generator for all."""
    return rng[i] if isinstance(rng, (list, tuple)) else rng


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not reach."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _loss_and_grads(loss_fn, params, batch, rng, grad_accum: int, mesh: Optional[Mesh] = None):
    """(loss, aux, grads), with microbatch accumulation when grad_accum > 1:
    loss, gradients and aux metrics are means over the microbatches. `rng`
    is then one generator, drawn from in turn, or one rng per microbatch.
    With `mesh` each rank splits its own rows into microbatches."""
    leaves = tree_leaves(params)
    if grad_accum <= 1:
        loss, aux = _dp_call(loss_fn, mesh, batch, rng, params)
        return loss.detach(), aux, _grads(loss, leaves)
    loss_sum, grads, auxes = 0.0, None, []
    for i, mb in enumerate(_split_micro(batch, grad_accum)):
        loss, aux = _dp_call(loss_fn, mesh, mb, _rng_at(rng, i), params)
        g = _grads(loss, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss_sum = loss_sum + loss.detach()
        auxes.append(aux if isinstance(aux, dict) else {})
    aux = {k: sum(a[k] for a in auxes) / grad_accum for k in auxes[0]}
    return loss_sum / grad_accum, aux, [g / grad_accum for g in grads]


def make_train_step(loss_fn, ema_decay: float = 0.999, grad_accum: int = 1,
                    mesh: Optional[Mesh] = None):
    """step(state, batch, rng) -> (state, metrics) for
    loss_fn(params, batch, rng) -> (loss, aux dict).

    With grad_accum > 1 the batch's leading axis must be divisible by
    grad_accum; the microbatches' gradients are averaged before the one
    optimizer update. metrics: aux, then `loss` and the pre-clip `grad_norm`
    (aux can never overwrite them). With `mesh`, data parallel as the
    module docstring says: `batch` holds this rank's rows."""
    replicated: List[bool] = []

    def step_fn(state: TrainState, batch: Dict, rng) -> Tuple[TrainState, Dict]:
        _replicate_once(state, mesh, replicated)
        loss, aux, grads = _loss_and_grads(loss_fn, state.params, batch, rng, grad_accum, mesh)
        loss, aux, grads = _dp_reduce(mesh, loss, aux, grads)
        grad_norm = state.opt_state.update(grads, _tp_norm(mesh, grads,
                                                           tree_leaves(state.params)))
        ema = (ema_update(state.ema_params, state.params, ema_decay)
               if state.ema_params is not None else None)
        metrics = dict(aux) if isinstance(aux, dict) else {}
        metrics["loss"] = loss
        metrics["grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, state.opt_state, ema), metrics

    return step_fn


def make_train_multi_step(loss_fn, ema_decay: float = 0.999, grad_accum: int = 1,
                          steps_per_call: int = 1, mesh: Optional[Mesh] = None):
    """S train steps per call over a superbatch whose entries have a leading
    S axis (`stack_batches`): one transfer to the device and one host
    synchronisation per S steps. Returns (state, metrics of the last step).
    `rng` is one generator, or one rng per step. A superbatch with fewer than
    S entries takes that many steps."""
    step = make_train_step(loss_fn, ema_decay, grad_accum, mesh)
    if steps_per_call <= 1:
        return step

    def multi_step(state: TrainState, superbatch: Dict, rng) -> Tuple[TrainState, Dict]:
        n = min(steps_per_call, next(iter(superbatch.values())).shape[0])
        metrics: Dict = {}
        for i in range(n):
            state, metrics = step(state, {k: v[i] for k, v in superbatch.items()},
                                  _rng_at(rng, i))
        return state, metrics

    return multi_step


def stack_batches(batches: Sequence[Dict]) -> Dict:
    """List of S batch dicts of numpy arrays -> one superbatch dict with a
    leading S axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
