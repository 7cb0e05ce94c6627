"""Training state, optimizer and the train steps (port of train/state.py).

`make_optimizer` is AdamW behind a global-norm clip, held to optax's
arithmetic: the clip scales by clip / max(norm, clip) (not torch's
clip / (norm + 1e-6)); AdamW decays every leaf, eps 1e-8 outside the root;
the learning rate of update n (from 0) is schedule(n). `optimizer="muon"` is
optax.contrib.muon (optax 0.2.6) behind the same clip, written out
(`Muon`): the leaves whose JAX leaf is a matrix take Nesterov momentum
orthogonalised by Newton-Schulz, every other leaf NAdamW. `make_train_step_frozen`
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

from ..models.jax_import import matrix_layout
from ..parallel.collectives import psum
from ..parallel.mesh import Mesh, data_parallel_step, replicate, shard_draws
from ..utils.ema import ema_init, ema_update
from ..utils.profiling import span

STEP, FORWARD, BACKWARD, OPTIMIZER = ("idt.train.step", "idt.train.forward",
                                      "idt.train.backward", "idt.train.optimizer")


class TrainState(NamedTuple):
    step: int
    params: Dict[str, Any]          # (nested) dict of trainable leaf tensors
    opt_state: "Optimizer | Muon"
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


NS_COEFFS = (3.4445, -4.7750, 2.0315)   # optax.contrib.muon's quintic Newton-Schulz


def _f32_pow(base: float, count: int) -> torch.Tensor:
    """base ** count in f32 as XLA computes optax's bias corrections: the f32
    base raised in f64 and rounded once (f32 repeated products differ by an
    ulp, which 1 - 0.999 ** count turns into 2e-5 of nu_hat at count 3)."""
    return torch.tensor(float(np.float32(base)) ** count, dtype=torch.float32)


def newton_schulz(x: torch.Tensor, steps: int = 5, eps: float = 1e-8) -> torch.Tensor:
    """optax.contrib.orthogonalize_via_newton_schulz of one matrix in the JAX
    orientation [reduction, output]: Frobenius-normalised, then `steps`
    quintic iterations, on the transpose when rows > cols."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + eps)
    c0, c1, c2 = NS_COEFFS
    for _ in range(steps):
        a = x @ x.T
        b = c1 * a + c2 * a @ a
        x = c0 * x + b @ x
    return x.T if transposed else x


class Muon:
    """Global-norm clip + optax.contrib.muon over named leaves, in place.

    Labels follow the JAX leaves (models/jax_import.matrix_layout): a
    leaf whose JAX leaf is 2-D takes Muon, in that leaf's
    orientation (reduction axis 0, output axis 1): Nesterov momentum (beta
    0.95, bias corrections at count+1 and count+2), Newton-Schulz, the scale
    sqrt(max(1, out / in)), no weight decay (the JAX trainers set only
    adam_weight_decay). Every other leaf takes optax.adamw(nesterov=True, eps
    1e-8) with `weight_decay`: NAdamW, not torch's AdamW. State: the count
    and the moments by name (`state_dict` round-trips)."""

    beta, b1, b2, eps = 0.95, 0.9, 0.999, 1e-8   # optax.contrib.muon's defaults

    def __init__(self, named: Dict[str, torch.Tensor], lr_schedule: Callable[[int], float],
                 weight_decay: float, grad_clip: float):
        self.names, self.params = list(named), list(named.values())
        self.layouts = [matrix_layout(n, tuple(p.shape)) for n, p in named.items()]
        self.labels = {n: "adam" if lay is None else "muon"
                       for n, lay in zip(self.names, self.layouts)}
        self.lr_schedule, self.weight_decay, self.grad_clip = lr_schedule, weight_decay, grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [None if lay else torch.zeros_like(p) for p, lay in zip(self.params, self.layouts)]

    @staticmethod
    def _to_jax(x: torch.Tensor, layout: str) -> torch.Tensor:
        return x.reshape(x.shape[0], -1).T if layout == "T" else x

    def _muon(self, g, mu, layout, c1, c2) -> torch.Tensor:
        b = self.beta
        mu.copy_((1 - b) * g + b * mu)
        mu_hat = b * (mu / (1 - _f32_pow(b, c2))) + (1 - b) * (g / (1 - _f32_pow(b, c1)))
        x = newton_schulz(self._to_jax(mu_hat, layout), eps=self.eps)
        x = math.sqrt(max(1.0, x.shape[1] / x.shape[0])) * x
        return (x.T.reshape(g.shape) if layout == "T" else x)

    def _nadamw(self, g, p, mu, nu, c1, c2) -> torch.Tensor:
        b1, b2 = self.b1, self.b2
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        mu_hat = b1 * (mu / (1 - _f32_pow(b1, c2))) + (1 - b1) * (g / (1 - _f32_pow(b1, c1)))
        nu_hat = nu / (1 - _f32_pow(b2, c1))
        return mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * p

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """One update from `grads` (one per leaf, in order); returns the
        gradients' global norm before the clip (optax's clip: g / norm * clip
        when norm >= clip)."""
        norm = global_norm(grads) if norm is None else norm
        lr = self.lr_schedule(self.count)
        c1, c2 = self.count + 1, self.count + 2
        for p, g, mu, nu, layout in zip(self.params, grads, self.mu, self.nu, self.layouts):
            g = g.to(p.dtype)
            g = torch.where(norm < self.grad_clip, g, (g / norm.to(g.dtype)) * self.grad_clip)
            u = (self._muon(g, mu, layout, c1, c2) if layout
                 else self._nadamw(g, p, mu, nu, c1, c2))
            p.add_(u * (-lr))
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": {n: m.detach().clone() for n, m in zip(self.names, self.mu)},
                "nu": {n: v.detach().clone() for n, v in zip(self.names, self.nu) if v is not None}}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for n, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state["mu"][n])
            if v is not None:
                v.copy_(state["nu"][n])


def make_optimizer(lr: float, weight_decay: float = 1e-2, grad_clip: float = 1.0,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   schedule: str = "constant", optimizer: str = "adamw"
                   ) -> Callable[[Dict], "Optimizer | Muon"]:
    """tx(params) -> optimizer over the leaves of `params`, behind a global-norm
    clip, with a constant, warm-up or warm-up + cosine schedule: AdamW, or
    Muon (its leaves labelled by their names, `Muon`)."""
    if optimizer not in ("adamw", "muon"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    sched = make_lr_schedule(lr, warmup_steps, total_steps, schedule)
    if optimizer == "muon":
        return lambda params: Muon(flatten_dict(params), sched, weight_decay, grad_clip)
    return lambda params: Optimizer(tree_leaves(params), sched, weight_decay, grad_clip)


def init_train_state(params: Dict, tx: Callable[[Dict], "Optimizer | Muon"],
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


def _optimize(state: TrainState, grads, norm: Optional[torch.Tensor], ema_decay: float):
    """The optimizer's update and the EMA: (pre-clip grad norm, new EMA)."""
    with span(OPTIMIZER):
        grad_norm = state.opt_state.update(grads, norm)
        ema = (ema_update(state.ema_params, state.params, ema_decay)
               if state.ema_params is not None else None)
    return grad_norm, ema


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
        with span(STEP):
            _replicate_once(state, mesh, replicated)
            leaves = tree_leaves(state.params)
            with span(FORWARD):
                loss, aux = _dp_call(loss_fn, mesh, batch, rng, state.params, frozen)
            with span(BACKWARD):
                grads = torch.autograd.grad(loss, leaves)
            loss, aux, grads = _dp_reduce(mesh, loss, aux, grads)
            grad_norm, ema = _optimize(state, grads, _tp_norm(mesh, grads, leaves), ema_decay)
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
        with span(FORWARD):
            loss, aux = _dp_call(loss_fn, mesh, batch, rng, params)
        with span(BACKWARD):
            grads = _grads(loss, leaves)
        return loss.detach(), aux, grads
    loss_sum, grads, auxes = 0.0, None, []
    for i, mb in enumerate(_split_micro(batch, grad_accum)):
        with span(FORWARD):
            loss, aux = _dp_call(loss_fn, mesh, mb, _rng_at(rng, i), params)
        with span(BACKWARD):
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
        with span(STEP):
            _replicate_once(state, mesh, replicated)
            loss, aux, grads = _loss_and_grads(loss_fn, state.params, batch, rng, grad_accum,
                                               mesh)
            loss, aux, grads = _dp_reduce(mesh, loss, aux, grads)
            grad_norm, ema = _optimize(state, grads,
                                       _tp_norm(mesh, grads, tree_leaves(state.params)),
                                       ema_decay)
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
