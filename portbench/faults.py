"""Faults planted in the program underneath a run, to show that a cell's
comparison catches them: each is a context manager that patches the
program's module and restores it on exit.

- state_unchanged: the training step computes its loss and returns its state
  as it was (no update);
- half_batch: the training loss sees the first half of each batch only (the
  mean over the rest);
- altered_answer: the planner's refined paths are mirrored on their
  interior frames where they are produced (still inside [0, 1], start and
  goal kept);
- half_requests: the planner plans the first half of a call's requests and
  returns those answers for the second half too.

Not part of a benchmark run; the tests and control.py use them.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

TRAINER = "interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth"
PLANNER = "interpolated_diffusion_tpu_torch.sample.generate"


@contextlib.contextmanager
def _patched(module: str, name: str, make):
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    setattr(mod, name, make(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def _state_unchanged(real):
    def make_step(loss_fn, *args, **kwargs):
        def step(state, frozen, batch, rng):
            loss, _ = loss_fn(state.params, frozen, batch, rng)
            return state, {"loss": loss.detach()}
        return step
    return make_step


def _half_batch(real):
    def loss(wan, fc, args, schedule, batch, rng):
        return real(wan, fc, args, schedule,
                    {k: v[: v.shape[0] // 2] for k, v in batch.items()}, rng)
    return loss


def _planner(alter):
    def wrap(real):
        def make(*args, **kwargs):
            pipe = real(*args, **kwargs)
            return lambda idx, cond, **kw: alter(pipe, idx, cond, kw)
        return make
    return wrap


def _mirror(pipe, idx, cond, kw):
    x_interp, x_ref, z = pipe(idx, cond, **kw)
    x_ref = x_ref.clone()
    x_ref[:, 1:-1] = 1.0 - x_ref[:, 1:-1]
    return x_interp, x_ref, z


def _first_half(pipe, idx, cond, kw):
    h = idx.shape[0] // 2
    out = pipe(idx[:h], {k: v[:h] for k, v in cond.items()}, **{k: v[:h] for k, v in kw.items()})
    return tuple(torch.cat([o, o]) for o in out)


FAULTS = {
    "state_unchanged": lambda: _patched(TRAINER, "make_train_step_frozen", _state_unchanged),
    "half_batch": lambda: _patched(TRAINER, "phase1_loss", _half_batch),
    "altered_answer": lambda: _patched(PLANNER, "make_pipeline", _planner(_mirror)),
    "half_requests": lambda: _patched(PLANNER, "make_pipeline", _planner(_first_half)),
}
