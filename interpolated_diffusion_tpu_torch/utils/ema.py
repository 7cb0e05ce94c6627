"""Exponential moving average of a dict of parameter tensors (port of
utils/ema.py). The shadow is a dict of the same keys; `ema_update` updates it
in place under torch.no_grad()."""
from __future__ import annotations

from typing import Dict

import torch


def _map(fn, tree, *rest):
    """fn over the tensor leaves of (nested) dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def ema_init(params: Dict) -> Dict:
    """Real copies of the parameters (detached, same dtype and device)."""
    return _map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def ema_update(ema_params: Dict, params: Dict, decay: float) -> Dict:
    """shadow = decay * shadow + (1 - decay) * params, in place; returns the shadow."""
    _map(lambda e, p: e.mul_(decay).add_(p.detach(), alpha=1.0 - decay), ema_params, params)
    return ema_params
