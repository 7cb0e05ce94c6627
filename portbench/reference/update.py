"""The references' update for the cells whose reference brings a loss of its
own: len(batches) steps of a global-norm clip and AdamW over the trainable
leaves of a weight dict (wan_ref.train_steps' arithmetic: betas 0.9 / 0.999,
eps 1e-8, decoupled weight decay)."""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from portbench.reference import wan_ref


def adamw_steps(P: Dict[str, torch.Tensor], cfg: Dict, batches: Sequence[Dict],
                draws: Sequence[Dict], loss_fn: Callable[[Dict, Dict], torch.Tensor]
                ) -> Dict[str, object]:
    """Upcasts the trainable leaves of P (wan_ref.is_trainable) to float32
    leaves that require gradients, then steps them on loss_fn(batch, draws).
    Returns the losses, the first step's clipped gradient per trainable leaf,
    and each leaf's change over the steps (norms, float)."""
    names = [n for n in P if wan_ref.is_trainable(n)]
    for n in names:
        P[n] = P[n].detach().float().clone().requires_grad_(True)
    start = {n: P[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    lr, wd, clip = cfg["lr"], cfg["weight_decay"], cfg["grad_clip"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad0 = [], {}
    for step, (batch, dr) in enumerate(zip(batches, draws), start=1):
        loss = loss_fn(batch, dr)
        grads = torch.autograd.grad(loss, [P[n] for n in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            scale = clip / torch.clamp(norm, min=clip)
            for n, g in zip(names, grads):
                g = g * scale
                if step == 1:
                    grad0[n] = float(g.norm())
                P[n].mul_(1.0 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** step)).sqrt() + eps
                P[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** step))
        del grads, loss
    change = {n: float((P[n].detach() - start[n]).norm()) for n in names}
    return {"losses": losses, "grad": grad0, "change": change}
