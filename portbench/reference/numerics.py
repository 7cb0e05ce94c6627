"""Matrix products of the plain references, in float32 or in the control's
float8.

"f32": float32 products with TF32 off (the reference proper). "fp8": every
product's two operands rounded to float8 e4m3 with a per-tensor scale
(amax -> 448), then multiplied in float32: the reference computed one
precision below the configurations' bfloat16, which the benchmark's
comparison has to fail. Gradients pass the rounding straight through.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach() if x.requires_grad else q


class Numerics:
    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r} not in ('f32', 'fp8')")
        self.precision = precision

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.precision == "fp8" else x

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        return F.linear(self._q(x.float()), self._q(w.float()), None if b is None else b.float())

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._q(a.float()) @ self._q(b.float())

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self._q(a.float()), self._q(b.float()))

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self._q(x.float()), self._q(w.float()), b.float(), padding=1)


def strict_f32() -> None:
    """No TF32 anywhere: a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
