"""The products of the plain reference, in float32 or in a lower precision.

`Products("f32")` computes every convolution and matrix product in float32 (the caller
turns TF32 off on the card). `Products("fp8")` is the control of a bfloat16 model, whose
forward runs and stores its activations in bfloat16: each operand of every product, and
each activation the model keeps between its layers (`act`: the residual stream, a block's
output), is rounded to float8 e4m3 with one scale per tensor (its largest magnitude at 448,
e4m3's largest finite value), and the product runs in float32, as an fp8 product with an
f32 accumulator computes it; in a backward pass the gradient reaching each rounded tensor is
rounded to float8 e5m2 the same way (fp8 training's two formats). fp8 is the precision next
below bfloat16, the configuration's. `Products("bf16")` rounds the same tensors (and their
gradients) to bfloat16: the control of a float32 model, or a witness of a bfloat16 one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp8_round(t: torch.Tensor, dtype=torch.float8_e4m3fn, top=E4M3_MAX) -> torch.Tensor:
    """t rounded to an fp8 format with one scale per tensor (no gradient of its own)."""
    t = t.detach().float()
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Round(torch.autograd.Function):
    """Forward: the operand rounded; backward: its gradient rounded (fp8: e5m2)."""

    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        if precision == "fp8":
            return fp8_round(t)
        return t.detach().to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        if ctx.precision == "fp8":
            return fp8_round(g, torch.float8_e5m2, E5M2_MAX), None
        return g.to(torch.bfloat16).float(), None


class Products:
    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return t.float()
        return _Round.apply(t.float(), self.precision)

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation the model keeps between layers, in the working precision."""
        return t if self.precision == "f32" else _Round.apply(t.float(), self.precision)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b.float()

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(), stride, padding,
                        1, groups)
