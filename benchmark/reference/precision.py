"""The precisions below float32 that the control runs emulate, for the operands of a
product (a convolution or a matrix product), which then accumulates in float32.

- "tf32": each operand rounded to TF32 (10 explicit mantissa bits, round to nearest,
  ties away from zero as the tensor cores' conversion), what a float32 product does
  with TF32 on.
- "fp8": each operand scaled per tensor so that its largest magnitude is e4m3's 448,
  rounded to float8 e4m3, and scaled back, what an fp8 inference path does; under
  autograd the gradient that flows back through it is rounded the same way to e5m2
  (largest 57344), as fp8 training rounds its gradients.
- None: float32 as it is."""
from __future__ import annotations

from typing import Optional

import torch

FP8_MAX = 448.0
E5M2_MAX = 57344.0


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32).view_as(x)


def _scaled(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / largest, torch.ones((), device=x.device))
    return (x / scale).to(dtype).float() * scale


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    return _scaled(x, torch.float8_e4m3fn, FP8_MAX)


class _FP8(torch.autograd.Function):
    """e4m3 forward, the incoming gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return to_fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _scaled(grad, torch.float8_e5m2, E5M2_MAX)


def lower(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """x rounded to `mode`. Under autograd TF32 passes the gradient through unchanged
    (a straight-through estimator); fp8 rounds it to e5m2."""
    if mode is None:
        return x
    if mode not in ("tf32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    if mode == "fp8":
        return _FP8.apply(x) if x.requires_grad else to_fp8(x)
    q = to_tf32(x.detach())
    return x + (q - x).detach() if x.requires_grad else q
