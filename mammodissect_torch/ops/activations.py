"""Activations that compute, in bf16, the JAX package's bf16 program bit for bit.

XLA computes a bf16 elementwise op in float32 and rounds its result to bf16, one op
at a time, and the JAX activations are chains of such ops:

    jax.nn.sigmoid(x)                  1 / (1 + exp(-x))        three roundings
    jax.nn.silu(x)                     x * sigmoid(x)           four
    jax.nn.gelu(x, approximate=False)  (0.5 x) erfc(-x c)       three, c = bf16(sqrt(1/2))

`F.silu`, `torch.sigmoid` and `F.gelu` compute the whole function in float32 and
round once, which gives another bf16 value for about a third of the inputs. Here a
bf16 input in inference runs the chain as separate bf16 torch ops, each rounded as
XLA rounds it; training and other dtypes take the single torch op (`xla_bf16`).
Where the program casts a bf16 result to float32, XLA drops that result's rounding
(its excess precision): erfc
upcasts its argument, so -x c enters it unrounded. XLA's CPU backend flushes
subnormal results to zero, which the sigmoid (below -87) and erfc (above 9.2)
reach, so both are flushed here; it also reads subnormal inputs as zero and
flushes a SiLU or GELU of an input under 2^-124, which the port does not emulate
(no activation is that small)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_SQRT_HALF_BF16 = 0.70703125  # sqrt(1/2) rounded to bf16, as jax.nn.gelu casts it
_BF16_TINY = torch.finfo(torch.bfloat16).tiny


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal (non-negative) results to zero, as XLA's CPU backend flushes them."""
    return torch.where(x < _BF16_TINY, 0, x)


def _sigmoid_chain(x: torch.Tensor) -> torch.Tensor:
    return _flush(torch.reciprocal(1 + torch.exp(-x)))


def _gelu_chain(x: torch.Tensor) -> torch.Tensor:
    # erfc upcasts its argument to float32, which absorbs the product's rounding
    e = torch.erfc((-x).float() * _SQRT_HALF_BF16).to(x.dtype)
    return (0.5 * x) * _flush(e)


def xla_bf16(x: torch.Tensor) -> bool:
    """Whether a computation on `x` takes the JAX program's bf16 roundings: a bf16
    tensor in inference (autograd off). Training keeps the one-op forms: bf16 steps
    are held to JAX's within their tolerances, and the chains would multiply the
    elementwise kernels and the activations saved for the backward."""
    return x.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def silu_chain(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """`jax.nn.silu` of a bf16 tensor as XLA computes it; `rounded=False`: the
    chain's last product in float32, unrounded, as XLA computes it when the program
    casts the SiLU's result to float32."""
    if not rounded:
        return x.float() * _sigmoid_chain(x).float()
    return x * _sigmoid_chain(x)


def silu(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """x * sigmoid(x): `silu_chain` in bf16 inference (`xla_bf16`), else `F.silu`."""
    return silu_chain(x, rounded) if xla_bf16(x) else F.silu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)): in bf16 inference as `jax.nn.sigmoid`'s rounded op chain,
    else `torch.sigmoid`."""
    return _sigmoid_chain(x) if xla_bf16(x) else torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU: in bf16 inference as `jax.nn.gelu(approximate=False)`'s rounded op
    chain, else `F.gelu`."""
    return _gelu_chain(x) if xla_bf16(x) else F.gelu(x)
