"""The bf16 tower's BatchNorm epilogue: the CUDA kernel `csrc/bn_epilogue.cu` (kernel 3)
and its plain PyTorch version.

    v [B, C, H, W] float32, a convolution's sums -> BatchNorm -> bf16 ->
    act: None: out bf16; "silu": the bf16 SiLU, out bf16; "silu_f32": the SiLU's
    last product unrounded, out float32; and with `squeeze` (act "silu") the SE's
    squeeze [B, C] float32: the sum over H x W of that product unrounded

It computes, at every conv -> BatchNorm site of the bf16 inference tower that kernel 2
does not cover, what the JAX package's bf16 program computes there as XLA compiles it:
the BatchNorm as flax's (mean, mul, bias) (`bn_terms`, `batch_norm_fma`) rounded to
bf16, then XLA's rounded SiLU chain (`ops.activations.silu_chain`), in one pass that
reads each float32 sum once and writes each output once. It replaces no TPU kernel
(XLA fuses these chains into the convolution); the kernel source's note gives its
bound and design. `bn_epilogue_plain` is the ATen chain the tower ran before, the CPU
path and the version the tests hold the kernel to, bit for bit.

`bn_epilogue` launches the kernel for every CUDA tensor (sums in another memory
format are first copied to channels_last, an NHWC buffer), runs `bn_epilogue_plain`
for CPU tensors and raises for other devices. With `squeeze` the
kernel also writes the SiLU's float32 product, and the squeeze is ATen's sum of it, the
plain version's own reduction, so that the squeeze keeps its bits too. The kernel reads
the bf16 SiLU's sigmoid from kernel 2's table (`ops.cuda_mbconv.silu_table`) and has no
backward: on inputs that need a gradient it raises. `bn_epilogue.launches` counts its
launches and `bn_epilogue.squeeze_launches` those with a squeeze. Under a profiler each
launch is a range `kernel3.bf16` (`utils.profiling.kernel_range`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mammodissect_torch.ops import kernels
from mammodissect_torch.ops.activations import silu_chain
from mammodissect_torch.ops.cuda_mbconv import batch_norm_fma, silu_table
from mammodissect_torch.utils.profiling import kernel_range

ACTS = (None, "silu", "silu_f32")
KERNEL_DEVICE = "cuda"  # the device type whose tensors the kernel takes


def bn_epilogue_plain(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                      bias: torch.Tensor, act: Optional[str] = None,
                      squeeze: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The ATen chain: `batch_norm_fma` of the float32 sums v, rounded to bf16; with
    `squeeze`, the SiLU's product summed over H x W unrounded; then the SiLU's op chain
    (rounded for "silu", its last product in float32 for "silu_f32"). Returns (out,
    the squeeze or None)."""
    y = batch_norm_fma(v, mean, mul, bias).to(torch.bfloat16)
    s = silu_chain(y, rounded=False).sum(dim=(2, 3)) if squeeze else None
    if act is not None:
        y = silu_chain(y, rounded=act == "silu")
    return y, s


def _launch(v, mean, mul, bias, act, squeeze):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (v, mean, mul, bias)):
        raise RuntimeError("bn_epilogue: the kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that need no gradient")
    if v.dim() != 4 or v.dtype != torch.float32:
        raise ValueError(f"bn_epilogue: v must be float32 [B, C, H, W], got {v.dtype} "
                         f"{tuple(v.shape)}")
    v = v.contiguous(memory_format=torch.channels_last)  # the kernel reads NHWC
    b, c, h, w = v.shape
    terms = [t.float().contiguous() for t in (mean, mul, bias)]
    if any(tuple(t.shape) != (c,) or t.device != v.device for t in terms):
        raise ValueError(f"bn_epilogue: mean, mul and bias must be [{c}] on {v.device}")
    vec = 4 if c % 4 == 0 and v.data_ptr() % 16 == 0 else 1

    def nhwc(dtype):  # an output [B, C, H, W] in channels_last memory
        return torch.empty((b, h, w, c), dtype=dtype, device=v.device).permute(0, 3, 1, 2)

    out = None if act == "silu_f32" else nhwc(torch.bfloat16)
    prod = nhwc(torch.float32) if act == "silu_f32" or squeeze else None
    table = silu_table(v.device) if act is not None else None  # referenced until the return
    fn = kernels.load("bn_epilogue").bn_epilogue
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int64,
                                                                ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(v.device):
        with kernel_range("kernel3.bf16"):
            rc = fn(int(act is not None), vec, v.data_ptr(), *(t.data_ptr() for t in terms),
                    None if table is None else table.data_ptr(),
                    None if out is None else out.data_ptr(),
                    None if prod is None else prod.data_ptr(), b, h * w, c,
                    torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "bn_epilogue")
    bn_epilogue.launches += 1
    bn_epilogue.squeeze_launches += int(squeeze)
    return (prod if out is None else out), (prod.sum(dim=(2, 3)) if squeeze else None)


def bn_epilogue(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                act: Optional[str] = None,
                squeeze: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The BatchNorm epilogue of float32 sums v [B, C, H, W] with flax's terms (mean,
    mul, bias [C] float32, `bn_terms`): (out, the squeeze or None), as
    `bn_epilogue_plain` computes them. `act`: None, "silu" or "silu_f32"; `squeeze`
    only with "silu". CUDA tensors go through the kernel (a launch error raises), CPU
    tensors through `bn_epilogue_plain`. `out` is channels_last."""
    if act not in ACTS:
        raise ValueError(f"bn_epilogue: act must be one of {ACTS}, got {act!r}")
    if squeeze and act != "silu":
        raise ValueError("bn_epilogue: the squeeze sums the bf16 SiLU's product: act 'silu'")
    if v.device.type == KERNEL_DEVICE:
        return _launch(v, mean, mul, bias, act, squeeze)
    if v.device.type == "cpu":
        return bn_epilogue_plain(v, mean, mul, bias, act, squeeze)
    raise ValueError(f"bn_epilogue: unsupported device {v.device}")


bn_epilogue.launches = 0
bn_epilogue.squeeze_launches = 0
