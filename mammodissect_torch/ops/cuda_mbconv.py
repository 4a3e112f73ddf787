"""MBConv front half: the CUDA kernel `csrc/mbconv_expand_dw.cu` and its plain
PyTorch version.

    x [B, H, W, Cin] -> 1x1 expand -> BN1 + SiLU -> k x k stride-1 depthwise with
    SAME zeros -> BN2 + SiLU -> [B, H, W, Cexp]

Counterpart of the TPU kernel `mammodissect/ops/pallas_mbconv.py::fused_expand_dw`,
with the same layouts at the public function (NHWC activations, w_exp [Cin, Cexp],
w_dw [k, k, Cexp], folded BN scale/bias [Cexp] f32), for k in {3, 5}, any H, W,
Cin, Cexp, in float32 or bfloat16. `fused_expand_dw` launches the kernel for CUDA
tensors and runs `expand_dw_plain` for CPU tensors, and only then. The kernel has no
backward (neither has the TPU kernel): on inputs that need a gradient it raises.
`fused_expand_dw.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mammodissect_torch.ops import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(weight, bias, running_mean, running_var, eps: float = 1e-3):
    """Inference BatchNorm as y = x * scale + bias, both float32."""
    scale = weight.float() / torch.sqrt(running_var.float() + eps)
    return scale, bias.float() - running_mean.float() * scale


def expand_dw_plain(x: torch.Tensor, w_exp: torch.Tensor, bn1_scale: torch.Tensor,
                    bn1_bias: torch.Tensor, w_dw: torch.Tensor, bn2_scale: torch.Tensor,
                    bn2_bias: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: inputs and weights of x's dtype,
    computed in float32 (`F.conv2d` 1x1 -> BN -> SiLU -> round to x's dtype ->
    `F.pad` + depthwise `F.conv2d` -> BN -> SiLU), result in x's dtype."""
    dtype = x.dtype
    k = w_dw.shape[0]
    cin, cexp = w_exp.shape
    pad = (k - 1) // 2
    xc = x.float().permute(0, 3, 1, 2)  # NCHW view
    e = F.conv2d(xc, w_exp.float().t().reshape(cexp, cin, 1, 1))
    e = F.silu(e * bn1_scale[:, None, None] + bn1_bias[:, None, None])
    e = e.to(dtype).float()  # the unfused graph stores the expanded tensor in dtype
    e = F.pad(e, (pad, pad, pad, pad))
    dw = F.conv2d(e, w_dw.float().permute(2, 0, 1).reshape(cexp, 1, k, k), groups=cexp)
    y = F.silu(dw * bn2_scale[:, None, None] + bn2_bias[:, None, None])
    return y.to(dtype).permute(0, 2, 3, 1).contiguous()


def _launch(x, w_exp, bn1_scale, bn1_bias, w_dw, bn2_scale, bn2_bias):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_exp, bn1_scale, bn1_bias, w_dw, bn2_scale, bn2_bias)):
        # its output would carry no gradient: refuse rather than train on a silent zero
        raise RuntimeError("fused_expand_dw: the kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that need no gradient")
    if x.dim() != 4:
        raise ValueError(f"fused_expand_dw: x must be [B, H, W, Cin], got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    k = w_dw.shape[0]
    cexp = w_exp.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_expand_dw: dtype {x.dtype} not supported")
    if k not in (3, 5) or tuple(w_dw.shape) != (k, k, cexp):
        raise ValueError(f"fused_expand_dw: w_dw {tuple(w_dw.shape)} is not [k, k, {cexp}] "
                         "with k in (3, 5)")
    if tuple(w_exp.shape) != (cin, cexp):
        raise ValueError(f"fused_expand_dw: w_exp {tuple(w_exp.shape)} != ({cin}, {cexp})")
    if w_exp.dtype != x.dtype or w_dw.dtype != x.dtype:
        raise TypeError("fused_expand_dw: weights must have the activation dtype")
    vecs = [v.float().contiguous() for v in (bn1_scale, bn1_bias, bn2_scale, bn2_bias)]
    if any(tuple(v.shape) != (cexp,) for v in vecs):
        raise ValueError(f"fused_expand_dw: BN scale/bias must be [{cexp}]")
    tensors = [x, w_exp, w_dw, *vecs]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_expand_dw: all inputs must be on one device")
    if b > 65535:
        raise ValueError(f"fused_expand_dw: batch {b} exceeds one launch")
    x, w_exp, w_dw = x.contiguous(), w_exp.contiguous(), w_dw.contiguous()
    s1, b1, s2, b2 = vecs
    out = torch.empty((b, h, w, cexp), dtype=x.dtype, device=x.device)
    lib = kernels.load("mbconv_expand_dw")
    fn = lib.mbconv_expand_dw
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODES[x.dtype], k, x.data_ptr(), w_exp.data_ptr(), s1.data_ptr(),
                b1.data_ptr(), w_dw.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                b, h, w, cin, cexp, stream)
    kernels.check(rc, "mbconv_expand_dw")
    fused_expand_dw.launches += 1
    return out


def fused_expand_dw(x: torch.Tensor, w_exp: torch.Tensor, bn1_scale: torch.Tensor,
                    bn1_bias: torch.Tensor, w_dw: torch.Tensor, bn2_scale: torch.Tensor,
                    bn2_bias: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, Cin] -> [B, H, W, Cexp] (expand + BN + SiLU + dw kxk/s1 + BN + SiLU).

    Weights: w_exp [Cin, Cexp] and w_dw [k, k, Cexp] in x's dtype; BN scale and
    bias [Cexp] float32 (`fold_bn`). CUDA tensors go through the kernel (a launch
    error raises), CPU tensors through `expand_dw_plain`."""
    if x.device.type == "cpu":
        return expand_dw_plain(x, w_exp, bn1_scale, bn1_bias, w_dw, bn2_scale, bn2_bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_expand_dw: unsupported device {x.device}")
    return _launch(x, w_exp, bn1_scale, bn1_bias, w_dw, bn2_scale, bn2_bias)


fused_expand_dw.launches = 0
