"""MBConv front half: the CUDA kernel `csrc/mbconv_expand_dw.cu` and its plain
PyTorch version.

    x [B, H, W, Cin] -> 1x1 expand -> BN1 + SiLU -> k x k stride-1 depthwise with
    SAME zeros -> BN2 + SiLU -> out [B, H, W, Cexp], and squeeze [B, Cexp] float32:
    the sum over H x W of the last SiLU before its rounding to x's dtype

Counterpart of the TPU kernel `mammodissect/ops/pallas_mbconv.py::fused_expand_dw`,
with the same layouts at the public function (NHWC activations, w_exp [Cin, Cexp],
w_dw [k, k, Cexp]), for k in {3, 5}, any H, W, Cin, Cexp, in float32 or bfloat16.
Each BatchNorm comes as flax's inference terms (`bn_terms`: mean, mul = scale *
(1 / sqrt(var + eps)) and bias, float32 [Cexp]), so that the bf16 path computes
(v - mean) * mul + bias as the JAX package's bf16 program does (`batch_norm_fma`).
The squeeze is what the block's SE averages: the kernel sums it from the values it
holds, so no pass reads the expanded tensor back. Both dtypes run the expand on the
tensor cores: bf16 as bf16 products, float32 as 3xTF32 (each operand split into two
tf32 parts and three products summed in fp32), which keeps float32 accuracy under the
port's TF32-off policy (`device.set_fp32_policy`); the kernel source's note gives the
design. `fused_expand_dw` launches the kernel for CUDA tensors and runs
`expand_dw_plain` for CPU tensors, and only then. The kernel has no backward (neither
has the TPU kernel): on inputs that need a gradient it raises.
`fused_expand_dw.launches` counts the kernel's launches,
`fused_expand_dw.reduce_launches` those of its second kernel, which adds the squeeze's
tile partials (one a launch), and `fused_expand_dw.weight_launches` those of the
float32 path's first kernel, which splits the expand weights into their tf32 parts
(one a float32 launch). The bf16 kernel reads its SiLU's sigmoid from a table
(`silu_table`: built once a card by the kernel's own sigmoid, `sigmoid_bf16`, and
cached here; `silu_tab_plain` is its lookup in plain PyTorch, held to the op chain
over every bf16 value by the tests). Under a profiler each launch is a range
`kernel2.fp32` or `kernel2.bf16` (`utils.profiling.kernel_range`), by which a trace
attributes the launch's kernels.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mammodissect_torch.ops import kernels
from mammodissect_torch.ops.activations import _sigmoid_chain, silu_chain
from mammodissect_torch.utils.profiling import kernel_range

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The bf16 SiLU's table (`csrc/mbconv_expand_dw.cu`): the sigmoid r of the bf16
# magnitudes TAB_LO (the largest below 2^-8) to TAB_HI (2^7), a >= 0 and then a < 0
TAB_LO = (119 << 7) - 1
TAB_HI = 134 << 7
TAB_SPAN = TAB_HI - TAB_LO + 1
TABLE_ENTRIES = 2 * TAB_SPAN
_TABLES = {}  # CUDA device index -> its table


def fold_bn(weight, bias, running_mean, running_var, eps: float = 1e-3):
    """Inference BatchNorm as y = x * scale + bias, both float32."""
    scale = weight.float() / torch.sqrt(running_var.float() + eps)
    return scale, bias.float() - running_mean.float() * scale


def bn_terms(weight, bias, running_mean, running_var, eps: float = 1e-3):
    """Inference BatchNorm as flax computes it, (x - mean) * mul + bias: the float32
    vectors (mean, mul, bias), mul = (1 / sqrt(var + eps)) * scale (IEEE square root
    and division, the same bits on the CPU and the GPU). XLA's CPU program computes
    flax's rsqrt as the x86 `rsqrtps` estimate refined by two Newton steps, which is
    not correctly rounded (~13% of values one ulp off) and depends on the host's
    table; the port does not emulate it (PERF.md section 6)."""
    mul = torch.reciprocal(torch.sqrt(running_var.float() + eps)) * weight.float()
    return running_mean.float(), mul, bias.float()


def batch_norm_fma(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """(x - mean) * mul + bias over float32 NCHW x with [C] vectors, as XLA's CPU
    program of flax's BatchNorm computes it: the subtraction rounded, then the
    product and the sum in one fused multiply-add (LLVM contracts them), bit for bit
    where the vectors are XLA's. On the GPU `torch.addcmul` is that FMA (its CUDA
    kernel contracts a + b * c; held bit for bit by the kernel's `__fmaf_rn` in
    `chip_smoke.py` phase 5); on the CPU it is one only on some builds (AVX2 and
    AVX-512 dispatch, not the default), so there the sum is taken in float64, which
    holds the product exactly, and rounded to float32: a second rounding that moves
    the result only where the float64 sum lands on a float32 midpoint."""
    t = x - mean[:, None, None]
    mul, bias = mul[:, None, None], bias[:, None, None]
    if x.is_cuda:  # written over the difference: no third tensor of x's size
        return torch.addcmul(bias, t, mul, out=t)
    return (t.double() * mul.double() + bias.double()).float()


def expand_dw_plain(x: torch.Tensor, w_exp: torch.Tensor, bn1_mean: torch.Tensor,
                    bn1_mul: torch.Tensor, bn1_bias: torch.Tensor, w_dw: torch.Tensor,
                    bn2_mean: torch.Tensor, bn2_mul: torch.Tensor, bn2_bias: torch.Tensor):
    """The kernel's arithmetic in plain PyTorch: inputs and weights of x's dtype, the
    convolutions summed in float32 (`F.conv2d` 1x1 expand, `F.pad` + depthwise
    `F.conv2d`). Returns (out in x's dtype, squeeze [B, Cexp] float32).

    float32: expand -> BN -> SiLU -> depthwise -> BN -> SiLU, all in float32, each
    BatchNorm folded as the kernel folds it (scale mul, shift bias - mean * mul); the
    squeeze sums the output.
    bf16: the JAX MBConv block's front half as XLA compiles it at bf16: each
    convolution's float32 sums enter its BatchNorm unrounded (the BatchNorm's
    float32 promotion absorbs their rounding), the BatchNorm (`batch_norm_fma`)'s
    result is rounded, then the SiLU's op chain rounds each op
    (`ops.activations.silu_chain`); the depthwise reads the bf16 tile. The squeeze
    sums the last SiLU's product unrounded (`silu_chain(..., rounded=False)`), the
    unfused block's arithmetic for its SE. On the GPU the bf16 expand is a bf16 GEMM
    with float32 sums on the tensor cores (`torch.mm`'s out_dtype), the kernel's
    arithmetic: the two outputs then agree bit for bit (measured at every B5 shape on
    the H100, PERF.md); the squeezes agree to the float32 sums' order."""
    dtype = x.dtype
    k = w_dw.shape[0]
    b, h, w, cin = x.shape
    cexp = w_exp.shape[1]
    pad = (k - 1) // 2
    if dtype == torch.bfloat16 and x.is_cuda:
        e = torch.mm(x.reshape(-1, cin), w_exp, out_dtype=torch.float32)
        e = e.reshape(b, h, w, cexp).permute(0, 3, 1, 2)
    else:
        e = F.conv2d(x.float().permute(0, 3, 1, 2), w_exp.float().t().reshape(cexp, cin, 1, 1))
    w_dw = w_dw.float().permute(2, 0, 1).reshape(cexp, 1, k, k)
    if dtype == torch.bfloat16:
        e = silu_chain(batch_norm_fma(e, bn1_mean, bn1_mul, bn1_bias).to(dtype))
        dw = F.conv2d(F.pad(e.float(), (pad, pad, pad, pad)), w_dw, groups=cexp)
        y = silu_chain(batch_norm_fma(dw, bn2_mean, bn2_mul, bn2_bias).to(dtype), rounded=False)
        return y.to(dtype).permute(0, 2, 3, 1).contiguous(), y.sum(dim=(2, 3))
    (s1, b1), (s2, b2) = (_fold_terms(*bn) for bn in ((bn1_mean, bn1_mul, bn1_bias),
                                                       (bn2_mean, bn2_mul, bn2_bias)))
    e = F.silu(e * s1 + b1)
    e = e.to(dtype).float()  # the unfused graph stores the expanded tensor in dtype
    dw = F.conv2d(F.pad(e, (pad, pad, pad, pad)), w_dw, groups=cexp)
    y = F.silu(dw * s2 + b2)
    return y.to(dtype).permute(0, 2, 3, 1).contiguous(), y.sum(dim=(2, 3))


def silu_table_inputs(device="cpu") -> torch.Tensor:
    """The table's 3844 bf16 inputs in its order: a >= 0, then a < 0, each by
    magnitude from the largest bf16 below 2^-8 up to 2^7."""
    i = torch.arange(TABLE_ENTRIES, dtype=torch.int32)
    bits = (i // TAB_SPAN) * 0x8000 + i % TAB_SPAN + TAB_LO
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(
        torch.bfloat16).to(device)


def silu_table_index(a: torch.Tensor) -> torch.Tensor:
    """The table entry the kernel reads for each bf16 value a (int64): its bf16
    magnitude clamped to [TAB_LO, TAB_HI], less TAB_LO, plus TAB_SPAN for a < 0. r is
    constant below TAB_LO (0.5) and above TAB_HI (1, or 0 for a < 0), so the ends of
    each half hold the constants."""
    bits = a.view(torch.int16).to(torch.int32) & 0xFFFF
    return ((bits & 0x7FFF).clamp(TAB_LO, TAB_HI) - TAB_LO + (bits >> 15) * TAB_SPAN).long()


def sigmoid_bf16(a: torch.Tensor) -> torch.Tensor:
    """The bf16 SiLU's sigmoid r of bf16 values, as bf16: on the CPU the op chain
    (`ops.activations._sigmoid_chain`), on the card the kernel's own `sigmoid_bf16`
    (`mbconv_sigmoid_bf16`), the function the kernel's SiLUs compute."""
    if a.dtype != torch.bfloat16:
        raise TypeError(f"sigmoid_bf16: bf16 input, got {a.dtype}")
    if a.device.type == "cpu":
        return _sigmoid_chain(a)
    a = a.contiguous()
    r = torch.empty_like(a)
    fn = kernels.load("mbconv_expand_dw").mbconv_sigmoid_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        kernels.check(fn(a.data_ptr(), r.data_ptr(), a.numel(),
                         torch.cuda.current_stream().cuda_stream), "mbconv_sigmoid_bf16")
    return r


def silu_table(device) -> torch.Tensor:
    """The kernel's SiLU table [3844] bf16 on `device`: `sigmoid_bf16` of
    `silu_table_inputs`. A CUDA device's is built once, by the kernel's own sigmoid,
    and kept (the card's bits, whatever its exponential gives); the CPU's is the op
    chain's, the reference the tests and `chip_smoke.py` hold it to."""
    device = torch.device(device)
    if device.type == "cpu":
        return sigmoid_bf16(silu_table_inputs())
    index = device.index if device.index is not None else torch.cuda.current_device()
    table = _TABLES.get(index)
    if table is None:
        table = sigmoid_bf16(silu_table_inputs(torch.device("cuda", index)))
        torch.cuda.synchronize(index)  # a launch on another stream may read it next
        _TABLES[index] = table
    return table


def silu_tab_plain(a: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The kernel's SiLU of bf16 values a read from `table`, in plain PyTorch: the
    product a * r unrounded (float32; exact, a bf16 times a bf16), r the entry
    `silu_table_index` selects; Inf and NaN take the op chain. Rounded to bf16 it is
    the output, unrounded the value the squeeze sums."""
    special = (a.view(torch.int16).to(torch.int32) & 0x7F80) == 0x7F80
    r = table.float()[silu_table_index(a)]
    return torch.where(special, silu_chain(a, rounded=False), a.float() * r)


def _fold_terms(mean, mul, bias):
    """The float32 path's BatchNorm as the kernel folds it: [C, 1, 1] scale and shift."""
    return mul[:, None, None], (bias - mean * mul)[:, None, None]


def _launch(x, w_exp, m1, mul1, b1, w_dw, m2, mul2, b2):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_exp, m1, mul1, b1, w_dw, m2, mul2, b2)):
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
    vecs = [v.float().contiguous() for v in (m1, mul1, b1, m2, mul2, b2)]
    if any(tuple(v.shape) != (cexp,) for v in vecs):
        raise ValueError(f"fused_expand_dw: BN mean/mul/bias must be [{cexp}]")
    tensors = [x, w_exp, w_dw, *vecs]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_expand_dw: all inputs must be on one device")
    chunk = 65535  # images a launch (the grid's batch dimension)
    x, w_exp, w_dw = x.contiguous(), w_exp.contiguous(), w_dw.contiguous()
    lib = kernels.load("mbconv_expand_dw")
    code = _DTYPE_CODES[x.dtype]
    tiles, cpad = lib.mbconv_expand_dw_tiles(code, h, w), lib.mbconv_expand_dw_channels(cexp)
    weight_floats = lib.mbconv_expand_dw_weight_floats
    weight_floats.argtypes = [ctypes.c_int] * 3
    weight_floats.restype = ctypes.c_int64
    out = torch.empty((b, h, w, cexp), dtype=x.dtype, device=x.device)
    squeeze = torch.empty((b, cexp), dtype=torch.float32, device=x.device)
    partials = torch.empty((min(b, chunk), tiles, cpad), dtype=torch.float32, device=x.device)
    # float32: the expand weights' two tf32 parts, written by the launch's first kernel
    n_prep = weight_floats(code, cin, cexp)
    wprep = torch.empty(n_prep, dtype=torch.float32, device=x.device) if n_prep else None
    wprep_ptr = None if wprep is None else wprep.data_ptr()  # wprep stays referenced
    table = silu_table(x.device).data_ptr() if x.dtype == torch.bfloat16 else None
    fn = lib.mbconv_expand_dw
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    name = "kernel2.fp32" if x.dtype == torch.float32 else "kernel2.bf16"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, b, chunk):
            n = min(chunk, b - i)
            with kernel_range(name):
                rc = fn(code, k, x[i].data_ptr(), w_exp.data_ptr(),
                        *(v.data_ptr() for v in vecs[:3]), w_dw.data_ptr(),
                        *(v.data_ptr() for v in vecs[3:]), out[i].data_ptr(),
                        squeeze[i].data_ptr(), partials.data_ptr(), wprep_ptr, table, n, h, w,
                        cin, cexp, stream)
            kernels.check(rc, "mbconv_expand_dw")
            if h and w and cexp:
                fused_expand_dw.launches += 1
                fused_expand_dw.reduce_launches += 1
                if x.dtype == torch.float32:
                    fused_expand_dw.weight_launches += 1
    return out, squeeze


def fused_expand_dw(x: torch.Tensor, w_exp: torch.Tensor, bn1_mean: torch.Tensor,
                    bn1_mul: torch.Tensor, bn1_bias: torch.Tensor, w_dw: torch.Tensor,
                    bn2_mean: torch.Tensor, bn2_mul: torch.Tensor, bn2_bias: torch.Tensor):
    """x [B, H, W, Cin] -> (out [B, H, W, Cexp], squeeze [B, Cexp] float32): expand +
    BN + SiLU + dw kxk/s1 + BN + SiLU, and the last SiLU summed over H x W before its
    rounding (the SE's mean times H W).

    Weights: w_exp [Cin, Cexp] and w_dw [k, k, Cexp] in x's dtype; each BatchNorm as
    its mean, mul and bias [Cexp] float32 (`bn_terms`). CUDA tensors go through the
    kernel (a launch error raises), CPU tensors through `expand_dw_plain`."""
    args = (x, w_exp, bn1_mean, bn1_mul, bn1_bias, w_dw, bn2_mean, bn2_mul, bn2_bias)
    if x.device.type == "cpu":
        return expand_dw_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_expand_dw: unsupported device {x.device}")
    return _launch(*args)


fused_expand_dw.launches = 0
fused_expand_dw.reduce_launches = 0
fused_expand_dw.weight_launches = 0
