"""Kernel 2's function in float64, and one pass of the tensor cores' tf32 arithmetic
emulated, for the float32 precision tests (`test_torch_mbconv.py` on the CPU,
`test_torch_gpu.py` on the card). Imports torch and numpy only: the GPU tests run
without JAX.

    python tests/_mbconv_f64.py [cuda]

prints, at each precision-test shape, the largest |err| / (1 + |x|) against float64 of
one tf32 pass (emulated) and of float32 products (the plain version) on the CPU, and
with `cuda` of the fp32 kernel on the card."""
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

# atol and rtol against float64: the 3xTF32 expand meets it, one tf32 pass does not
F64_TOL = 1e-5
# (k, H, W, Cin, Cexp) of the precision tests: odd widths, B5's and V2's deep blocks,
# and the kernel's strips and segments with a ragged last strip (121 = 3 strips of 41,
# 41, 39; 70 = 2 of 35; 37 and 33 rows = 2 segments each; 48 positions a step)
PRECISION_SHAPES = [(3, 38, 29, 40, 240), (5, 19, 17, 64, 384), (5, 13, 11, 20, 120),
                    (3, 21, 19, 24, 144), (5, 17, 18, 56, 104), (3, 48, 29, 512, 3072),
                    (5, 48, 29, 304, 1824), (3, 37, 121, 40, 240), (5, 33, 70, 64, 384)]


def expand_dominant_args(b, h, w, cin, cexp, k, dtype, device, seed=6):
    """x and the expand at unit scale, depthwise weights ~1/K^2 and no BN2 mean or
    bias: each output is about the mean of its window's expanded values, so a fault
    of the expand (a dropped channel chunk, a wrong tail tile, a lost tf32 part)
    moves it past the tolerance. Inputs and weights in `dtype`; each BatchNorm as
    (mean, mul, bias)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    def pos(n):
        return torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)

    x, w_exp = t(b, h, w, cin).to(dtype), t(cin, cexp, scale=cin ** -0.5).to(dtype)
    mul1, bias1 = pos(cexp), t(cexp, scale=0.1)
    w_dw = ((1.0 + t(k, k, cexp, scale=0.1)) / k ** 2).to(dtype)
    mul2, zeros = pos(cexp), torch.zeros(cexp, device=device)
    return x, w_exp, t(cexp, scale=0.1), mul1, bias1, w_dw, zeros, mul2, zeros


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 as `cvt.rna.tf32.f32`: 10 mantissa bits, nearest, ties away
    from zero (the magnitude bits rounded half up), kept in a float32 tensor."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def expand_dw_f64(x, w_exp, m1, mul1, b1, w_dw, m2, mul2, b2, one_tf32_pass=False):
    """expand -> BN1 + SiLU -> k x k depthwise (SAME zeros) -> BN2 + SiLU on NHWC
    float32 inputs, in float64, each BatchNorm (v - mean) * mul + bias. With
    `one_tf32_pass` the expand is one pass of the tensor cores' arithmetic instead,
    the rest staying float64: operands rounded to tf32 and their exact products
    summed in float32."""
    k = w_dw.shape[0]
    cexp = w_exp.shape[1]
    pad = (k - 1) // 2
    if one_tf32_pass:
        e = (tf32(x) @ tf32(w_exp)).double()
    else:
        e = x.double() @ w_exp.double()
    e = F.silu((e - m1.double()) * mul1.double() + b1.double()).permute(0, 3, 1, 2)
    dw = F.conv2d(F.pad(e, (pad, pad, pad, pad)),
                  w_dw.double().permute(2, 0, 1).reshape(cexp, 1, k, k), groups=cexp)
    m2, mul2, b2 = (v.double()[:, None, None] for v in (m2, mul2, b2))
    y = F.silu((dw - m2) * mul2 + b2)
    return y.permute(0, 2, 3, 1)


def within_f64_tol(got, want):
    return relative_err(got, want) <= F64_TOL


def relative_err(got, want):
    """The largest |got - want| / (1 + |want|): the quantity F64_TOL bounds."""
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def main(argv):
    from mammodissect_torch.ops.cuda_mbconv import expand_dw_plain, fused_expand_dw

    on_card = "cuda" in argv
    for k, h, w, cin, cexp in PRECISION_SHAPES:
        args = expand_dominant_args(2, h, w, cin, cexp, k, torch.float32, "cpu")
        want = expand_dw_f64(*args)
        row = {"one tf32 pass": relative_err(expand_dw_f64(*args, one_tf32_pass=True), want),
               "float32": relative_err(expand_dw_plain(*args)[0].double(), want)}
        if on_card:
            got = fused_expand_dw(*(a.cuda() for a in args))[0].double().cpu()
            row["kernel"] = relative_err(got, want)
        print(f"k{k} {cin}->{cexp} @ {h}x{w}: "
              + ", ".join(f"{name} {err:.3g}" for name, err in row.items()), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1:])
