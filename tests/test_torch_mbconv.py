"""Kernel 2 of the PyTorch port: the MBConv front half
(`mammodissect_torch/ops/cuda_mbconv.py`) against the JAX package's XLA twin and
Pallas kernel (interpret mode) in bf16, against the JAX MBConvBlock's front half
for k3 and k5 in f32 and in bf16, and its squeeze against the SE's mean of JAX's
bf16 block (the kernel itself against its plain version runs in
test_torch_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammodissect.ops.pallas_mbconv import fold_bn as jax_fold_bn
from mammodissect.ops.pallas_mbconv import fused_expand_dw as jax_fused_expand_dw
from mammodissect.ops.pallas_mbconv import xla_expand_dw
from mammodissect_torch.ops.activations import _sigmoid_chain, silu_chain
from mammodissect_torch.ops.cuda_mbconv import (
    TAB_HI,
    TAB_LO,
    TAB_SPAN,
    TABLE_ENTRIES,
    bn_terms,
    expand_dw_plain,
    fold_bn,
    fused_expand_dw,
    silu_tab_plain,
    silu_table,
    silu_table_index,
    silu_table_inputs,
)

BF16_TOL = dict(atol=2e-3, rtol=2e-2)  # bf16 in/out, f32 accumulation, other sum order
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _setup(b=2, h=38, w=28, cin=40, cexp=240, k=5, seed=0):
    """(x, w_exp, w_dw, [BN1, BN2] as (scale, bias, mean, var)) as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32) * 0.1
    w_exp = rng.normal(size=(cin, cexp)).astype(np.float32) * 0.05
    w_dw = rng.normal(size=(k, k, cexp)).astype(np.float32) * 0.05
    bns = [tuple(a.astype(np.float32) for a in (
        rng.uniform(0.5, 1.5, cexp), rng.normal(size=cexp) * 0.1,
        rng.normal(size=cexp) * 0.1, rng.uniform(0.5, 1.5, cexp))) for _ in range(2)]
    return x, w_exp, w_dw, bns


def _torch_args(setup, dtype):
    """The port's arguments: each BatchNorm as its (mean, mul, bias) terms."""
    x, w_exp, w_dw, bns = setup
    (m1, mul1, b1), (m2, mul2, b2) = (bn_terms(*(torch.from_numpy(a) for a in bn)) for bn in bns)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(w_exp).to(dtype), m1, mul1, b1,
            torch.from_numpy(w_dw).to(dtype), m2, mul2, b2)


def _jax_bf16(setup):
    """The JAX twins' arguments: each BatchNorm folded (`pallas_mbconv.fold_bn`)."""
    x, w_exp, w_dw, bns = setup
    (s1, b1), (s2, b2) = (jax_fold_bn(*bn) for bn in bns)
    return jnp.asarray(x, jnp.bfloat16), w_exp, s1, b1, w_dw, s2, b2


def test_plain_bf16_matches_xla_and_pallas():
    """The JAX twins fold each BatchNorm, the port takes flax's unfolded terms: both
    within BF16_TOL."""
    args = _setup()
    want_xla = np.asarray(xla_expand_dw(*_jax_bf16(args)), np.float32)
    want_pallas = np.asarray(jax_fused_expand_dw(*_jax_bf16(args), t=19, interpret=True),
                             np.float32)
    got, _ = expand_dw_plain(*_torch_args(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == want_xla.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_xla, **BF16_TOL)
    np.testing.assert_allclose(got, want_pallas, **BF16_TOL)


def test_plain_bf16_border_rows():
    """SAME zeros at the image border: a wrong halo mask shows as O(bn bias) drift
    on the first and last rows and columns."""
    args = _setup(b=1, h=19, w=28)
    want = np.asarray(xla_expand_dw(*_jax_bf16(args)), np.float32)
    got = expand_dw_plain(*_torch_args(args, torch.bfloat16))[0].float().numpy()
    for sl in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
        np.testing.assert_allclose(got[sl], want[sl], **BF16_TOL)


def test_wrapper_on_cpu_is_plain_and_launches_nothing():
    args = _torch_args(_setup(b=1, h=9, w=7, cin=8, cexp=16, k=3), torch.float32)
    counters = ("launches", "reduce_launches", "weight_launches")
    before = [getattr(fused_expand_dw, c) for c in counters]
    got = fused_expand_dw(*args)
    assert [getattr(fused_expand_dw, c) for c in counters] == before
    for g, w in zip(got, expand_dw_plain(*args)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("k,h,w", [(3, 11, 7), (5, 9, 13)])
def test_plain_f32_matches_jax_mbconv_front_half(k, h, w):
    """The front half of the JAX MBConvBlock (expand -> bn0 -> silu -> depthwise ->
    bn1 -> silu; `efficientnet.py:217-233`) at f32 with the same weights."""
    from flax import linen as nn

    cin, cexp = 8, 48
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    w_exp = rng.normal(size=(1, 1, cin, cexp)).astype(np.float32) * 0.3
    w_dw = rng.normal(size=(k, k, 1, cexp)).astype(np.float32) * 0.3
    bns = [dict(scale=rng.uniform(0.5, 1.5, cexp), bias=rng.normal(size=cexp) * 0.1,
                mean=rng.normal(size=cexp) * 0.1, var=rng.uniform(0.5, 1.5, cexp))
           for _ in range(2)]
    bns = [{key: v.astype(np.float32) for key, v in bn.items()} for bn in bns]

    class Front(nn.Module):
        @nn.compact
        def __call__(self, x):
            def bn(name):
                return nn.BatchNorm(use_running_average=True, momentum=0.99, epsilon=1e-3,
                                    name=name)

            x = jax.nn.silu(bn("bn0")(nn.Conv(cexp, (1, 1), use_bias=False,
                                              name="expand_conv")(x)))
            x = nn.Conv(cexp, (k, k), padding="SAME", feature_group_count=cexp,
                        use_bias=False, name="depthwise_conv")(x)
            return jax.nn.silu(bn("bn1")(x))

    variables = {
        "params": {"expand_conv": {"kernel": w_exp}, "depthwise_conv": {"kernel": w_dw},
                   "bn0": {"scale": bns[0]["scale"], "bias": bns[0]["bias"]},
                   "bn1": {"scale": bns[1]["scale"], "bias": bns[1]["bias"]}},
        "batch_stats": {"bn0": {"mean": bns[0]["mean"], "var": bns[0]["var"]},
                        "bn1": {"mean": bns[1]["mean"], "var": bns[1]["var"]}},
    }
    want = np.asarray(Front().apply(variables, jnp.asarray(x)))
    (m1, mul1, b1), (m2, mul2, b2) = (
        bn_terms(*(torch.from_numpy(bn[key]) for key in ("scale", "bias", "mean", "var")))
        for bn in bns)
    got, squeeze = expand_dw_plain(torch.from_numpy(x), torch.from_numpy(w_exp[0, 0]), m1,
                                   mul1, b1, torch.from_numpy(w_dw[:, :, 0]), m2, mul2, b2)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(squeeze.numpy(), want.sum(axis=(1, 2)), rtol=1e-5,
                               atol=1e-5 * np.abs(want).sum(axis=(1, 2)).max())


def _bf16_front_half(k, h, w, se_mean=False):
    """The bf16 plain version and JAX's bf16 MBConvBlock front half (expand -> bn0
    -> silu -> depthwise -> bn1 -> silu) on the same inputs from a numpy seed, JAX's
    side jitted as XLA compiles it for the CPU; with `se_mean`, JAX also returns the
    SE's mean of the front half's output (`jnp.mean` over H and W, as
    `layers.SqueezeExcite` takes it) in bf16 and in float32 (the block's tensor cast
    to float32 first). Returns (port out, port squeeze, JAX outputs)."""
    from flax import linen as nn

    cin, cexp = 8, 48
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(2, h, w, cin)).astype(np.float32)).to(torch.bfloat16)
    w_exp = rng.normal(size=(1, 1, cin, cexp)).astype(np.float32) * 0.3
    w_dw = rng.normal(size=(k, k, 1, cexp)).astype(np.float32) * 0.3
    bns = [{key: v.astype(np.float32) for key, v in dict(
        scale=rng.uniform(0.5, 1.5, cexp), bias=rng.normal(size=cexp) * 0.1,
        mean=rng.normal(size=cexp) * 0.1, var=rng.uniform(0.5, 1.5, cexp)).items()}
        for _ in range(2)]

    class Front(nn.Module):
        @nn.compact
        def __call__(self, x):
            def bn(name):
                return nn.BatchNorm(use_running_average=True, epsilon=1e-3,
                                    dtype=jnp.bfloat16, name=name)

            x = nn.Conv(cexp, (1, 1), use_bias=False, dtype=jnp.bfloat16, name="expand_conv")(x)
            x = jax.nn.silu(bn("bn0")(x))
            x = nn.Conv(cexp, (k, k), padding="SAME", feature_group_count=cexp, use_bias=False,
                        dtype=jnp.bfloat16, name="depthwise_conv")(x)
            x = jax.nn.silu(bn("bn1")(x))
            if not se_mean:
                return x
            return (x, jnp.mean(x, axis=(1, 2)),
                    jnp.mean(x.astype(jnp.float32), axis=(1, 2)))

    variables = {
        "params": {"expand_conv": {"kernel": w_exp}, "depthwise_conv": {"kernel": w_dw},
                   "bn0": {"scale": bns[0]["scale"], "bias": bns[0]["bias"]},
                   "bn1": {"scale": bns[1]["scale"], "bias": bns[1]["bias"]}},
        "batch_stats": {"bn0": {"mean": bns[0]["mean"], "var": bns[0]["var"]},
                        "bn1": {"mean": bns[1]["mean"], "var": bns[1]["var"]}},
    }
    x_jax = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want = jax.jit(Front().apply)(variables, x_jax)
    terms = [bn_terms(*(torch.from_numpy(bn[key]) for key in ("scale", "bias", "mean", "var")))
             for bn in bns]
    got, squeeze = expand_dw_plain(x, torch.from_numpy(w_exp[0, 0]).to(torch.bfloat16),
                                   *terms[0], torch.from_numpy(w_dw[:, :, 0]).to(torch.bfloat16),
                                   *terms[1])
    return got, squeeze, want


@pytest.mark.parametrize("k,h,w", [(3, 11, 7), (5, 9, 13)])
def test_plain_bf16_matches_jax_mbconv_front_half(k, h, w):
    """The bf16 plain version against the JAX MBConvBlock's front half at bf16 as XLA
    compiles it (jitted): the convolutions' sums unrounded into the BatchNorms, each
    BatchNorm ((x - mean) mul + bias, one FMA) and each op of the SiLU rounded.
    XLA's rsqrt in mul is an estimate (`bn_terms`), so a channel's mul may be one
    ulp off; measured 100% bit-identical for k3 and k5 (the folded BatchNorm before:
    100% and 99.991%)."""
    got, _, want = _bf16_front_half(k, h, w)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert (got == want).mean() >= 0.999
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("k,h,w", [(3, 29, 48), (5, 17, 13)])
def test_plain_bf16_squeeze_matches_jax_se_mean(k, h, w):
    """The plain version's squeeze (the last SiLU's unrounded products summed over H
    and W in float32) against the SE's mean of JAX's bf16 front half, as XLA
    computes it: the mean of the products unrounded (its float32 promotion absorbs
    the SiLU's rounding). In float32, within 1e-6 of the mean |value| (another sum
    order); times 1 / (H W) and rounded to bf16 as `SqueezeExcite` takes it, >= 99%
    bit-identical to JAX's bf16 mean (measured 100%), the rest within a bf16 ulp."""
    got, squeeze, (_, mean_bf16, mean_f32) = _bf16_front_half(k, h, w, se_mean=True)
    assert squeeze.dtype == torch.float32 and squeeze.shape == (2, 48)
    n = h * w
    scale = np.abs(got.float().numpy()).mean(axis=(1, 2))
    np.testing.assert_allclose(squeeze.numpy() / n, np.asarray(mean_f32), rtol=0,
                               atol=1e-6 * scale.max())
    port = (squeeze * (1.0 / n)).to(torch.bfloat16).float().numpy()
    want = np.asarray(mean_bf16.astype(jnp.float32))
    assert (port == want).mean() >= 0.99
    np.testing.assert_allclose(port, want, rtol=2 ** -8, atol=0)


def _every_bf16():
    bits = torch.arange(65536, dtype=torch.int32)
    return bits, torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(
        torch.bfloat16)


def test_silu_table_reads_silu_chain_over_every_bf16_value():
    """The bf16 kernel's SiLU reads the sigmoid r from a table and multiplies once.
    The table holds r for the magnitudes from the largest bf16 below 2^-8 to 2^7, each
    sign (3844 entries); r is 0.5 below that range (zero included) and 1 (a > 0) or 0
    (a < 0) above it, so the clamped magnitude finds every finite input's entry (inside
    the range r is already 1 from 5.5625 up and flushed to 0 from -87.5 down). In
    plain PyTorch (`silu_tab_plain`), over all 65536 bf16 values: the entries are the
    chain's r of their inputs; Inf and NaN give the chain's result; the unrounded
    product (the squeeze's value) and its bf16 rounding (the output) equal
    `silu_chain`'s bit for bit."""
    table = silu_table("cpu")
    inputs = silu_table_inputs()
    assert table.dtype == torch.bfloat16 and table.shape == (TABLE_ENTRIES,) == (3844,)
    assert torch.equal(table.view(torch.int16), _sigmoid_chain(inputs).view(torch.int16))
    assert float(inputs[0]) == 2.0 ** -8 - 2.0 ** -16 and float(inputs[TAB_SPAN - 1]) == 128.0
    assert float(inputs[TAB_SPAN]) == -float(inputs[0])

    bits, a = _every_bf16()
    mag, neg = bits & 0x7FFF, bits >> 15
    finite = mag < 0x7F80
    r = _sigmoid_chain(a).float()
    below, above = finite & (mag <= TAB_LO), finite & (mag >= TAB_HI)
    assert bool((r[below] == 0.5).all())
    assert bool((r[above & (neg == 0)] == 1.0).all()) and bool((r[above & (neg == 1)] == 0.0).all())
    af = a.float()
    assert bool((r[finite & (af >= 5.5625)] == 1.0).all())
    assert bool((r[finite & (af < 5.5625)] < 1.0).all())
    assert bool((r[finite & (af <= -87.5)] == 0.0).all())
    assert bool((r[finite & (af > -87.5)] > 0.0).all())
    assert torch.equal(table.float()[silu_table_index(a)][finite], r[finite])

    got, want = silu_tab_plain(a, table), silu_chain(a, rounded=False)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    special = ~finite
    assert int(special.sum()) == 256 and int(torch.isnan(got[special]).sum()) == 255
    assert got[bits == 0x7F80].item() == float("inf")
    assert torch.equal(got.to(torch.bfloat16).view(torch.int16), silu_chain(a).view(torch.int16))


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(1)
    gamma, beta = rng.uniform(0.5, 1.5, 8), rng.normal(size=8)
    mean, var = rng.normal(size=8), rng.uniform(0.5, 1.5, 8)
    want = jax_fold_bn(gamma, beta, mean, var)
    got = fold_bn(*(torch.from_numpy(a.astype(np.float32)) for a in (gamma, beta, mean, var)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_tf32_rounds_like_cvt_rna():
    """The tf32 emulation behind the GPU precision test's one-pass control
    (`tests/_mbconv_f64.py`) rounds as `cvt.rna.tf32.f32`: to 10 mantissa bits,
    nearest, ties away from zero."""
    from _mbconv_f64 import tf32

    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -11),
                      1.0 + 2.0 ** -10 + 2.0 ** -12])
    assert tf32(v).tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2 * 2.0 ** -10), 1.0 + 2.0 ** -10]


@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 38, 29, 40, 240), (5, 13, 11, 20, 120),
                                            (3, 6, 5, 512, 3072), (3, 37, 121, 40, 240),
                                            (5, 33, 70, 64, 384)])
def test_float64_reference_matches_plain(k, h, w, cin, cexp):
    """The float64 function the GPU precision test holds the fp32 kernel to is kernel
    2's: the plain version in float32 agrees with it within that test's tolerance
    (`F64_TOL`) at its expand-dominant inputs."""
    from _mbconv_f64 import expand_dominant_args, expand_dw_f64, relative_err, within_f64_tol

    args = expand_dominant_args(2, h, w, cin, cexp, k, torch.float32, "cpu")
    got, want = expand_dw_plain(*args)[0].double(), expand_dw_f64(*args)
    assert within_f64_tol(got, want), relative_err(got, want)
