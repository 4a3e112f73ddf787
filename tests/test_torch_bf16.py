"""The port's bf16 path against the JAX package's bf16 program as XLA compiles it
for the CPU (the program the JAX bf16 reference CSV comes from).

XLA computes each bf16 elementwise op in float32 and rounds its result to bf16, op
by op: `jax.nn.silu` is four roundings (exp, add, divide, multiply), a flax `Conv`
or `Dense` with a bias rounds its product and then its sum with the bias. Where
the program casts a bf16 result to float32, XLA drops that result's rounding (its
default excess precision): a convolution's sums enter the BatchNorm (which
promotes its input) unrounded, the SE's mean and the features' pooling average
the SiLU's unrounded products, a residual block's capture pools the unrounded sum,
erfc takes -x c unrounded, a dense layer added to BERT's float32 residual stays
unrounded, and the resident step's embedding is the unrounded quotient. The port
rounds at the same points in inference, autograd off (`ops/activations.py`;
`models/layers.py`: `Conv2d`, `Linear`, `SqueezeExcite`; `models/efficientnet.py`:
`_conv_bn`, `_residual`; `models/bert.py`; `models/breastclip.py::_l2n`;
`ops/cuda_mbconv.py`). Training keeps the one-op forms.

(a) One op at a time, JAX's side jitted, on identical bf16 inputs made from a
    numpy seed: each op's share of bit-identical results. Elementwise ops are
    bit-identical. Products and reductions sum in another order than XLA's CPU
    backend; each states its least share and its tolerance (`OPS`). The BatchNorm
    of `_conv_bn` and of kernel 2 (`fused_batch_norm`) takes XLA's FMA but not its
    rsqrt (x86 `rsqrtps` and two Newton steps, one ulp off the IEEE 1 / sqrt for
    ~13% of channels: `ops.cuda_mbconv.bn_terms`).
(b) The EfficientNet tower at bf16, `efficientnet-test` and `efficientnet-b0` at
    `test_torch_tower.py`'s geometries, every block captured.
(c) The narrow BreastClip's resident step (`fused_resident_step`) at bf16: the
    pooled blocks and the probe embedding.

In (b) and (c) a block's gap is the mean |port - JAX| / mean |JAX| of its pooled
output (before this repair 0.63e-3 - 2.7e-3). With every block on the unfused
path the rounding points are all JAX's: each gap is within BLOCK_GAP, or within
twice JAX's own spread where the network is chaotic (JAX against itself with every
BatchNorm scale moved by one float32 ulp: bf16 rounding amplifies the float32
sums' order, which no two implementations share, to ~1e-3 by b0's last blocks).
On the default path kernel 2's blocks (its plain version on the CPU: the BatchNorm
as `_conv_bn`'s, the SE's squeeze summed over the unrounded SiLU as the unfused
block's SE sums it) equal the unfused path bit for bit. Figures: PERF.md §6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from mammodissect.models import bert as jax_bert
from mammodissect.models.efficientnet import EfficientNet as JaxEfficientNet
from mammodissect.models.layers import LinearProjectionHead as JaxLinearHead
from mammodissect.models.layers import SqueezeExcite as JaxSqueezeExcite
from mammodissect.ops.normalize import u8_minmax_meanstd as jax_normalize
from mammodissect.ops.pooling import pool_activation as jax_pool
from mammodissect_torch.convert import efficientnet_from_jax
from mammodissect_torch.models import efficientnet, layers
from mammodissect_torch.models.efficientnet import EfficientNet
from mammodissect_torch.ops.normalize import u8_minmax_meanstd
from mammodissect_torch.ops.pooling import pool_activation
from test_torch_tower import randomize_norm_stats

BF16 = torch.bfloat16
BLOCK_GAP = 1e-4   # (b), (c): where JAX is not chaotic


def _draw(rng, shape, scale=1.0):
    """bf16 values from the seed, as numpy float32 (exactly representable in bf16)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(BF16).float().numpy()


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16)


def _jax(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _both(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return got, np.asarray(jnp.asarray(want).astype(jnp.float32))


def _conv_op(shape, k, stride, groups_all=False, bias=False, cin_to_cout=None):
    """A flax `nn.Conv` at bf16 against the port's `layers.Conv2d` at bf16, over an
    NHWC input `shape` (the port's NCHW view of the same values)."""
    def run(rng):
        b, h, w, cin = shape
        cout = cin if groups_all else cin_to_cout
        x = _draw(rng, shape)
        pad = ((k - 1) // 2,) * 2
        conv = nn.Conv(cout, (k, k), strides=(stride, stride), padding=(pad, pad),
                       feature_group_count=cin if groups_all else 1, use_bias=bias,
                       dtype=jnp.bfloat16)
        params = conv.init(jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
        params = jax.tree.map(lambda p: np.asarray(rng.standard_normal(p.shape) /
                                                   np.sqrt(np.prod(p.shape[:-1])),
                                                   np.float32), params)
        want = jax.jit(conv.apply)(params, _jax(x))
        port = layers.Conv2d(cin, cout, k, stride=stride, padding=pad[0],
                             groups=cin if groups_all else 1, bias=bias)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(
                np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1)))
            if bias:
                port.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
        port.to(BF16)
        with torch.no_grad():
            got = port(_port(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return _both(got, want)
    return run


def _dense_op(din, dout, rows):
    """A flax `nn.Dense` with a bias at bf16 (BERT's layers, the projection head)
    against the port's `layers.Linear` at bf16."""
    def run(rng):
        x = _draw(rng, (rows, din))
        dense = nn.Dense(dout, dtype=jnp.bfloat16)
        params = {"params": {"kernel": rng.standard_normal((din, dout)).astype(np.float32)
                             / np.sqrt(din),
                             "bias": rng.standard_normal(dout).astype(np.float32) * 0.5}}
        want = jax.jit(dense.apply)(params, _jax(x))
        port = layers.Linear(din, dout)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(params["params"]["kernel"].T))
            port.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        port.to(BF16)
        with torch.no_grad():
            got = port(_port(x))
        return _both(got, want)
    return run


def _every_bf16() -> np.ndarray:
    """Every finite bf16 value but those under 2^-124 in magnitude (subnormal, or a
    SiLU or GELU result that is: XLA's CPU backend reads and writes those as zero,
    the port does not: `ops/activations.py`), as float32; zero stays."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(BF16)
    keep = torch.isfinite(x) & ((x == 0) | (x.abs() >= 2.0 ** -124))
    return x[keep].float().numpy()


def _elementwise(port_fn, jax_fn):
    """An elementwise op on every finite bf16 value."""
    def run(rng):
        x = _every_bf16()
        with torch.no_grad():
            return _both(port_fn(_port(x)), jax.jit(jax_fn)(_jax(x)))
    return run


def _batch_norm(rng):
    """Inference BatchNorm on a bf16 input: flax's (f32 statistics and parameters,
    one rounding) against `layers.BatchNorm2d`."""
    c = 40
    x = _draw(rng, (2, 17, 13, c), 2.0)
    mean, var = rng.normal(size=c).astype(np.float32) * 0.5, rng.uniform(0.5, 1.5, c).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(size=c).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=True, momentum=0.99, epsilon=1e-3, dtype=jnp.bfloat16)
    want = jax.jit(bn.apply)({"params": {"scale": scale, "bias": bias},
                              "batch_stats": {"mean": mean, "var": var}}, _jax(x))
    port = layers.BatchNorm2d(c, eps=1e-3).eval()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(port, name).copy_(torch.from_numpy(v))
        got = port(_port(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return _both(got, want)


def _squeeze_excite(rng):
    """The SE gate of an MBConv block: mean, the biased reduce conv, SiLU, the biased
    expand conv, sigmoid, the gate's product."""
    c, sq = 48, 4
    x = _draw(rng, (2, 9, 7, c))
    se = JaxSqueezeExcite(sq, dtype=jnp.bfloat16)
    params = jax.tree.map(lambda p: np.asarray(rng.standard_normal(p.shape) * 0.5, np.float32),
                          se.init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 7, c))))
    want = jax.jit(se.apply)(params, _jax(x))
    port = layers.SqueezeExcite(c, sq)
    p = params["params"]
    with torch.no_grad():
        for conv, name in ((port._se_reduce, "se_reduce"), (port._se_expand, "se_expand")):
            conv.weight.copy_(torch.from_numpy(np.asarray(p[name]["kernel"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(np.asarray(p[name]["bias"])))
        port.to(BF16)
        got = port(_port(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return _both(got, want)


def _layer_norm(dtype):
    """flax's LayerNorm (f32 parameters, result dtype from the input and them: f32)
    against `layers.LayerNorm`, on a bf16 or a f32 input."""
    def run(rng):
        d = 64
        x = _draw(rng, (50, d), 2.0) + 0.3
        scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
        bias = rng.normal(size=d).astype(np.float32) * 0.1
        ln = nn.LayerNorm(epsilon=1e-12)
        xin = _jax(x) if dtype == "bf16" else jnp.asarray(x)
        want = jax.jit(ln.apply)({"params": {"scale": scale, "bias": bias}}, xin)
        port = layers.LayerNorm(d, eps=1e-12)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(scale))
            port.bias.copy_(torch.from_numpy(bias))
            got = port(_port(x) if dtype == "bf16" else torch.from_numpy(x))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        return _both(got, want)
    return run


def _softmax(rng):
    """BERT's attention softmax: bf16 scores cast to f32 (`bert.py:43`)."""
    x = _draw(rng, (4, 2, 33, 33), 3.0)
    want = jax.jit(lambda x: jax.nn.softmax(x.astype(jnp.float32), axis=-1))(_jax(x))
    got = torch.softmax(_port(x).float(), dim=-1)
    return _both(got, want)


def _pooled_capture(rng):
    """The capture of a bf16 block output: cast to f32, spatial mean."""
    x = _draw(rng, (2, 23, 17, 40))
    want = jax.jit(lambda x: jax_pool(x.astype(jnp.float32), "avg", data_format="NHWC"))(_jax(x))
    got = pool_activation(_port(x).float().permute(0, 3, 1, 2), "avg")
    return _both(got, want)


def _normalize(rng):
    u8 = rng.integers(0, 256, size=(3, 31, 19, 1), dtype=np.uint8)
    want = jax.jit(lambda u8: jax_normalize(u8, 0.3089279, 0.25053555))(jnp.asarray(u8))
    got = u8_minmax_meanstd(torch.from_numpy(u8), 0.3089279, 0.25053555)
    return _both(got, want)


def _projection(rng):
    """The linear projection head at bf16 (`layers.py:97-110`)."""
    x = _draw(rng, (8, 96))
    head = JaxLinearHead(32, dtype=jnp.bfloat16)
    params = jax.tree.map(lambda p: np.asarray(rng.standard_normal(p.shape) * 0.2, np.float32),
                          head.init(jax.random.PRNGKey(0), jnp.zeros((1, 96))))
    want = jax.jit(head.apply)(params, _jax(x))
    port = layers.LinearProjectionHead(96, 32)
    with torch.no_grad():
        port.projection.weight.copy_(torch.from_numpy(np.asarray(params["params"]["projection"]["kernel"]).T))
        port.projection.bias.copy_(torch.from_numpy(np.asarray(params["params"]["projection"]["bias"])))
        port.to(BF16)
        got = port(_port(x))
    return _both(got, want)


def _embedding_norm(rng):
    """A bf16 embedding's L2 normalization (`breastclip.py` project_image)."""
    from mammodissect_torch.models.breastclip import BreastClipModule

    x = _draw(rng, (64, 512), 0.1)
    want = jax.jit(lambda e: e / jnp.linalg.norm(e, axis=1, keepdims=True))(_jax(x))
    with torch.no_grad():
        got = BreastClipModule._l2n(_port(x))
    return _both(got, want)


def _conv_bn(rng):
    """A bias-free conv into its BatchNorm (`efficientnet._conv_bn`): the conv's
    float32 sums enter the BatchNorm unrounded, its result is rounded."""
    c = 24
    x = _draw(rng, (2, 17, 13, c))
    bn = dict(scale=rng.uniform(0.5, 1.5, 96), bias=rng.normal(size=96) * 0.1,
              mean=rng.normal(size=96) * 0.1, var=rng.uniform(0.5, 1.5, 96))
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    kernel = (rng.standard_normal((1, 1, c, 96)) / np.sqrt(c)).astype(np.float32)

    class ConvBN(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Conv(96, (1, 1), use_bias=False, dtype=jnp.bfloat16, name="conv")(x)
            return nn.BatchNorm(use_running_average=True, epsilon=1e-3, dtype=jnp.bfloat16,
                                name="bn")(x)

    want = jax.jit(ConvBN().apply)({
        "params": {"conv": {"kernel": kernel}, "bn": {"scale": bn["scale"], "bias": bn["bias"]}},
        "batch_stats": {"bn": {"mean": bn["mean"], "var": bn["var"]}}}, _jax(x))
    conv = layers.Conv2d(c, 96, 1, bias=False)
    norm = layers.BatchNorm2d(96, eps=1e-3).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(norm, name).copy_(torch.from_numpy(bn[key]))
        conv.to(BF16)
        got = efficientnet._conv_bn(conv, norm, _port(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == BF16
    return _both(got, want)


def _dense_residual(rng):
    """A dense layer added to BERT's float32 residual (`bert.py:60-61, 64-65`):
    the bf16 sum with the bias stays unrounded (`Linear(sum_f32=True)`)."""
    x, res = _draw(rng, (40, 64)), rng.standard_normal((40, 64)).astype(np.float32)
    dense = nn.Dense(64, dtype=jnp.bfloat16)
    params = {"params": {"kernel": (rng.standard_normal((64, 64)) / 8).astype(np.float32),
                         "bias": (rng.standard_normal(64) * 0.5).astype(np.float32)}}
    want = jax.jit(lambda p, x, r: r + dense.apply(p, x))(params, _jax(x), jnp.asarray(res))
    port = layers.Linear(64, 64)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params["params"]["kernel"].T))
        port.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        port.to(BF16)
        got = torch.from_numpy(res) + port(_port(x), sum_f32=True)
    assert got.dtype == torch.float32
    return _both(got, want)


def _fused_batch_norm(rng):
    """Kernel 2's BatchNorm (its plain version's `batch_norm_fma` on `bn_terms`):
    (x - mean) (scale (1 / sqrt(var + eps))) + bias with one FMA, where flax's rsqrt
    is XLA's estimate; on float32 sums, rounded to bf16. Results differ where a
    channel's mul is one ulp off XLA's and the float32 result straddles a bf16
    rounding boundary."""
    from mammodissect_torch.ops.cuda_mbconv import batch_norm_fma, bn_terms

    c = 96
    y = rng.standard_normal((2, 29, 48, c)).astype(np.float32) * 2
    st = dict(scale=rng.uniform(0.5, 1.5, c), bias=rng.normal(size=c) * 0.1,
              mean=rng.normal(size=c) * 0.5, var=rng.uniform(0.5, 1.5, c))
    st = {k: v.astype(np.float32) for k, v in st.items()}
    bn = nn.BatchNorm(use_running_average=True, epsilon=1e-3, dtype=jnp.bfloat16)
    want = jax.jit(bn.apply)({"params": {"scale": st["scale"], "bias": st["bias"]},
                              "batch_stats": {"mean": st["mean"], "var": st["var"]}},
                             jnp.asarray(y))
    terms = bn_terms(*(torch.from_numpy(st[k]) for k in ("scale", "bias", "mean", "var")))
    got = batch_norm_fma(torch.from_numpy(y).permute(0, 3, 1, 2), *terms)
    return _both(got.permute(0, 2, 3, 1).to(BF16), want)


def _fused_se_mean(rng):
    """The SE's mean on kernel 2's blocks: XLA averages the SiLU's unrounded
    products; so does the port, from the squeeze that kernel 2's plain version sums
    (`silu_chain(..., rounded=False)` over H and W, float32 in another order than
    XLA's), times 1 / (H W) in `SqueezeExcite`. At B5's deepest spatial size, 29 x
    48."""
    from mammodissect_torch.ops.activations import silu_chain

    a = _draw(rng, (4, 29, 48, 96), 2.0)
    want = jax.jit(lambda a: jnp.mean(jax.nn.silu(a), axis=(1, 2)))(_jax(a))
    with torch.no_grad():
        squeeze = silu_chain(_port(a).permute(0, 3, 1, 2), rounded=False).sum(dim=(2, 3))
    got = (squeeze * (1.0 / (29 * 48))).to(BF16)
    return _both(got, want)


# name: (run(rng) -> (port, JAX), least bit-identical share, tolerance of the rest
# as (rtol, atol relative to the largest |JAX| value); None: bit-identical). The
# measured shares are in PERF.md §6.
OPS = {
    "stem_conv": (_conv_op((2, 33, 25, 3), 3, 2, cin_to_cout=16), 0.9995, (1e-2, 1e-2)),
    "expand_conv": (_conv_op((2, 17, 13, 24), 1, 1, cin_to_cout=144), 0.9995, (1e-2, 1e-2)),
    "depthwise_conv_k3": (_conv_op((2, 17, 13, 96), 3, 1, groups_all=True), 0.9995, (1e-2, 1e-2)),
    "depthwise_conv_k5": (_conv_op((2, 17, 13, 96), 5, 1, groups_all=True), 0.9995, (1e-2, 1e-2)),
    "project_conv": (_conv_op((2, 17, 13, 144), 1, 1, cin_to_cout=40), 0.9995, (1e-2, 1e-2)),
    "head_conv": (_conv_op((2, 5, 4, 320), 1, 1, cin_to_cout=1280), 0.9995, (1e-2, 1e-2)),
    "se_reduce_conv": (_conv_op((2, 1, 1, 144), 1, 1, bias=True, cin_to_cout=6), 1.0, None),
    "se_expand_conv": (_conv_op((2, 1, 1, 6), 1, 1, bias=True, cin_to_cout=144), 1.0, None),
    "batch_norm": (_batch_norm, 0.9995, (1e-2, 1e-2)),
    "conv_bn": (_conv_bn, 0.9995, (1e-2, 1e-2)),
    "silu": (_elementwise(layers.silu, jax.nn.silu), 1.0, None),
    "se_gate_sigmoid": (_elementwise(layers.sigmoid, jax.nn.sigmoid), 1.0, None),
    "gelu_exact": (_elementwise(layers.gelu, lambda x: jax.nn.gelu(x, approximate=False)),
                   1.0, None),
    "residual_add": (_elementwise(lambda x: x + x.flip(0), lambda x: x + x[::-1]), 1.0, None),
    "squeeze_excite": (_squeeze_excite, 1.0, None),
    "pooled_capture": (_pooled_capture, 0.8, (1e-6, 1e-6)),
    "u8_minmax_meanstd": (_normalize, 0.4, (1e-6, 1e-6)),
    "bert_dense": (_dense_op(64, 256, 40), 1.0, None),
    "dense_residual": (_dense_residual, 1.0, None),
    "softmax_f32": (_softmax, 0.3, (1e-6, 1e-6)),
    "layer_norm_bf16_in": (_layer_norm("bf16"), 0.4, (1e-5, 1e-5)),
    "layer_norm_f32_in": (_layer_norm("f32"), 0.2, (1e-5, 1e-5)),
    "projection_head": (_projection, 1.0, None),
    "embedding_norm": (_embedding_norm, 1.0, None),
    # kernel 2's BatchNorm and the SE's mean over its squeeze
    "fused_batch_norm": (_fused_batch_norm, 0.9999, (1e-2, 1e-2)),
    "fused_se_mean": (_fused_se_mean, 0.99, (1e-2, 1e-2)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax_bf16(name):
    """(a): the share of bit-identical results of one op; elementwise ops (no
    tolerance) must be bit-identical."""
    run, share, tol = OPS[name]
    got, want = run(np.random.default_rng(sorted(OPS).index(name)))
    assert got.shape == want.shape
    same = float((got == want).mean())
    assert same >= share, f"{name}: {same:.6f} bit-identical < {share}"
    if tol is not None:
        rtol, atol = tol
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max(),
                                   err_msg=name)


def _jax_tower(variant, in_channels, hw):
    """JAX's bf16 tower at `hw` (weights drawn from the seed with random BatchNorm
    statistics, as `test_torch_tower.py`): (input, variables, captures of every
    block, the captures with every BatchNorm scale moved by one float32 ulp)."""
    rng = np.random.default_rng(3)
    jax_model = JaxEfficientNet(variant=variant, in_channels=in_channels, dtype=jnp.bfloat16)
    x = rng.normal(size=(2, *hw, 1)).astype(np.float32)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(x))
    # kernels N(0, 1/fan_in), biases N(0, 0.01) (drawn, not `init`: its compile takes
    # seconds); BatchNorms then randomized
    variables = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1])) if a.ndim > 1
                   else rng.standard_normal(a.shape) * 0.1).astype(np.float32), shapes)
    variables = randomize_norm_stats(variables, rng)
    capture = tuple(range(len(jax_model.block_args)))
    run = jax.jit(lambda v, x: jax_model.apply(v, x, capture=capture)[1])
    moved = jax.tree_util.tree_map_with_path(
        lambda path, a: np.nextafter(a, np.float32(np.inf)).astype(np.float32)
        if path[-1].key == "scale" else a, variables)
    return x, variables, run(variables, jnp.asarray(x)), run(moved, jnp.asarray(x))


def _port_tower(variant, in_channels, x, variables, unfused=False):
    model = EfficientNet(variant=variant, in_channels=in_channels, dtype=BF16).eval()
    model.load_state_dict(efficientnet_from_jax(variables["params"], variables["batch_stats"]))
    if unfused:
        for block in model._blocks:
            block.fused_front = False
    with torch.no_grad():
        return model(torch.from_numpy(x), capture=tuple(range(len(model._blocks))))[1]


def _gap(got, want) -> float:
    got, want = _both(got, want)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _block_order(gaps):
    return [gaps[k] for k in sorted(gaps, key=lambda k: int(k.split(".")[-1]))]


@pytest.mark.parametrize("variant,in_channels,hw", [
    ("efficientnet-test", 3, (64, 48)),
    ("efficientnet-b0", 1, (97, 75)),
])
def test_tower_blocks_match_jax_bf16(variant, in_channels, hw):
    """(b): with every block unfused, each block where JAX is not chaotic (its own
    one-ulp spread under BLOCK_GAP / 10) within BLOCK_GAP, and the chaotic blocks
    together within 1.5 times JAX's own spread (before the repair: 2.9 times for
    b0); on the default path (kernel 2's plain version on its blocks) every block
    bit for bit the unfused path's."""
    x, variables, want, moved = _jax_tower(variant, in_channels, hw)
    spread = {k: _gap(moved[k], want[k]) for k in want}
    unfused = _port_tower(variant, in_channels, x, variables, unfused=True)
    fused = _port_tower(variant, in_channels, x, variables)
    assert len(want) == {"efficientnet-test": 7, "efficientnet-b0": 16}[variant]
    gap = {k: _gap(unfused[k], want[k]) for k in want}
    calm = [k for k in want if spread[k] < BLOCK_GAP / 10]
    assert calm and all(gap[k] <= BLOCK_GAP for k in calm), (gap, spread)
    chaotic = [k for k in want if k not in calm]
    assert sum(gap[k] for k in chaotic) <= 1.5 * sum(spread[k] for k in chaotic), (gap, spread)
    for k in want:
        assert torch.equal(fused[k], unfused[k]), k


def test_fused_resident_step_matches_jax_bf16():
    """(c): the narrow BreastClip at bf16 (efficientnet-test tower, a 1-layer BERT
    32 wide, the linear projection heads; weights drawn from the seed, random
    BatchNorm statistics). The resident step on one uint8 batch, every block
    captured: with every block unfused, each block's pooled output and the
    embedding within BLOCK_GAP of JAX's bf16 step; on the default path (kernel 2's
    plain version on its blocks) bit for bit the unfused step's. The text
    embeddings (BERT, eos pooling, projection, normalization) within BLOCK_GAP of
    JAX's."""
    from mammodissect.models.breastclip import BreastClip as JaxBreastClip
    from mammodissect.models.breastclip import BreastClipModule as JaxBreastClipModule
    from mammodissect_torch.convert import breastclip_from_jax
    from mammodissect_torch.models.breastclip import BreastClip, BreastClipModule

    narrow = dict(image_variant="efficientnet-test", in_channels=1, bert_layers=1,
                  bert_hidden=32, bert_heads=2, bert_intermediate=64, proj_dim=32,
                  vocab_size=77)
    rng = np.random.default_rng(5)
    shape = (4, 64, 48, 1)
    u8 = rng.integers(0, 256, size=shape, dtype=np.uint8)
    ids = rng.integers(1, 77, size=(6, 9))
    mask = (np.arange(9)[None] < rng.integers(3, 10, size=(6, 1))).astype(np.int32)
    jmodule = JaxBreastClipModule(dtype="bfloat16", **narrow)
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), {
        "images": jnp.zeros((1, *shape[1:]), jnp.float32),
        "input_ids": jnp.ones((1, 9), jnp.int32), "attention_mask": jnp.ones((1, 9), jnp.int32)})
    variables = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1])) if a.ndim > 1
                   else rng.standard_normal(a.shape) * 0.1).astype(np.float32), shapes)
    variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
    variables = randomize_norm_stats(variables, rng)
    variables["params"]["logit_scale"] = np.float32(np.log(1 / 0.07))
    jd = JaxBreastClip(module=jmodule, variables=jax.tree.map(jnp.asarray, variables))
    pd_ = BreastClip(BreastClipModule(dtype=BF16, **narrow).eval(), device="cpu")
    pd_.module.load_state_dict(breastclip_from_jax(variables))

    want = jax.jit(lambda v, i, m: jmodule.apply(
        v, jmodule.apply(v, i, m, method=JaxBreastClipModule.encode_text),
        method=JaxBreastClipModule.project_text))(jd.variables, ids, mask)
    with torch.no_grad():
        got = pd_.module.project_text(pd_.module.encode_text(torch.from_numpy(ids),
                                                             torch.from_numpy(mask).long()))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _gap(got, want) <= BLOCK_GAP, _gap(got, want)

    layers_ = [f"blocks.{i}" for i in range(7)]
    jstep, names, widths = jd.fused_resident_step(shape, layers_, "avg", 0.3, 0.25)
    acc = jnp.zeros((4, sum(widths)), jnp.float32), jnp.zeros((4, 32), jnp.float32)
    jacts, jemb = jstep(jd.variables, *acc, jnp.asarray(u8.reshape(-1)), 0)
    steps = {}
    for unfused in (True, False):
        for block in pd_.module.image_encoder._blocks:
            block.fused_front = block.args.stride == 1 and block.args.expand_ratio != 1 \
                and not unfused
        pstep, pnames, pwidths = pd_.fused_resident_step(shape, layers_, "avg", 0.3, 0.25)
        assert (pnames, pwidths) == (names, widths)
        acts, emb = torch.zeros(4, sum(widths)), torch.zeros(4, 32)
        pstep(acts, emb, torch.from_numpy(u8), 0)
        steps[unfused] = acts, emb
    acts, emb = steps[True]
    gaps, col = {}, 0
    for name, w in zip(names, widths):
        gaps[name] = _gap(acts[:, col:col + w], jacts[:, col:col + w])
        col += w
    gaps["embedding"] = _gap(emb, jemb)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= BLOCK_GAP, (worst, gaps)
    assert all(torch.equal(a, b) for a, b in zip(steps[False], steps[True]))


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bf16.py: the figures of (a)
    # and (b) (PERF.md section 6): each op's bit-identical share, and each tower's
    # largest block gap to JAX and whether the default path equals the unfused one
    for name in sorted(OPS):
        got, want = OPS[name][0](np.random.default_rng(sorted(OPS).index(name)))
        print(f"(a) {name}: {float((got == want).mean()):.6f} bit-identical")
    for variant, in_channels, hw in (("efficientnet-test", 3, (64, 48)),
                                     ("efficientnet-b0", 1, (97, 75))):
        x, variables, want, _ = _jax_tower(variant, in_channels, hw)
        unfused = _port_tower(variant, in_channels, x, variables, unfused=True)
        fused = _port_tower(variant, in_channels, x, variables)
        gaps = _block_order({k: _gap(unfused[k], want[k]) for k in want})
        print(f"(b) {variant}: block gaps {[f'{g:.3g}' for g in gaps]}; default path "
              f"equals unfused: {all(torch.equal(fused[k], unfused[k]) for k in want)}")
