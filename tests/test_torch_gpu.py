"""The PyTorch port on a CUDA GPU: each CUDA kernel against its plain PyTorch version
on the card, and a tiny resident dissection on the card against the same run on the
CPU. Imports torch and the port only (no JAX), so it runs on a machine with a GPU:

    python -m pytest --noconftest tests/test_torch_gpu.py

Without a GPU every test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue, bn_epilogue_plain
from mammodissect_torch.ops.cuda_mbconv import expand_dw_plain, fused_expand_dw
from mammodissect_torch.ops.cuda_wpmi import (
    soft_wpmi_gather_logsum,
    soft_wpmi_gather_logsum_plain,
)
from _mbconv_f64 import (
    F64_TOL,
    PRECISION_SHAPES,
    expand_dominant_args,
    expand_dw_f64,
    relative_err,
    within_f64_tol,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("u,c,n,k", [(13, 200, 50, 7), (6992, 762, 1024, 100),
                                     (9, 130, 300, 260), (70, 301, 3000, 50),
                                     (6992, 762, 2048, 100)])
def test_wpmi_kernel_matches_plain(cuda, u, c, n, k):
    """N <= ~1800 runs the shared-memory slab design, larger N (3000, 2048) the L2
    gather design."""
    rng = np.random.default_rng(3)
    clip_sm = torch.softmax(torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)) * 4, 1)
    inds = torch.from_numpy(rng.integers(0, n, size=(u, k)).astype(np.int32))
    p_in = torch.from_numpy(np.linspace(0.998, 0.97, k).astype(np.float32))
    clip_sm, inds, p_in = clip_sm.to(cuda), inds.to(cuda), p_in.to(cuda)
    before = soft_wpmi_gather_logsum.launches
    got = soft_wpmi_gather_logsum(clip_sm, inds, p_in)
    torch.cuda.synchronize()
    assert soft_wpmi_gather_logsum.launches == before + 1
    want = soft_wpmi_gather_logsum_plain(clip_sm, inds, p_in)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [64, 2500])
def test_wpmi_kernel_underflow_guard(cuda, n):
    """p = 1 and clip_sm entries near 0: every term is near eps = 1e-7, so a product
    of a few terms would underflow fp32 without the kernel's exponent bookkeeping
    (n = 64: the slab design, 2500: the gather design)."""
    u, c, k = 37, 762, 100
    rng = np.random.default_rng(5)
    clip_sm = torch.from_numpy((rng.uniform(0, 1e-6, size=(n, c))).astype(np.float32))
    clip_sm[:, :3] = 0.0  # terms of exactly eps
    inds = torch.from_numpy(rng.integers(0, n, size=(u, k)).astype(np.int32))
    p_in = torch.ones(k, dtype=torch.float32)
    clip_sm, inds, p_in = clip_sm.to(cuda), inds.to(cuda), p_in.to(cuda)
    got = soft_wpmi_gather_logsum(clip_sm, inds, p_in)
    want = soft_wpmi_gather_logsum_plain(clip_sm, inds, p_in)
    assert bool(torch.isfinite(want).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [64, 2500])
def test_wpmi_kernel_zero_and_negative_terms(cuda, n):
    """Columns whose terms are zero (min_prob 0, clip_sm 0, p 1: -inf) or negative
    (clip_sm < 0: NaN) leave the kernel's grouped product and are redone term by
    term; the other columns keep the grouped form. Both give the plain version's
    values, -inf and NaN in place."""
    u, c, k = 21, 300, 37
    rng = np.random.default_rng(9)
    clip_sm = rng.uniform(0.1, 1.0, size=(n, c)).astype(np.float32)
    clip_sm[:, 5] = 0.0
    clip_sm[: n // 2, 17] = -0.5
    clip_sm[:, 40] = 1e-30
    clip_sm = torch.from_numpy(clip_sm).to(cuda)
    inds = torch.from_numpy(rng.integers(0, n, size=(u, k)).astype(np.int32)).to(cuda)
    p_in = torch.ones(k, dtype=torch.float32, device=cuda)
    got = soft_wpmi_gather_logsum(clip_sm, inds, p_in, min_prob=0.0).cpu().numpy()
    want = soft_wpmi_gather_logsum_plain(clip_sm, inds, p_in, min_prob=0.0).cpu().numpy()
    assert np.isneginf(want[:, 5]).all() and np.isnan(want[:, 17]).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,bad", [(50, -1), (50, 50), (2500, -1), (2500, 2500)])
def test_wpmi_kernel_raises_on_an_index_outside_the_rows(cuda, n, bad):
    clip_sm = torch.full((n, 130), 0.5, device=cuda)
    inds = torch.zeros((9, 7), dtype=torch.int32, device=cuda)
    inds[4, 3] = bad
    with pytest.raises(IndexError):
        soft_wpmi_gather_logsum(clip_sm, inds, torch.ones(7, device=cuda))


def _mbconv_args(b, h, w, cin, cexp, k, dtype, device, seed=4):
    """bf16 at the scales of test_pallas_mbconv.py, where its tolerance was set (at
    unit scale one bf16 ulp of the rounded expanded tensor exceeds it); fp32 at unit
    scale. Each BatchNorm as (mean, mul, bias)."""
    rng = np.random.default_rng(seed)
    bf16 = dtype == torch.bfloat16

    def t(*shape, scale=1.0, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None else rng.normal(size=shape) * scale
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = t(b, h, w, cin, scale=0.1 if bf16 else 1.0).to(dtype)
    w_exp = t(cin, cexp, scale=0.05 if bf16 else cin ** -0.5).to(dtype)
    mul1, bias1 = t(cexp, lo=0.5), t(cexp, scale=0.1)
    w_dw = t(k, k, cexp, scale=0.05 if bf16 else 0.2).to(dtype)
    mul2, bias2 = t(cexp, lo=0.5), t(cexp, scale=0.1)
    return (x, w_exp, t(cexp, scale=0.1), mul1, bias1, w_dw, t(cexp, scale=0.1), mul2, bias2)


def _assert_squeeze_close(got, want, out, atol, rtol):
    """Squeezes [B, Cexp] of an output `out` [B, H, W, Cexp]: within the sum over H x
    W of the elementwise tolerance, atol H W + rtol sum |out|. bf16 outputs agree bit
    for bit, so there only the float32 sums' order differs: rtol 1e-5, atol 0."""
    n = out.shape[1] * out.shape[2]
    bound = atol * n + rtol * out.float().abs().sum(dim=(1, 2))
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


# bf16: the kernel's output is its plain version's bit for bit (on the card the plain
# expand is `torch.mm(..., out_dtype=float32)`, whose sums the kernel's wgmma matches)
BF16_EXACT = dict(atol=0.0, rtol=0.0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_EXACT),
                                       (torch.float32, dict(atol=1e-4, rtol=1e-4))])
@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 38, 29, 40, 240), (5, 19, 17, 64, 384),
                                            (3, 6, 5, 512, 3072), (5, 9, 33, 176, 1056),
                                            (3, 20, 65, 40, 240), (5, 19, 121, 64, 384),
                                            (5, 33, 29, 304, 1824), (3, 65, 57, 128, 768),
                                            (5, 14, 29, 64, 384), (3, 5, 16, 64, 96)])
def test_mbconv_kernel_matches_plain(cuda, dtype, tol, k, h, w, cin, cexp):
    """Besides B5's and V2-S's shapes, the kernel's strips and segments (both dtypes
    walk them): W 65 (one past the widest single strip: two strips) and 121 (three), H
    33 and 65 (one past one and two 32-row segments), W 29 in one strip at both K (two
    rows a step) and W 16 (four rows a step). bf16 bit for bit; two launches
    identical; fp32 launches its weight split once a call."""
    args = _mbconv_args(2, h, w, cin, cexp, k, dtype, cuda)
    before = _counts()
    got, squeeze = fused_expand_dw(*args)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + (dtype == torch.float32))
    want, want_squeeze = expand_dw_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    _assert_squeeze_close(squeeze, want_squeeze, want, **_squeeze_tol(dtype, tol))
    again, squeeze_again = fused_expand_dw(*args)
    assert torch.equal(again, got) and torch.equal(squeeze_again, squeeze)


def _counts():
    return (fused_expand_dw.launches, fused_expand_dw.reduce_launches,
            fused_expand_dw.weight_launches)


def _squeeze_tol(dtype, tol):
    return dict(atol=0.0, rtol=1e-5) if dtype == torch.bfloat16 else tol


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, dict(atol=2e-3, rtol=2e-2)),
                                       (torch.float32, dict(atol=1e-4, rtol=1e-4))])
@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 380, 228, 40, 240), (5, 190, 114, 64, 384),
                                            (3, 48, 29, 512, 3072), (5, 48, 29, 304, 1824),
                                            (3, 48, 29, 256, 1536)])
def test_mbconv_kernel_full_b5_shape(cuda, dtype, tol, k, h, w, cin, cexp):
    """Full-resolution block shapes at 1520x912: B5's blocks 4-7 and 9-12 (one per k),
    its 48 x 29 blocks 37-38 and 28-35, and EfficientNetV2-S's 48 x 29 blocks 26-39.
    The squeeze against the plain version's, and two launches bit-identical (a
    fixed summation order, no float atomics)."""
    args = _mbconv_args(2, h, w, cin, cexp, k, dtype, cuda)
    got, squeeze = fused_expand_dw(*args)
    want, want_squeeze = expand_dw_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    _assert_squeeze_close(squeeze, want_squeeze, want, **_squeeze_tol(dtype, tol))
    again, squeeze_again = fused_expand_dw(*args)
    assert torch.equal(again, got) and torch.equal(squeeze_again, squeeze)


@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 380, 228, 40, 240), (5, 48, 29, 304, 1824)])
def test_mbconv_kernel_fp32_batch_in_one_launch(cuda, k, h, w, cin, cexp):
    """An fp32 call at batch 5 of a B5 shape is one launch (64-bit output offsets:
    no split of the batch), and its out and squeeze equal those of its images run one
    at a time, bit for bit (each image's blocks compute the same sums in the same
    order)."""
    args = _mbconv_args(5, h, w, cin, cexp, k, torch.float32, cuda)
    before = _counts()
    whole, whole_squeeze = fused_expand_dw(*args)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    for i in range(5):
        one, one_squeeze = fused_expand_dw(args[0][i:i + 1].contiguous(), *args[1:])
        assert torch.equal(one[0], whole[i]) and torch.equal(one_squeeze[0], whole_squeeze[i])


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_EXACT),
                                       (torch.float32, dict(atol=1e-4, rtol=1e-4))])
@pytest.mark.parametrize("k,h,w,cin,cexp,shifted", [(3, 21, 19, 24, 144, None),
                                                    (5, 13, 11, 20, 120, None),
                                                    (3, 10, 9, 40, 100, None),
                                                    (5, 17, 18, 56, 104, None),
                                                    (5, 37, 70, 20, 120, None),
                                                    (3, 17, 29, 100, 101, None),
                                                    (3, 21, 19, 24, 144, "x")])
def test_mbconv_kernel_odd_widths(cuda, dtype, tol, k, h, w, cin, cexp, shifted):
    """Cin not a multiple of 16 (24, 56, 100) or of 8 (20: in bf16 the chunks are
    staged element by element, not by TMA; also across two strips and two segments,
    70 x 37, in both dtypes), Cexp not a multiple of the 48-channel tile (104, 120) or
    of 8 (100, 101: element-wise weight staging in bf16; 101 also element-wise
    stores), x starting one element past a 16-byte boundary (no TMA in either dtype);
    bf16 bit for bit. fp32 also stages element by element where Cin is not a multiple
    of 4: `test_mbconv_kernel_fp32_element_staging`."""
    args = list(_mbconv_args(2, h, w, cin, cexp, k, dtype, cuda))
    if shifted:
        args[0] = _unaligned(args[0])
    got, squeeze = fused_expand_dw(*args)
    want, want_squeeze = expand_dw_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    _assert_squeeze_close(squeeze, want_squeeze, want, **_squeeze_tol(dtype, tol))


@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 38, 29, 40, 240), (5, 19, 17, 64, 384),
                                            (5, 13, 11, 20, 120), (3, 21, 19, 24, 144),
                                            (5, 17, 18, 56, 104), (3, 6, 5, 512, 3072)])
def test_mbconv_kernel_expand_dominates(cuda, k, h, w, cin, cexp):
    """rtol 2^-7 is one to two bf16 ulps of the output; atol 4e-3 covers two one-ulp
    flips of the bf16 expanded tensor (weighted ~1/K^2) at outputs near 0."""
    args = expand_dominant_args(2, h, w, cin, cexp, k, torch.bfloat16, cuda)
    got, _ = fused_expand_dw(*args)
    want, _ = expand_dw_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3, rtol=2.0 ** -7)


@pytest.mark.parametrize("k,h,w,cin,cexp", PRECISION_SHAPES)
def test_mbconv_kernel_fp32_against_float64(cuda, k, h, w, cin, cexp):
    """The float32 precision policy: the fp32 kernel at the expand-dominant scales
    against the same function in float64, within 1e-5 + 1e-5|x|. At these inputs
    (`python tests/_mbconv_f64.py cuda`, NVIDIA H100 80GB HBM3) the kernel is within
    2.8e-7 (1 + |x|) and float32 products within 8.5e-7 (1 + |x|): a margin of over
    30x; one tf32 pass (emulated) is off by 1.7e-4 to 4.1e-4 (1 + |x|), missing the
    tolerance by 17x or more, which the test asserts at the same inputs. The shapes
    include several strips and segments with a ragged last strip."""
    args = expand_dominant_args(2, h, w, cin, cexp, k, torch.float32, cuda)
    got = fused_expand_dw(*args)[0].double().cpu()
    cpu_args = [a.cpu() for a in args]
    want = expand_dw_f64(*cpu_args)
    assert within_f64_tol(got, want), f"{relative_err(got, want):.3g} > {F64_TOL}"
    assert not within_f64_tol(expand_dw_f64(*cpu_args, one_tf32_pass=True), want)


def _unaligned(t):
    """A copy of `t` whose data starts 4 bytes past a 16-byte boundary."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("k,h,w,cin,cexp,shifted", [(3, 21, 19, 21, 102, None),
                                                    (5, 13, 11, 21, 102, None),
                                                    (3, 17, 18, 24, 144, "x"),
                                                    (5, 13, 11, 40, 120, "w_exp")])
def test_mbconv_kernel_fp32_element_staging(cuda, k, h, w, cin, cexp, shifted):
    """The fp32 kernel's element-by-element staging of x (Cin not a multiple of 4, or
    x off a 16-byte boundary: TMA refuses them), and odd Cexp (102) and w_exp off a
    16-byte boundary (the weight split reads w_exp element by element in any case),
    at the expand-dominant inputs; held to the plain version at 1e-4 + 1e-4|x| and to
    float64 at `F64_TOL`."""
    args = list(expand_dominant_args(2, h, w, cin, cexp, k, torch.float32, cuda))
    if shifted:
        i = ("x", "w_exp").index(shifted)
        args[i] = _unaligned(args[i])
    got, _ = fused_expand_dw(*args)
    torch.testing.assert_close(got, expand_dw_plain(*args)[0], atol=1e-4, rtol=1e-4)
    got, want = got.double().cpu(), expand_dw_f64(*(a.cpu() for a in args))
    assert within_f64_tol(got, want), f"{relative_err(got, want):.3g} > {F64_TOL}"


def test_resident_dissection_gpu_matches_cpu(cuda, tmp_path):
    """The tiny resident dissection through the kernels on the card and through the
    plain versions on the CPU: same top concepts and top images at f32."""
    import warnings

    from mammodissect_torch.data.probes import ArrayProbe
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

    rng = np.random.default_rng(0)
    probe = ArrayProbe(rng.integers(0, 256, size=(16, 64, 48, 1), dtype=np.uint8),
                       mean=0.3, std=0.25)
    small = {"bert_layers": 2, "model_config": {
        "image_encoder": {"model_type": "cnn", "variant": "efficientnet-test", "in_channels": 1},
        "text_encoder": {"pooling": "eos"}, "projection_head": {"name": "linear", "proj_dim": 32}}}
    dfs = {}
    for dev in ("cpu", "cuda"):
        cfg = DissectConfig(target_model="breastclip", clip_model="breastclip",
                            target_layers=[f"blocks.{i}" for i in range(7)],
                            d_probe="synthetic_u8", concept_set="tests/assets/tiny_concepts.txt",
                            batch_size=8, dissector_kwargs=small, resident=True, device=dev,
                            activation_dir=str(tmp_path / dev / "a"),
                            result_dir=str(tmp_path / dev / "r"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dfs[dev], _ = run_dissection(cfg, probe=probe, log=lambda *_: None)
    top = {d: [row[0] for row in df["description"]] for d, df in dfs.items()}
    agree = np.mean([a == b for a, b in zip(top["cpu"], top["cuda"])])
    assert agree >= 0.99, agree
    assert list(dfs["cpu"]["images"]) == list(dfs["cuda"]["images"])


def test_unpack_on_cuda_is_bit_identical(cuda):
    """A mammogram-shaped batch packed by the host packer and unpacked on the card
    gives back the batch, byte for byte (spans ending at W, rows starting right of
    0, empty rows and an all-zero image included)."""
    from mammodissect_torch.dissect.packing import pack_batch_groups_padded, unpack_canvas_groups

    rng = np.random.default_rng(7)
    u8 = np.zeros((6, 152, 96, 1), np.uint8)
    for i in range(5):
        hh, ww = rng.integers(40, 153), rng.integers(20, 97)
        x0 = 0 if i % 2 else 96 - ww
        u8[i, :hh, x0:x0 + ww] = rng.integers(1, 256, size=(hh, ww, 1), dtype=np.uint8)
    for groups in (1, 2):
        flat2d, meta, _ = pack_batch_groups_padded(u8, groups, quantum=4096, cap=u8.size // groups)
        got = unpack_canvas_groups(torch.from_numpy(flat2d).to(cuda),
                                   torch.from_numpy(meta).to(cuda), u8.shape)
        assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(u8))


def _classifier_target(device):
    from mammodissect_torch.dissect.targets import get_target_model

    return get_target_model("breastclip_classifier", device=device, seed=3)


def test_classifier_harvest_cuda_matches_cpu(cuda):
    """The B5 classifier target (fp32, kernel 2's fp32 instantiation on the card) at a
    small geometry: the card's harvest against the CPU's (plain versions)."""
    rng = np.random.default_rng(8)
    u8 = rng.integers(0, 256, size=(3, 96, 64, 1), dtype=np.uint8)
    layers = [f"blocks.{i}" for i in range(39)]
    got, names, _ = _classifier_target("cuda").harvest_u8_dispatch(u8, layers, "avg", 0.3, 0.25)
    want, _, _ = _classifier_target("cpu").harvest_u8_dispatch(u8, layers, "avg", 0.3, 0.25)
    assert len(names) == 39
    got, want = got.cpu().numpy(), want.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_harvest_probe_launches_kernel_2_per_batch(cuda):
    """harvest_probe on the card: 32 kernel-2 launches a batch of B5 (its stride-1
    blocks with an expansion), on the pipelined uint8 wire."""
    from mammodissect_torch.data.probes import ArrayProbe
    from mammodissect_torch.dissect.engine import harvest_probe

    rng = np.random.default_rng(9)
    probe = ArrayProbe(rng.integers(0, 256, size=(10, 96, 64, 1), dtype=np.uint8),
                       mean=0.3, std=0.25)
    target = _classifier_target("cuda")
    before = fused_expand_dw.launches
    acc, n = harvest_probe(target, probe, ["blocks.3", "blocks.38"], "avg", 4)
    assert n == 10 and acc["blocks.38"].shape == (10, 512)
    assert fused_expand_dw.launches - before == 32 * 3


def test_mbconv_kernel_refuses_inputs_that_need_a_gradient(cuda):
    """The kernel has no backward: on inputs that need a gradient it raises instead of
    returning an output that carries none; under no_grad it runs."""
    args = list(_mbconv_args(1, 8, 6, 16, 96, 3, torch.float32, cuda))
    args[1] = args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_expand_dw(*args)
    with torch.no_grad():
        fused_expand_dw(*args)


def _epilogue_sums(c, terms, unaligned, device):
    """Float32 sums v [2, C, H, 4] in channels_last memory and BatchNorm terms (mean,
    mul, bias). "identity": mean 0, mul 1, bias 0, and v holds every finite bf16 value,
    so the BatchNorm's rounded output takes each of them (the SiLU all of its finite
    inputs). "random": sums from 1e-3 to ~1e3 in size and random terms. `unaligned`:
    v one float past a 16-byte boundary (the kernel's channel-at-a-time path)."""
    gen = torch.Generator().manual_seed(c)
    bits = torch.arange(65536, dtype=torch.int32)
    finite = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(
        torch.bfloat16).float()
    finite = finite[torch.isfinite(finite)]
    h = -(-finite.numel() // (2 * 4 * c))
    n = 2 * h * 4 * c
    if terms == "identity":
        flat = finite.repeat(-(-n // finite.numel()))[:n]
        flat = flat[torch.randperm(n, generator=gen)]
        mean, mul, bias = torch.zeros(c), torch.ones(c), torch.zeros(c)
    else:
        scale = torch.exp(torch.empty(n).uniform_(-7, 7, generator=gen))
        flat = torch.randn(n, generator=gen) * scale
        mean = torch.randn(c, generator=gen)
        mul = (torch.rand(c, generator=gen) * 2 + 0.05) * torch.sign(torch.randn(c, generator=gen))
        bias = torch.randn(c, generator=gen)
    buf = torch.empty(n + 1, device=device)
    v = buf[1:] if unaligned else buf[:n]
    v.copy_(flat.to(device))
    v = v.view(2, h, 4, c).permute(0, 3, 1, 2)
    assert v.is_contiguous(memory_format=torch.channels_last)
    assert (v.data_ptr() % 16 != 0) == unaligned
    return v, mean.to(device), mul.to(device), bias.to(device)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("terms", ["identity", "random"])
@pytest.mark.parametrize("act,squeeze", [(None, False), ("silu", False), ("silu", True),
                                         ("silu_f32", False)])
@pytest.mark.parametrize("c,unaligned", [(24, False), (40, False), (48, False), (144, False),
                                         (2048, False), (37, False), (48, True)])
def test_bn_epilogue_matches_the_aten_chain_bit_for_bit(cuda, terms, act, squeeze, c,
                                                        unaligned):
    """Kernel 3 against its plain version (the ATen chain on the card) at B5's channel
    counts, an odd one (37) and unaligned sums (both on the channel-at-a-time path):
    the output and the squeeze bit for bit over every finite bf16 BatchNorm output
    (the squeeze is ATen's sum of the kernel's float32 product); two launches
    bit-identical."""
    v, mean, mul, bias = _epilogue_sums(c, terms, unaligned, cuda)
    before = bn_epilogue.launches, bn_epilogue.squeeze_launches
    out, sq = bn_epilogue(v, mean, mul, bias, act=act, squeeze=squeeze)
    torch.cuda.synchronize()
    assert (bn_epilogue.launches, bn_epilogue.squeeze_launches) == (before[0] + 1,
                                                                    before[1] + squeeze)
    want, want_sq = bn_epilogue_plain(v, mean, mul, bias, act=act, squeeze=squeeze)
    assert out.dtype == want.dtype and out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(out), _bits(want))
    assert (sq is None) == (not squeeze) and (sq is None or torch.equal(_bits(sq), _bits(want_sq)))
    again, _ = bn_epilogue(v, mean, mul, bias, act=act, squeeze=squeeze)
    assert torch.equal(_bits(again), _bits(out))


@pytest.mark.parametrize("act,squeeze", [(None, False), ("silu", True)])
def test_bn_epilogue_takes_nchw_sums(cuda, act, squeeze):
    """Sums in NCHW memory go through the kernel too, copied to channels_last first:
    the output bit for bit the ATen chain's on either layout, the squeeze bit for bit
    the ATen chain's on the channels_last copy (ATen's sum over H x W adds in memory
    order, so on the NCHW sums it differs by float32 summation order)."""
    v, mean, mul, bias = _epilogue_sums(40, "random", False, cuda)
    nchw = v.contiguous()
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    before = bn_epilogue.launches
    out, sq = bn_epilogue(nchw, mean, mul, bias, act=act, squeeze=squeeze)
    torch.cuda.synchronize()
    assert bn_epilogue.launches == before + 1
    want, want_sq = bn_epilogue_plain(v, mean, mul, bias, act=act, squeeze=squeeze)
    want_nchw, _ = bn_epilogue_plain(nchw, mean, mul, bias, act=act, squeeze=False)
    assert torch.equal(_bits(out), _bits(want)) and torch.equal(_bits(out), _bits(want_nchw))
    assert sq is None or torch.equal(_bits(sq), _bits(want_sq))


def test_v2s_bf16_forward_keeps_the_aten_chains_bits(cuda, monkeypatch):
    """One bf16 inference forward of EfficientNetV2-S on the card: kernel 3 at its 54
    sites (2 with a squeeze), and the features and the 40 captures bit for bit those of
    the same forward with the ATen chain in the kernel's place."""
    from mammodissect_torch.models.efficientnet import EfficientNetMammo
    from mammodissect_torch.ops import cuda_bn_epilogue

    torch.manual_seed(0)
    tower = EfficientNetMammo("efficientnetv2-s", in_channels=1, dtype=torch.bfloat16)
    tower = tower.to(cuda).eval()
    x = torch.randn(2, 96, 64, 1, device=cuda)
    before = bn_epilogue.launches, bn_epilogue.squeeze_launches
    with torch.no_grad():
        got = tower(x, capture=range(len(tower._blocks)))
    assert (bn_epilogue.launches - before[0], bn_epilogue.squeeze_launches - before[1]) == (54, 2)
    monkeypatch.setattr(cuda_bn_epilogue, "_launch", bn_epilogue_plain)
    with torch.no_grad():
        want = tower(x, capture=range(len(tower._blocks)))
    assert torch.equal(_bits(got[0]), _bits(want[0])) and len(got[1]) == 40
    assert all(torch.equal(_bits(got[1][k]), _bits(want[1][k])) for k in want[1])


def test_bn_epilogue_refuses_inputs_that_need_a_gradient(cuda):
    v, mean, mul, bias = _epilogue_sums(24, "random", False, cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        bn_epilogue(v, mean, mul, bias.clone().requires_grad_(), act="silu")
    with torch.no_grad():
        bn_epilogue(v, mean, mul, bias, act="silu")


def test_b5_forward_launches_kernel_3_at_52_sites(cuda):
    """One bf16 inference forward of the B5 tower: kernel 3 at 52 sites, 7 with a
    squeeze, and no addcmul, nor an exp or reciprocal of an activation beyond the SE
    gates' [B, C, 1, 1] (the BatchNorm terms' [C] are prepared once); 0 launches in a
    bf16 training forward and backward and in an fp32 forward."""
    from mammodissect_torch.models.efficientnet import EfficientNetMammo

    x = torch.randn(2, 192, 128, 1, device=cuda)
    tower = EfficientNetMammo("efficientnet-b5", in_channels=3, dtype=torch.bfloat16)
    tower = tower.to(cuda).eval()
    before = bn_epilogue.launches, bn_epilogue.squeeze_launches
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True) as prof:
        tower(x, capture=range(39))
    assert (bn_epilogue.launches - before[0], bn_epilogue.squeeze_launches - before[1]) == (52, 7)
    ops = [(e.name, e.input_shapes) for e in prof.events()
           if e.name in ("aten::addcmul", "aten::exp", "aten::reciprocal")]
    assert ops and not any(name == "aten::addcmul" for name, _ in ops)
    assert all(len(shapes[0]) != 4 or shapes[0][2:] == [1, 1] for _, shapes in ops), ops
    before = bn_epilogue.launches
    tower = EfficientNetMammo("efficientnet-b5", in_channels=3, dtype=torch.bfloat16,
                              param_dtype=torch.float32).to(cuda).train()
    tower(x)[0].float().sum().backward()
    with torch.no_grad():
        EfficientNetMammo("efficientnet-b5", in_channels=3).to(cuda).eval()(x)
    assert bn_epilogue.launches == before


def test_finetune_train_steps_cuda_match_cpu(cuda):
    """Three fp32 train steps of the test classifier at 64x48 on the card and on the
    CPU: the same losses (1e-4 relative) and weights and BatchNorm statistics
    (1e-5 + 1e-3 of each tensor's largest entry). The project BatchNorm biases are
    frozen: their gradient is rounding noise (a batch-statistics BatchNorm after the
    next 1x1 convolution removes any shift), whose sign Adam turns into +-lr steps.
    No kernel-2 launch in a train step, 2 in the eval forward."""
    from mammodissect_torch.train.experiments import FinetuneConfig, build_model
    from mammodissect_torch.train.trainer import Trainer, make_optimizer

    cfg = FinetuneConfig(arch="t_test_ft", img_size=(64, 48), dtype="float32",
                         pad_mode="same", bn_momentum=0.9, lr=1e-3, seed=8)
    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 256, size=(8, 64, 48, 1), dtype=np.uint8),
                (rng.random(8) < 0.5).astype(np.float32), n) for n in (8, 8, 5)]
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg)
        labels = {k: "frozen" if k.endswith("_bn2.bias") else "train"
                  for k, _ in model.named_parameters()}
        optimizer, scheduler = make_optimizer(model.to(dev), cfg.lr, cfg.weight_decay, 1, 10,
                                              param_labels=labels)
        tr = Trainer(model, optimizer, scheduler, pos_weight=15.57, input_wire="u8",
                     norm_mean=cfg.mean, norm_std=cfg.std, device=dev)
        before = fused_expand_dw.launches
        losses = [tr.train_batch(*b) for b in batches]
        assert fused_expand_dw.launches == before
        _, preds = tr.eval_batch(*batches[0])
        assert fused_expand_dw.launches == before + (2 if dev == "cuda" else 0)
        runs[dev] = (model.state_dict(), losses, preds)
    (cpu, cpu_losses, cpu_preds), (gpu, gpu_losses, gpu_preds) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
    np.testing.assert_allclose(gpu_preds, cpu_preds, rtol=1e-4, atol=1e-5)
    for k, v in cpu.items():
        if v.is_floating_point():
            np.testing.assert_allclose(gpu[k].cpu().numpy(), v.numpy(), rtol=0,
                                       atol=1e-5 + 1e-3 * float(v.abs().max()), err_msg=k)


@pytest.mark.parametrize("causal", [False, True])
def test_vit_block_cuda_matches_cpu(cuda, causal):
    """A ViT-B/16-wide CLIP block (768, 12 heads, 197 tokens) on the card equals the CPU
    at float32 with TF32 off: the attention's matmuls, float32 softmax and -inf
    causal mask."""
    import copy

    from mammodissect_torch.models.clip_vit import ResidualAttentionBlock, init_clip_weights

    block = ResidualAttentionBlock(768, 12, causal=causal).eval()
    init_clip_weights(block, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 197, 768)).astype(np.float32))
    with torch.no_grad():
        want = block(x)
        got = copy.deepcopy(block).to(cuda)(x.to(cuda)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("name,kw,layers,hw", [
    ("resnet50", {}, ["conv1", "layer1", "layer2", "layer3", "layer4"], (64, 48)),
    ("vit", dict(width=64, layers=2, heads=2), ["layers.0", "layers.1"], (80, 48)),
    ("breastclip_swin", dict(spec={"embed": 32, "depths": [2, 2, 2], "heads": [2, 2, 4]},
                             in_channels=1), ["layers.0", "layers.1", "layers.2"], (92, 60)),
])
def test_zoo_targets_cuda_match_cpu(cuda, name, kw, layers, hw):
    """A zoo target's harvest on the card equals the CPU's at float32 with TF32 off
    (the ResNet at full width; the ViT off its native grid; the Swin padded and
    cropped), each capture within 1e-4 of its largest entry."""
    from mammodissect_torch.dissect.targets import get_target_model

    x = np.random.default_rng(10).normal(size=(3, *hw, 1)).astype(np.float32)
    got = get_target_model(name, device="cuda", **kw).harvest(x, layers, "avg")
    want = get_target_model(name, device="cpu", **kw).harvest(x, layers, "avg")
    assert sorted(got) == sorted(want) == sorted(layers)
    for k in layers:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * np.abs(want[k]).max())


@pytest.mark.parametrize("tower,geometry", [
    ("swin", {"spec": {"embed": 32, "depths": [2, 2], "heads": [2, 4]}}),
    ("vit", {"width": 64, "layers": 2, "heads": 2}),
])
def test_breastclip_towers_cuda_match_cpu(cuda, tower, geometry):
    """BreastClip with a narrow Swin or ViT image tower embeds the same images on the
    card as on the CPU (float32, TF32 off), float and uint8 batches."""
    from mammodissect_torch.models.breastclip import BreastClip

    cfg = {"image_encoder": {"model_type": tower, "in_channels": 3, **geometry},
           "text_encoder": {}, "projection_head": {"proj_dim": 32}}
    x = np.random.default_rng(11).normal(size=(4, 96, 64, 1)).astype(np.float32)
    u8 = np.random.default_rng(12).integers(0, 256, size=(4, 96, 64, 1), dtype=np.uint8)
    out = {}
    for dev in ("cpu", "cuda"):
        clip = BreastClip.create(model_config=cfg, bert_layers=1, vocab_size=50, device=dev)
        out[dev] = (clip.embed_images(x), clip.embed_images_u8(u8, 0.3, 0.25))
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_v2_tower_cuda_matches_cpu(cuda):
    """The EfficientNetV2-S tower (fp32, eval) at 64x64 on the card and on the CPU:
    28 kernel-2 launches a forward (its stride-1 expanded MBConv blocks; the
    FusedMBConv blocks run on cuDNN), every one of the 40 captured blocks within
    1e-4 of the largest entry."""
    from mammodissect_torch.models.efficientnet import EfficientNet
    from mammodissect_torch.models.layers import init_weights

    model = EfficientNet("efficientnetv2-s", in_channels=3)
    init_weights(model, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 64, 64, 1)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev).eval()
        before = fused_expand_dw.launches
        with torch.no_grad():
            _, captured = m(x.to(dev), capture=tuple(range(40)))
        out[dev] = {k: v.cpu().numpy() for k, v in captured.items()}
        assert fused_expand_dw.launches - before == (28 if dev == "cuda" else 0)
    for k, want in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_pretrain_step_cuda_matches_cpu(cuda):
    """Three fp32 contrastive pretraining steps of a narrow BreastClip (efficientnet-test
    tower, 2-layer BERT, both second views, u8 wire) on the card and on the CPU: the
    same losses (1e-4 relative); weights and BatchNorm statistics within 1e-5 + 1e-3
    of each tensor's largest entry, but for at most 1e-4 of the entries (those whose
    gradient is rounding noise, which Adam turns into +-lr steps), held within 6 lr.
    The shift-invariant BatchNorm and key biases are frozen; no kernel-2 launch."""
    from mammodissect_torch.models.breastclip import BreastClipModule
    from mammodissect_torch.models.layers import init_weights
    from mammodissect_torch.train.clip_trainer import batch_to_device, make_clip_train_step
    from mammodissect_torch.train.trainer import make_optimizer

    narrow = dict(image_variant="efficientnet-test", bert_layers=2, bert_hidden=64,
                  bert_heads=2, bert_intermediate=128, proj_dim=32, vocab_size=64)
    base = BreastClipModule(**narrow)
    init_weights(base, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    batches = [{"images": rng.integers(0, 256, (6, 64, 48, 1), dtype=np.uint8),
                "image_views": rng.integers(0, 256, (6, 64, 48, 1), dtype=np.uint8),
                "input_ids": rng.integers(5, 64, (6, 12)), "attention_mask": np.ones((6, 12)),
                "input_ids2": rng.integers(5, 64, (6, 12)), "attention_mask2": np.ones((6, 12))}
               for _ in range(3)]
    runs = {}
    for dev in ("cpu", "cuda"):
        model = BreastClipModule(**narrow)
        model.load_state_dict(base.state_dict())
        model.to(dev)
        labels = {k: "frozen" if k.endswith(("_bn2.bias", "attention.self.key.bias")) else "train"
                  for k, _ in model.named_parameters()}
        optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 1, 10, param_labels=labels)
        step = make_clip_train_step(model, optimizer, scheduler, input_wire="u8",
                                    norm_mean=0.3, norm_std=0.25)
        before = fused_expand_dw.launches
        losses = [float(step(batch_to_device(b, torch.device(dev)))) for b in batches]
        assert fused_expand_dw.launches == before
        runs[dev] = ({k: v.cpu() for k, v in model.state_dict().items()}, losses)
    (cpu, cpu_losses), (gpu, gpu_losses) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
    outside = total = 0
    for k, v in cpu.items():
        if v.is_floating_point():
            err = (gpu[k] - v).abs()
            outside += int((err > 1e-5 + 1e-3 * float(v.abs().max())).sum())
            total += v.numel()
            assert float(err.max()) <= 6e-3, k
    assert outside <= 1e-4 * total, outside


@pytest.fixture
def nccl_rank(cuda):
    """A one-rank NCCL process group (world size 1) for the test, torn down after."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_synced_batchnorm_on_one_nccl_rank_equals_batchnorm(nccl_rank):
    """The data-parallel training BatchNorm through NCCL's collectives at world size 1,
    for a float32 and a bf16 input, against BatchNorm in float64 on the same (rounded)
    input and output gradient: the output and the input gradient (within 1e-5 of the
    largest entry in float32; one bf16 rounding, 2**-8, in bf16), the weight and bias
    gradients and flax's running statistics (float32: 1e-5). In float32 the local
    BatchNorm gives the same within 1e-5; in bf16 cuDNN's own backward rounds
    otherwise, so only the float64 reference holds it."""
    from mammodissect_torch.models.layers import BatchNorm2d
    from mammodissect_torch.parallel.mesh import data_parallel

    x = torch.randn(4, 24, 9, 7, generator=torch.Generator().manual_seed(1)) * 3 + 1
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    w = torch.empty(24).uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(3))
    for dtype in (torch.float32, torch.bfloat16):
        xr, gr = x.to(dtype).double().requires_grad_(True), g.to(dtype).double()
        mean, var = xr.mean((0, 2, 3)), xr.var((0, 2, 3), unbiased=False)
        y = (xr - mean[:, None, None]) / torch.sqrt(var + 1e-3)[:, None, None] * w.double()[:, None, None]
        (y * gr).sum().backward()
        xhat = (y / w.double()[:, None, None]).detach()
        want = (y.detach(), xr.grad, (gr * xhat).sum((0, 2, 3)), gr.sum((0, 2, 3)),
                0.01 * mean.detach(), 0.99 + 0.01 * var.detach())
        runs = {}
        for name, group in (("local", None), ("synced", nccl_rank)):
            bn = BatchNorm2d(24, eps=1e-3, momentum=0.01).cuda().train()
            with torch.no_grad():
                bn.weight.copy_(w)
            xi = x.cuda().to(dtype).clone().requires_grad_(True)
            with data_parallel(group):
                out = bn(xi)
            (out.float() * g.cuda()).sum().backward()
            runs[name] = (out, xi.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
                          bn.running_var)
        for i, (ref, got, local) in enumerate(zip(want, runs["synced"], runs["local"])):
            tol = 2 ** -8 if dtype == torch.bfloat16 and i < 2 else 1e-5
            scale = float(ref.abs().max())
            torch.testing.assert_close(got.double().cpu(), ref, rtol=tol, atol=tol * scale)
            if dtype == torch.float32:
                torch.testing.assert_close(got, local, rtol=1e-5, atol=1e-5 * scale)


def test_all_gather_with_grad_on_one_nccl_rank(nccl_rank):
    """At world size 1 the gather is the tensor and its backward the gradient."""
    from mammodissect_torch.parallel.collectives import all_gather_with_grad, psum
    from mammodissect_torch.parallel.multihost import gather_predictions

    x = torch.randn(3, 5, device="cuda", requires_grad=True)
    y = all_gather_with_grad(x, nccl_rank)
    w = torch.randn(3, 5, device="cuda")
    (y * w).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, w)
    assert torch.equal(psum(w, nccl_rank), w)
    np.testing.assert_array_equal(gather_predictions(np.arange(4.0), 3), np.arange(3.0))
