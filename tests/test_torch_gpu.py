"""The PyTorch port on a CUDA GPU: each CUDA kernel against its plain PyTorch version
on the card, and a tiny resident dissection on the card against the same run on the
CPU. Imports torch and the port only (no JAX), so it runs on a machine with a GPU:

    python -m pytest --noconftest tests/test_torch_gpu.py

Without a GPU every test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from mammodissect_torch.ops.cuda_mbconv import expand_dw_plain, fused_expand_dw
from mammodissect_torch.ops.cuda_wpmi import (
    soft_wpmi_gather_logsum,
    soft_wpmi_gather_logsum_plain,
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
    scale."""
    rng = np.random.default_rng(seed)
    bf16 = dtype == torch.bfloat16

    def t(*shape, scale=1.0, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None else rng.normal(size=shape) * scale
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return (t(b, h, w, cin, scale=0.1 if bf16 else 1.0).to(dtype),
            t(cin, cexp, scale=0.05 if bf16 else cin ** -0.5).to(dtype),
            t(cexp, lo=0.5), t(cexp, scale=0.1),
            t(k, k, cexp, scale=0.05 if bf16 else 0.2).to(dtype),
            t(cexp, lo=0.5), t(cexp, scale=0.1))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, dict(atol=2e-3, rtol=2e-2)),
                                       (torch.float32, dict(atol=1e-4, rtol=1e-4))])
@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 38, 29, 40, 240), (5, 19, 17, 64, 384),
                                            (3, 6, 5, 512, 3072), (5, 9, 33, 176, 1056)])
def test_mbconv_kernel_matches_plain(cuda, dtype, tol, k, h, w, cin, cexp):
    args = _mbconv_args(2, h, w, cin, cexp, k, dtype, cuda)
    before = fused_expand_dw.launches
    got = fused_expand_dw(*args)
    torch.cuda.synchronize()
    assert fused_expand_dw.launches == before + 1
    want = expand_dw_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 380, 228, 40, 240), (5, 190, 114, 64, 384)])
def test_mbconv_kernel_full_b5_shape(cuda, k, h, w, cin, cexp):
    """One full-resolution B5 block shape per k (blocks 4-7 and 9-12 at 1520x912)."""
    args = _mbconv_args(2, h, w, cin, cexp, k, torch.bfloat16, cuda)
    got = fused_expand_dw(*args)
    want = expand_dw_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, dict(atol=2e-3, rtol=2e-2)),
                                       (torch.float32, dict(atol=1e-4, rtol=1e-4))])
@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 21, 19, 24, 144), (5, 13, 11, 20, 120),
                                            (3, 10, 9, 40, 100), (5, 17, 18, 56, 104)])
def test_mbconv_kernel_odd_widths(cuda, dtype, tol, k, h, w, cin, cexp):
    """Cin not a multiple of 16 (24, 56) or of 8 (20: element-wise staging), Cexp not
    a multiple of the 48-channel tile (104, 120) or of 8 (100: element-wise stores)."""
    args = _mbconv_args(2, h, w, cin, cexp, k, dtype, cuda)
    got = fused_expand_dw(*args)
    want = expand_dw_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def _expand_dominant_args(b, h, w, cin, cexp, k, device, seed=6):
    """bf16 with x and the expand at unit scale, depthwise weights ~1/K^2 and no BN2
    bias: each output is about the mean of its window's expanded values, so a fault
    of the expand (a dropped channel chunk, a wrong tail tile) moves it far past the
    tolerance."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    def pos(n):
        return torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)

    return (t(b, h, w, cin).to(torch.bfloat16), t(cin, cexp, scale=cin ** -0.5).to(torch.bfloat16),
            pos(cexp), t(cexp, scale=0.1), ((1.0 + t(k, k, cexp, scale=0.1)) / k ** 2).to(torch.bfloat16),
            pos(cexp), torch.zeros(cexp, device=device))


@pytest.mark.parametrize("k,h,w,cin,cexp", [(3, 38, 29, 40, 240), (5, 19, 17, 64, 384),
                                            (5, 13, 11, 20, 120), (3, 21, 19, 24, 144),
                                            (5, 17, 18, 56, 104), (3, 6, 5, 512, 3072)])
def test_mbconv_kernel_expand_dominates(cuda, k, h, w, cin, cexp):
    """rtol 2^-7 is one to two bf16 ulps of the output; atol 4e-3 covers two one-ulp
    flips of the bf16 expanded tensor (weighted ~1/K^2) at outputs near 0."""
    args = _expand_dominant_args(2, h, w, cin, cexp, k, cuda)
    got = fused_expand_dw(*args)
    want = expand_dw_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3, rtol=2.0 ** -7)


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
