"""The yardstick's arithmetic against B5's shapes worked out by hand at 1520x912."""
from __future__ import annotations

import math

from benchmark.tests import _tiny  # noqa: F401  (puts the repo on sys.path)
from benchmark import flops
from benchmark.core import load_config
from benchmark.reference.efficientnet import block_table

# B5 at 1520x912: (blocks, k, stride, first block's in -> out channels, then out ->
# out; the first block's input H x W, every block's output H x W); the stem makes
# 48 channels at 760x456
STAGES = [(3, 3, 1, 48, 24, (760, 456), (760, 456)), (5, 3, 2, 24, 40, (760, 456), (380, 228)),
          (5, 5, 2, 40, 64, (380, 228), (190, 114)), (7, 3, 2, 64, 128, (190, 114), (95, 57)),
          (7, 5, 1, 128, 176, (95, 57), (95, 57)), (9, 5, 2, 176, 304, (95, 57), (48, 29)),
          (3, 3, 1, 304, 512, (48, 29), (48, 29))]
# kernel 2's blocks: (k, H, W, Cin, Cexp, how many)
KERNEL2 = [(3, 380, 228, 40, 240, 4), (5, 190, 114, 64, 384, 4), (3, 95, 57, 128, 768, 6),
           (5, 95, 57, 128, 768, 1), (5, 95, 57, 176, 1056, 6), (5, 48, 29, 304, 1824, 8),
           (3, 48, 29, 304, 1824, 1), (3, 48, 29, 512, 3072, 2)]


def cfg():
    return load_config("mammoclip_b5_bf16")


def test_block_table_is_b5():
    blocks = block_table(cfg())
    assert len(blocks) == 39
    assert sum(b["cout"] for b in blocks) == 6992
    assert [b["k"] for b in blocks] == [k for n, k, *_ in STAGES for _ in range(n)]


def test_tower_flops_by_hand():
    macs = 760 * 456 * 48 * 3 * 9
    for n, k, stride, cin, cout, in_hw, out_hw in STAGES:
        for r in range(n):
            c_in = cin if r == 0 else cout
            expand = 1 if c_in == 48 or (cin == 48 and r > 0) else 6
            hw_in = in_hw if r == 0 else out_hw
            cexp = c_in * expand
            if expand != 1:
                macs += hw_in[0] * hw_in[1] * c_in * cexp
            macs += out_hw[0] * out_hw[1] * cexp * (k * k + cout)
            macs += 2 * cexp * int(c_in * 0.25)
    macs += 48 * 29 * 512 * 2048
    assert math.isclose(flops.tower_flops(cfg()), 2 * macs, rel_tol=1e-12)
    assert 130e9 < 2 * macs < 140e9  # ~132 GFLOP an image


def test_kernel2_shapes_and_bound_by_hand():
    shapes = [(s["k"], s["h"], s["w"], s["cin"], s["cexp"]) for s in flops.kernel2_shapes(cfg())]
    assert shapes == [(k, h, w, ci, ce) for k, h, w, ci, ce, n in KERNEL2 for _ in range(n)]
    # blocks 4-7 in bf16 at batch 16: x and the output read and written once (2 bytes),
    # both weights, six BatchNorm terms and the squeeze (4 bytes), against the
    # expand at 989 and the depthwise at 67 TFLOP/s
    pix = 16 * 380 * 228
    nbytes = pix * (40 + 240) * 2 + (40 * 240 + 9 * 240) * 2 + 6 * 240 * 4 + 16 * 240 * 4
    ops = max(2 * pix * 40 * 240 / 989e12, 2 * 9 * pix * 240 / 67e12)
    got = flops.kernel2_bound(16, 380, 228, 40, 240, 3, True)
    assert math.isclose(got["seconds"], max(nbytes / 3.35e12, ops), rel_tol=1e-12)
    assert got["by"] == "bytes"
    # fp32: 4-byte tensors, the expand as three TF32 products at 495 TFLOP/s
    got = flops.kernel2_bound(16, 48, 29, 512, 3072, 3, False)
    pix = 16 * 48 * 29
    nbytes = pix * (512 + 3072) * 4 + (512 * 3072 + 9 * 3072) * 4 + 6 * 3072 * 4 + 16 * 3072 * 4
    ops = max(3 * 2 * pix * 512 * 3072 / 495e12, 2 * 9 * pix * 3072 / 67e12)
    assert math.isclose(got["seconds"], max(nbytes / 3.35e12, ops), rel_tol=1e-12)
    forward = flops.kernel2_forward(cfg(), 16, True)
    assert forward["launches"] == 32


def test_kernel1_bound_by_hand():
    got = flops.kernel1_bound(6992, 763, 100, 1024)
    ops = 4 * 6992 * 100 * 763 / 67e12
    nbytes = (1024 * 763 + 6992 * 100 + 100 + 6992 * 763) * 4
    assert math.isclose(got["seconds"], max(ops, nbytes / 3.35e12), rel_tol=1e-12)
    assert got["by"] == "operations"


def test_job_and_step_least_times_by_hand():
    c = cfg()
    tower = flops.tower_flops(c)
    bert = 2 * 763 * 256 * 12 * (4 * 768 * 768 + 2 * 768 * 3072 + 2 * 256 * 768)
    proj = 2 * (1024 * 2048 + 763 * 768) * 512
    scoring = 4 * 6992 * 100 * 763 + 2 * 1024 * 763 * 512
    want = (1024 * tower + bert + proj) / 989e12 + scoring / 495e12
    got = flops.dissect_job_seconds(c, c, 1024, 763, 100, staged=False)
    assert math.isclose(got, want, rel_tol=1e-12)
    clf = load_config("mammoclip_b5_classifier")
    staged = flops.dissect_job_seconds(clf, c, 512, 763, 100, staged=True)
    want = (512 * tower / 495e12 + (512 * tower + bert + 2 * (512 * 2048 + 763 * 768) * 512) / 989e12
            + (4 * 6992 * 100 * 763 + 2 * 512 * 763 * 512) / 495e12)
    assert math.isclose(staged, want, rel_tol=1e-12)
    assert math.isclose(flops.train_step_seconds(clf, 8), 3 * 8 * (tower + 2 * 2048) / 989e12,
                        rel_tol=1e-12)
