"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no result):
  1. card: name and power limit (nvidia-smi);
  2. build: both CUDA kernels from csrc/, one nvcc each, started together (always
     compiled, so that ptxas's figures are printed);
  3. kernel 1 (soft-WPMI gather + log-reduce) against its plain PyTorch version at
     the main path's shape (U = 6992 units, C = 762 concepts, k = 100, N = the probe),
     and at p = 1 with clip_sm near 0 (every term near eps: the underflow guard); an
     index outside [0, N) must raise;
  4. kernel 2 (MBConv expand + depthwise) against its plain version at every
     EfficientNet-B5 block shape of the main path: bf16 at the main path's batch,
     bf16 at unit scale where the expand dominates each output, and fp32, both at
     batch 2;
  5. times: each kernel (kernel 1 through its wrapper, as the first version was
     timed, and its launch alone), its plain version and its bound (the least time
     an H100 SXM could take for the same work: 3.35 TB/s, 989 TFLOP/s bf16 tensor,
     67 TFLOP/s fp32);
  6. the main path: `run_dissection` resident at full width (B5 at 1520x912, all 39
     blocks, 12-layer BERT, the 762 concepts, soft-WPMI, bf16 tower) on random
     weights from a seed and mammogram-shaped synthetic images; the kernels' launch
     counts are zeroed just before and read just after;
  7. end-to-end agreement: the same resident dissection at a small geometry in fp32
     (TF32 off) on the card (kernels) and on the CPU (plain versions).

Phase 2 also prints nvcc's -Xptxas=-v figures (registers, spills) of every kernel
and fails when kernel 1 or a bf16 instantiation of kernel 2 spills. Prints the
card's name and power limit and a JSON line {"kernels": [...]} before the last
line; the last line is {"ok": true, "device": {...}}. Imports torch and the port
only."""
from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

MAIN_N = 1024          # probe images of the main path
MAIN_BATCH = 16
IMAGE_HW = (1520, 912)
POOL = 64              # unique synthetic mammograms, repeated cyclically
CONCEPTS = os.path.join(ROOT, "mammodissect", "assets", "concepts",
                        "Specific_concepts_sorted.txt")
# (k, H, W, Cin, Cexp, number of B5 blocks of this shape, the first version's ms)
# at 1520x912; the last column is the first CUDA version's time per launch at batch
# 16, bf16 (PERF.md, NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
B5_SHAPES = [
    (3, 380, 228, 40, 240, 4, 6.163),      # blocks 4-7
    (5, 190, 114, 64, 384, 4, 2.999),      # 9-12
    (3, 95, 57, 128, 768, 6, 2.153),       # 14-19
    (5, 95, 57, 128, 768, 1, 2.474),       # 20
    (5, 95, 57, 176, 1056, 6, 4.818),      # 21-26
    (5, 48, 29, 304, 1824, 8, 3.217),      # 28-35
    (3, 48, 29, 304, 1824, 1, 2.840),      # 36
    (3, 48, 29, 512, 3072, 2, 7.223),      # 37-38
]
FIRST_VERSION_MS = {"wpmi": 0.923, "mbconv_forward": 124.0}  # same source and card


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of fn() on the card: CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mammo_pool(n, h, w, seed):
    """Mammogram-shaped uint8 images: a half-ellipse breast attached to one lateral
    edge, textured, on exactly black background (~40-60% of the frame)."""
    rng = np.random.default_rng(seed)
    pool = np.zeros((n, h, w, 1), np.uint8)
    yy = (np.arange(h) + 0.5) / h
    xx = (np.arange(w) + 0.5) / w
    for i in range(n):
        cy, ry, rx = rng.uniform(0.35, 0.65), rng.uniform(0.45, 0.58), rng.uniform(0.55, 0.75)
        dx = xx if rng.integers(2) == 0 else 1.0 - xx
        mask = ((yy[:, None] - cy) / ry) ** 2 + (dx[None, :] / rx) ** 2 <= 1.0
        tex = rng.integers(40, 256, size=(h, w), dtype=np.uint8)
        pool[i, :, :, 0] = tex * mask
    return pool


class CyclicProbe:
    """N-image probe over a small pool (image i is pool image i % len(pool))."""

    def __init__(self, pool, n, mean=0.3089279, std=0.25053555):
        self.pool, self.n, self.mean, self.std = pool, n, mean, std
        self.image_shape = tuple(pool.shape[1:])

    def __len__(self):
        return self.n

    def image_u8(self, i):
        return self.pool[i % len(self.pool)]


def phase_card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(out.splitlines()[0])
    return out.splitlines()[0]


def ptxas_summary(log):
    """[{function, registers, stack_frame, spill_stores, spill_loads, static_smem}]
    from nvcc's -Xptxas=-v output, one entry per compiled kernel."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur["stack_frame"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                s = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(s.group(1)) if s else 0
    return rows


# label -> a fragment of the mangled name, for every kernel the sources compile
KERNEL_LABELS = {"mbconv bf16 k3": "expand_dw_bf16_kernelILi3",
                 "mbconv bf16 k5": "expand_dw_bf16_kernelILi5",
                 "mbconv fp32 k3": "expand_dw_f32_kernelILi3",
                 "mbconv fp32 k5": "expand_dw_f32_kernelILi5",
                 "wpmi slab": "gather_logsum_slab_kernel",
                 "wpmi gather": "gather_logsum_kernel"}


def kernel_label(function):
    for label, key in KERNEL_LABELS.items():
        if key in function:
            return label
    return function


def phase_build():
    """Both kernels built from csrc/ with -Xptxas=-v; fails when a bf16 instantiation
    of kernel 2 or kernel 1 spills registers."""
    from mammodissect_torch.ops import kernels

    t0 = time.perf_counter()
    report = kernels.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    say(f"[build] {sorted(report)} in {seconds:.2f} s (nvcc, sm_90a, in parallel)")
    seen = set()
    for name in sorted(report):
        for row in ptxas_summary(report[name]["log"]):
            row["kernel"] = kernel_label(row.pop("function"))
            seen.add(row["kernel"])
            say(f"[ptxas] {row['kernel']}: {row.get('registers')} registers, "
                f"{row.get('static_smem')} bytes static smem, {row.get('stack_frame')} bytes "
                f"stack frame, {row.get('spill_stores')} bytes spill stores, "
                f"{row.get('spill_loads')} bytes spill loads")
            if "fp32" not in row["kernel"]:
                check(row.get("spill_stores") == 0 and row.get("spill_loads") == 0,
                      f"{row['kernel']} spills registers: {row}")
    missing = set(KERNEL_LABELS) - seen
    check(not missing, f"no ptxas figures for {sorted(missing)}")
    return seconds


def phase_wpmi(n_images, device):
    import torch

    from mammodissect_torch.ops.cuda_wpmi import (
        _launch,
        soft_wpmi_gather_logsum,
        soft_wpmi_gather_logsum_plain,
    )

    u, c, k = 6992, 762, 100
    g = torch.Generator(device="cpu").manual_seed(1)
    clip_sm = torch.softmax(torch.randn((n_images, c), generator=g) * 4, dim=1).to(device)
    inds = torch.randint(0, n_images, (u, k), generator=g, dtype=torch.int32).to(device)
    p_in = (0.998 - torch.arange(k) / 100 * (0.998 - 0.97)).float().to(device)
    # the underflow guard: p = 1 and clip_sm near 0, so every term is near eps = 1e-7
    # and a product of a few terms would leave fp32's range without it
    near_zero = (torch.rand((n_images, c), generator=g) * 1e-6).to(device)
    # N = 4 x the probe: clip_sm's column block no longer fits shared memory, so the
    # kernel takes its L2 gather design (the main path's N takes the slab design)
    n_large = 4 * n_images
    large = torch.softmax(torch.randn((n_large, c), generator=g) * 4, dim=1).to(device)
    inds_large = torch.randint(0, n_large, (u, k), generator=g, dtype=torch.int32).to(device)
    errs = {}
    for case, (x, ind, p) in {
            "main": (clip_sm, inds, p_in),
            "p=1, clip_sm near 0": (near_zero, inds, torch.ones_like(p_in)),
            f"gather design, N={n_large}": (large, inds_large, p_in)}.items():
        got = soft_wpmi_gather_logsum(x, ind, p)
        want = soft_wpmi_gather_logsum_plain(x, ind, p)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(want).all()), f"kernel 1 ({case}): plain version not finite")
        err = (got - want).abs()
        check(bool((err <= 1e-5 + 1e-5 * want.abs()).all()),
              f"kernel 1 disagrees ({case}): max abs err {float(err.max())}")
        errs[case] = float(err.max())
        say(f"[kernel 1] {case}: max abs err {errs[case]:.3g} on values down to "
            f"{float(want.min()):.1f} (tol 1e-5 + 1e-5|x|)")
    try:  # an index outside [0, N) raises, from the kernel's own check
        soft_wpmi_gather_logsum(clip_sm, torch.full_like(inds, n_images), p_in)
        raised = False
    except IndexError:
        raised = True
    check(raised, "kernel 1 took an index outside [0, N) without raising")
    # ms: through the wrapper, the first version's span (shape checks, the launch, the host
    # read of the kernel's index flag); launch_ms: the kernel's launch alone
    ms = cuda_ms(lambda: soft_wpmi_gather_logsum(clip_sm, inds, p_in), reps=20, warmup=2)
    launch_ms = cuda_ms(lambda: _launch(clip_sm, inds, p_in, 1e-7), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: soft_wpmi_gather_logsum_plain(clip_sm, inds, p_in), reps=3)
    large_ms = cuda_ms(lambda: soft_wpmi_gather_logsum(large, inds_large, p_in), reps=20, warmup=2)
    bytes_ = n_images * c * 4 + u * k * 4 + k * 4 + u * c * 4
    ops = u * k * c * 4  # per term: x - 1, multiply-add by p, + eps, multiply into the product
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    row = {"shape": {"U": u, "C": c, "k": k, "N": n_images}, "max_abs_err": max(errs.values()),
           "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms, "gather_design_ms": large_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    say(f"[kernel 1] U={u} C={c} k={k} N={n_images}: {ms:.4f} ms through the wrapper (first "
        f"version {FIRST_VERSION_MS['wpmi']} ms, same span), launch alone {launch_ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
        f"N={n_large} (gather design) {large_ms:.4f} ms through the wrapper")
    return row


def _mbconv_args(b, h, w, cin, cexp, k, dtype, device, seed, expand_dominant=False):
    """Random inputs of kernel 2. bf16 uses the scales of tests/test_pallas_mbconv.py
    (x 0.1, weights 0.05), where its 2e-3/2e-2 tolerance was set: at unit scale a
    one-ulp difference in the bf16-rounded expanded tensor (the two versions sum the
    expand in another order before rounding) exceeds it. fp32 runs at unit scale.

    expand_dominant (bf16): x and the expand at unit scale, depthwise weights ~1/K^2
    and no BN2 bias, so each output is about the mean of its window's expanded values
    and any fault of the expand (a dropped channel chunk, a wrong tail tile) moves it
    far past EXPAND_DOMINANT_TOL."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    bf16 = dtype == torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    def pos(n):
        return (torch.rand((n,), generator=g) + 0.5).to(device)

    if expand_dominant:
        w_dw = (1.0 + rnd(k, k, cexp, scale=0.1)) / (k * k)
        return (rnd(b, h, w, cin).to(dtype), rnd(cin, cexp, scale=cin ** -0.5).to(dtype),
                pos(cexp), rnd(cexp, scale=0.1), w_dw.to(dtype), pos(cexp),
                torch.zeros(cexp, device=device))
    return (rnd(b, h, w, cin, scale=0.1 if bf16 else 1.0).to(dtype),
            rnd(cin, cexp, scale=0.05 if bf16 else cin ** -0.5).to(dtype),
            pos(cexp), rnd(cexp, scale=0.1), rnd(k, k, cexp, scale=0.05 if bf16 else 0.2).to(dtype),
            pos(cexp), rnd(cexp, scale=0.1))


# bf16 at unit scale: rtol 2^-7 is one to two bf16 ulps of the output; atol covers two
# one-ulp flips of the bf16 expanded tensor (weighted ~1/K^2) at outputs near 0
EXPAND_DOMINANT_TOL = (4e-3, 2.0 ** -7)


def phase_mbconv(device):
    import torch

    from mammodissect_torch.ops.cuda_mbconv import expand_dw_plain, fused_expand_dw

    rows = []
    for i, (k, h, w, cin, cexp, n_blocks, first_ms) in enumerate(B5_SHAPES):
        row = {"k": k, "H": h, "W": w, "Cin": cin, "Cexp": cexp, "blocks": n_blocks}
        for name, dtype, b, (atol, rtol) in (
                ("bf16", torch.bfloat16, MAIN_BATCH, (2e-3, 2e-2)),
                ("bf16_unit", torch.bfloat16, 2, EXPAND_DOMINANT_TOL),
                ("fp32", torch.float32, 2, (1e-4, 1e-4))):
            args = _mbconv_args(b, h, w, cin, cexp, k, dtype, device, seed=10 + i,
                                expand_dominant=name == "bf16_unit")
            got = fused_expand_dw(*args).float()
            want = expand_dw_plain(*args).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            check(bool((err <= atol + rtol * want.abs()).all()),
                  f"kernel 2 disagrees ({name}, {row}): max abs err {float(err.max())}")
            edge = torch.cat([err[:, :2].flatten(), err[:, -2:].flatten(),
                              err[:, :, :2].flatten(), err[:, :, -2:].flatten()])
            row[f"max_abs_err_{name}"] = float(err.max())
            row[f"border_max_abs_err_{name}"] = float(edge.max())
            if name == "bf16":
                row["ms"] = cuda_ms(lambda: fused_expand_dw(*args), reps=5)
                row["plain_ms"] = cuda_ms(lambda: expand_dw_plain(*args), reps=2)
                pix = b * h * w
                bytes_ = pix * (cin + cexp) * 2 + (cin * cexp + k * k * cexp) * 2 + 4 * cexp * 4
                t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
                t_expand = 2 * pix * cin * cexp / BF16_TENSOR_FLOPS * 1e3
                t_dw = 2 * k * k * pix * cexp / FP32_FLOPS * 1e3
                row["bound_ms"] = max(t_bytes, t_expand, t_dw)
                row["bound_by"] = "bytes" if t_bytes >= max(t_expand, t_dw) else "operations"
            del args, got, want, err
        rows.append(row)
        say(f"[kernel 2] k{k} {cin}->{cexp} @ {h}x{w} B={MAIN_BATCH} bf16: "
            f"max abs err {row['max_abs_err_bf16']:.3g} (border {row['border_max_abs_err_bf16']:.3g}); "
            f"bf16 unit scale B=2: {row['max_abs_err_bf16_unit']:.3g} "
            f"(border {row['border_max_abs_err_bf16_unit']:.3g}); "
            f"fp32 B=2: {row['max_abs_err_fp32']:.3g}; {row['ms']:.4f} ms (first version "
            f"{first_ms:.3f} ms), plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    torch.cuda.empty_cache()
    return rows


def phase_main_path(device):
    import torch

    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum

    t0 = time.perf_counter()
    probe = CyclicProbe(mammo_pool(POOL, *IMAGE_HW, seed=0), MAIN_N)
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy WordPiece vocab (no vocab.txt in the repo)
        dissector = get_dissector("breastclip", device=device, dtype="bfloat16",
                                  bert_layers=12, seed=0)
    build_s = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg = DissectConfig(target_model="breastclip", clip_model="breastclip",
                        target_layers=[f"blocks.{i}" for i in range(39)], d_probe="synthetic_mammo",
                        concept_set=CONCEPTS, batch_size=MAIN_BATCH, similarity_fn="soft_wpmi",
                        resident=True, device="cuda", activation_dir=os.path.join(work, "acts"),
                        result_dir=os.path.join(work, "results"))
    torch.cuda.reset_peak_memory_stats()
    fused_expand_dw.launches = 0
    soft_wpmi_gather_logsum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df, csv_path = run_dissection(cfg, probe=probe, dissector=dissector, log=lambda *_: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mbconv": fused_expand_dw.launches, "wpmi": soft_wpmi_gather_logsum.launches}
    n_batches = -(-MAIN_N // MAIN_BATCH)
    sims = np.array([json.loads(s) if isinstance(s, str) else s for s in df["similarity"]])
    check(len(df) == 6992, f"CSV has {len(df)} rows, expected 6992")
    check(np.isfinite(sims).all(), "non-finite similarities in the CSV")
    check(launches["mbconv"] == 32 * n_batches,
          f"MBConv kernel launched {launches['mbconv']} times, expected {32 * n_batches}")
    check(launches["wpmi"] >= 1, "soft-WPMI kernel never launched on the main path")
    row = {"images": MAIN_N, "batch": MAIN_BATCH, "batches": n_batches, "wall_s": wall,
           "img_per_s": MAIN_N / wall, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "rows": len(df), "pool_s": pool_s, "model_build_s": build_s}
    say(f"[main path] {MAIN_N} images at {IMAGE_HW[0]}x{IMAGE_HW[1]}, B5 x 39 blocks, 12-layer "
        f"BERT, 762 concepts, soft-WPMI, bf16: {wall:.2f} s wall, {row['img_per_s']:.2f} img/s, "
        f"peak {row['max_memory_allocated_bytes'] / 2**30:.2f} GiB; launches {launches}; "
        f"{len(df)} CSV rows, similarities finite")
    return row


def phase_agreement():
    import torch

    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
    from mammodissect_torch.models.breastclip import BreastClip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu = get_dissector("breastclip", device="cpu", bert_layers=2, seed=1)
    gpu = BreastClip(copy.deepcopy(cpu.module).to("cuda"), tokenizer=cpu.tokenizer, device="cuda")
    cpu.max_length = gpu.max_length = 32  # the concepts are short; keeps the CPU side quick
    probe = CyclicProbe(mammo_pool(32, 160, 96, seed=1), 32)
    work = tempfile.mkdtemp(prefix="chip_smoke_agree_")
    dfs = {}
    for name, d in (("cpu", cpu), ("cuda", gpu)):
        cfg = DissectConfig(target_model="breastclip", clip_model="breastclip",
                            target_layers=[f"blocks.{i}" for i in range(39)],
                            d_probe="synthetic_mammo_small", concept_set=CONCEPTS, batch_size=8,
                            resident=True, device=name, top_k=100,
                            activation_dir=os.path.join(work, name, "acts"),
                            result_dir=os.path.join(work, name, "results"))
        dfs[name], _ = run_dissection(cfg, probe=probe, dissector=d, log=lambda *_: None)
    top = {k: [row[0] for row in df["description"]] for k, df in dfs.items()}
    agree = float(np.mean([a == b for a, b in zip(top["cpu"], top["cuda"])]))
    images = float(np.mean([a == b for a, b in zip(dfs["cpu"]["images"], dfs["cuda"]["images"])]))
    say(f"[agreement] B5 x 39 blocks at 160x96, 32 images, fp32, TF32 off: top-1 concept "
        f"agreement card vs CPU {agree:.4f}, identical top-image lists {images:.4f}")
    check(agree >= 0.99, f"top-1 concept agreement {agree} < 0.99")
    return {"top1_agreement": agree, "top_images_identical": images}


def main():
    import torch

    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA GPU available")
        return 1
    sys.path.insert(0, ROOT)
    import mammodissect_torch  # noqa: F401  (fails outside a checkout of the repo)
    from mammodissect_torch.device import set_fp32_policy

    set_fp32_policy()
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    wpmi = phase_wpmi(MAIN_N, device)
    mbconv = phase_mbconv(device)
    say("[library] library_ms n/a for both kernels: no single PyTorch call computes "
        "either fused function")
    main_path = phase_main_path(device)
    agreement = phase_agreement()

    per_forward = lambda key: sum(r[key] * r["blocks"] for r in mbconv)  # noqa: E731
    t_bytes_share = sum(r["bound_ms"] * r["blocks"] for r in mbconv if r["bound_by"] == "bytes")
    kernels = [
        {"name": "soft_wpmi_gather_logsum", "route": "cuda",
         "source": "mammodissect_torch/csrc/wpmi_gather_logsum.cu",
         "replaces": "mammodissect/ops/pallas_wpmi.py:81",
         "launches": main_path["launches"]["wpmi"], "max_abs_err": wpmi["max_abs_err"],
         # ms and wrapper_ms: through the wrapper (the first version's span); launch_ms: alone
         "ms": wpmi["ms"], "wrapper_ms": wpmi["ms"], "launch_ms": wpmi["launch_ms"],
         "plain_ms": wpmi["plain_ms"], "bound_ms": wpmi["bound_ms"],
         "bound_by": wpmi["bound_by"], "library_ms": None},
        {"name": "fused_expand_dw", "route": "cuda",
         "source": "mammodissect_torch/csrc/mbconv_expand_dw.cu",
         "replaces": "mammodissect/ops/pallas_mbconv.py:118",
         "launches": main_path["launches"]["mbconv"],
         "max_abs_err": max(r["max_abs_err_bf16"] for r in mbconv),
         # one forward's 32 launches at the main path's batch
         "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
         "bound_ms": per_forward("bound_ms"),
         "bound_by": "bytes" if t_bytes_share * 2 >= per_forward("bound_ms") else "operations",
         "library_ms": None},
    ]
    say(f"[kernel 2] one forward's 32 launches at batch {MAIN_BATCH}, bf16: "
        f"{per_forward('ms'):.3f} ms (first version {FIRST_VERSION_MS['mbconv_forward']} ms), "
        f"bound {per_forward('bound_ms'):.3f} ms")
    say(f"[done] torch {torch.__version__}, CUDA {torch.version.cuda}, build {build_s:.2f} s, "
        f"agreement {agreement['top1_agreement']:.4f}, total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
