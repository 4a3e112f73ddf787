"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no result):
  1. card: name and power limit (nvidia-smi);
  2. build: the three CUDA kernels from csrc/, one nvcc each, started together (always
     compiled, so that ptxas's figures are printed);
  3. kernel 1 (soft-WPMI gather + log-reduce) against its plain PyTorch version at
     the main path's shape (U = 6992 units, C = 762 concepts, k = 100, N = the probe),
     and at p = 1 with clip_sm near 0 (every term near eps: the underflow guard); an
     index outside [0, N) must raise;
  4. kernel 2 (MBConv expand + depthwise) against its plain version at every
     EfficientNet-B5 block shape of the main path: bf16 at the main path's batch,
     bf16 at unit scale where the expand dominates each output, bf16 whose BatchNorm
     outputs reach every branch of the SiLU table (`bf16_wide`), and fp32, the last
     three at batch 2; first, the card's SiLU table against the CPU's, and the card's
     sigmoid over all 65536 bf16 values against the entries the kernel reads; then
     kernel 3 (the bf16 tower's BatchNorm epilogue) against its plain version (the
     ATen chain) at each of the 52 sites of a B5 bf16 forward at the main path's batch
     (7 with the SE's squeeze), output and squeeze bit for bit, two launches identical,
     each site timed through the wrapper beside its plain version and its bound (bytes
     at 3.35 TB/s);
  5. times: each kernel (kernel 1 through its wrapper, as the first version was
     timed, and its launch alone), its plain version and its bound (the least time
     an H100 SXM could take for the same work: 3.35 TB/s, 989 TFLOP/s bf16 tensor,
     495 TFLOP/s tf32 tensor (kernel 2's fp32 expand: three tf32 products), 67
     TFLOP/s fp32); kernel 2's squeeze (the SE's sum over H x W) against its plain
     version's at every shape and input set, within 1e-5 of the sum of |values| over
     H x W in bf16 (the values agree bit for bit, the sums' order differs) and within
     the elementwise tolerance summed over H x W in fp32; its bf16 output bit for bit
     the plain version's; two launches give the same output and squeeze; its fp32
     output within 1e-5 + 1e-5 |x| of the same function in float64 at every shape of
     `tests/_mbconv_f64.py`'s PRECISION_SHAPES (expand-dominant inputs);
  6. the main path: `run_dissection` resident at full width (B5 at 1520x912, all 39
     blocks, 12-layer BERT, the 762 concepts, soft-WPMI, bf16 tower) on random
     weights from a seed and mammogram-shaped synthetic images; the kernels' launch
     counts are zeroed just before and read just after (kernel 2 32 times a batch,
     kernel 3 52, 7 of them with a squeeze; the same counts are checked in phase 8's
     bf16 embed, in phase 10's eval batch and in phase 15's bf16 runs, and 0 kernel-3
     launches in phase 8's fp32 target, the train and pretraining steps and phase 15's
     fp32 runs);
  7. end-to-end agreement: the same resident dissection at a small geometry in fp32
     (TF32 off) on the card (kernels) and on the CPU (plain versions);
  8. C-Mammo-CLIP Dissect, staged through the disk cache, at full width: the
     fine-tuned classifier target (B5 at 1520x912, fp32 as in the JAX package, random
     weights from seed 2, all 39 blocks) dissected by the bf16 BreastClip (12-layer
     BERT, seed 0), 762 concepts, soft-WPMI, 512 images; kernel 2 launches 32 times a
     batch in the target's fp32 harvest and 32 in the dissector's bf16 embed, kernel 1
     in the staged scoring. A second run must find every cache file and skip both
     harvests. Also kernel 2's fp32 time at each B5 shape at batch 16, beside the
     previous fp32 design's (3xTF32 on mma.sync in 16 x 15 tiles, measured with it
     in one call) and both bounds (3xTF32 and the fp32 FMAs); the fp32 launches each
     launch the weight split (`split_weights_kernel`) once;
  9. the packed uint8 wire: a 16-image batch packed by the native packer and
     unpacked on the card must equal the batch; the resident main path on 256 images
     with the packed and the plain wire (in turns: plain, packed, packed, plain) must
     write the same top images and >= 0.99 of the top-1 concepts; img/s, wire bytes
     and the host's packing time per batch of each, and what "auto" decides;
 10. fine-tuning at full width (B5 classifier at 1520x912, batch 8, bf16 compute over
     float32 weights, the uint8 wire, BCE with VinDr Mass's pos-weight, AdamW 5e-5 /
     1e-4, random weights from a seed, batches from the mammogram pool): (a) two
     warm-up and ten timed train steps, ms a step, img/s and peak memory, a finite
     loss, changed weights and BatchNorm statistics, no kernel-2 launch in a train
     step; the same with remat: the same first loss, a lower peak; (b) an eval batch
     of the trained model launches kernel 2's bf16 instantiation 32 times, its
     checkpoint loads as the `breastclip_classifier` C-dissect target (fp32) with an
     equal state dict and the logits of the trained model computed in fp32;
     (c) `do_experiments` end to end (one epoch, 32 train and 16 valid synthetic
     mammogram PNGs, label Mass) writes the `.pth` and the out-of-fold CSV, its wall
     time split into host loading/augmentation and train/eval steps, kernel 2
     launched 32 times an eval batch; (d) three fp32 train steps (TF32 off) of the
     test arch at a small geometry on the card and on the CPU agree.
 11. G-dissect and zero-shot evaluation with the OpenAI CLIP towers (random weights
     from seed 0, float32, TF32 off): (a) `run_dissection` staged, target ViT-B/16 with
     all 12 `layers.i` (9216 units) dissected by ViT-B/16, the concept set
     BPE-tokenized through the 12-layer causal text tower, soft-WPMI, the `synthetic`
     probe at 224x224x3 (N = 2048), batch 128, the disk cache in a temp dir: img/s,
     the seconds of each stage from the run's log lines, peak memory, kernel 1
     launched once and kernel 2 never; (b) kernel 1 at (a)'s shape (U = 9216, k = 100,
     N = 2048: the L2 gather design) against its plain version, timed through the
     wrapper and alone, with its bound; (c) `clip_rn50` as target (conv1 and
     layer1-4, 3904 units) on the same probe and activation dir: it reuses (a)'s
     dissector image and text caches; (d) a narrow ViT G-dissect on the card (kernel
     1) and on the CPU (plain versions): the same top images and >= 0.99 of the top-1
     concepts; (e) `cli.zseval` with the bf16 BreastClip (B5 at 1520x912) on a `csv:`
     probe of phase 10's mammogram PNGs (label Mass): a finite AUROC, img/s, kernel 2
     launched 32 times a batch; then with ViT-B/16 on an RGB folder probe; (f) the
     CIFAR-100 probe, resolved by name (`cifar100_val`) through a stand-in
     `torchvision` whose CIFAR100 gives seeded uint8 images of the test split's shape
     (10000 x 32 x 32 x 3, 100 classes; no CIFAR-100 files are in the repo): (a)'s
     dissection with both towers at `image_size` 32 (9216 units), img/s, stage
     seconds, peak memory, kernel 1 launched once and kernel 2 never; kernel 1 at its
     shape (U = 9216, k = 100, N = 10000) against its plain version, timed, with its
     bound; (d)'s narrow comparison on 512 stand-in images at 32x32.
 12. the target zoo (random weights from seeds, float32 batches, TF32 off), each run
     reading the dissector's image and text caches of an earlier phase: (a) `resnet50`
     (conv1, layer1-4: 3904 units) and `vit` (the HF ViT-B/16, 12 layers: 9216 units)
     on phase 11's 2048 images, dissected by ViT-B/16; (b) `breastclip_swin`
     (swin-tiny, 4 stages: 1440 units) on phase 8's 512 mammogram-shaped images at
     1520x912, dissected by the bf16 breastclip: wall, img/s, stage seconds, peak
     memory, rows, finite similarities, kernel 1 launched once and kernel 2 never (no
     B5 forward: the caches are read); kernel 1 at each run's shape against its plain
     version, timed, with its bound; (c) a narrow ResNet, ViT and Swin, each dissected
     on the card and on the CPU by a narrow CLIP ViT: identical top-1 concepts and top
     images; BreastClip with a narrow Swin and a narrow ViT image tower embedding the
     same images on both (1e-4 on the unit-norm embeddings).
 13. the rest of the EfficientNet family and contrastive pretraining: (a) the staged
     C-dissect of an EfficientNetV2-S classifier (fp32 as the JAX target, all 40
     blocks: 6544 units, random weights from seed 2) on phase 8's 512 mammograms at
     1520x912, reading phase 8's dissector caches: img/s, harvest seconds, peak
     memory, kernel 2 launched 28 times a batch and kernel 1 once; kernel 1 at its
     shape, and kernel 2 against its plain version at each V2 MBConv shape in fp32 and
     bf16, timed with its bound; (b) ten timed pretraining steps at full width (B5 +
     12-layer BERT with Bio_ClinicalBERT's 28996-token vocab, bf16 over fp32 weights,
     batch 4 with the second text view and the image view, 256 tokens), without and
     with BERT's gradient checkpoint in turns (plain, checkpoint, checkpoint, plain),
     one step of each under torch.profiler (the device ops whose time the checkpoint
     adds), then batch 8 once (fits or not, and the peak), no kernel launched; (c)
     `cli.pretrain` for one epoch on phase 10's PNGs with a generated CSV of *_FINDING
     labels; its final.pth builds the breastclip dissector with equal weights; (d)
     three narrow pretraining steps and a V2-S tower on the card and on the CPU.
 14. the data- and tensor-parallel paths, each rank a process of its own (this script
     with `--rank` arguments) in one process group, under one shared timeout: first the
     single-process references (the resident M-dissect on 250 and on 64 images, the
     first full-width pretraining step); then (a) two gloo ranks sharing the card (the
     card holds one NCCL rank at most): the resident M-dissect at full width on 250
     images (each rank its HostShardedProbe shard of 125, 32 kernel-2 launches a batch
     and one kernel-1 launch a rank, counted in each rank; the gathered rows' CSV
     against the single process: >= 0.99 top-1 agreement, the share of identical top
     images reported), DP fine-tuning of the B5 classifier at full width (global batch
     8, 4 a rank, bf16, three steps, the ranks' weights equal after, then an eval batch
     through kernel 2 and gather_predictions), and a DP + TP (1, 2) pretraining step at
     full width (B5 + 12-layer BERT with the 28996-row vocab split over the ranks,
     global batch 4 without the image view) whose first loss is within 2e-2 of the
     single process's; (c) on the same ranks, narrow DP fine-tune steps and a narrow TP
     pretraining step on the card and on the CPU (the tolerances of 10d and 13d); (b)
     one NCCL rank (world size 1) through the distributed path on 64 images writes the
     single process's CSV exactly. Wall of each part, img/s of both runs, ms a step and
     peak memory a rank. Two ranks sharing one card measure gloo and the sharing, not
     scaling;
 15. full-width agreement with the JAX package: the seeded random Mammo-CLIP `.tar`s
     of `tests/_fullwidth_agreement.py` (drawn weights; calibrated: the same with the
     image tower's BatchNorm statistics taken from data) and its mammo_png probe
     images rebuilt (their SHA-256 must equal the manifest's); for two references of
     128 images at 1520x912 (noise_drawn: `synthetic_u8` noise on the drawn weights;
     mammo_calibrated: mammogram-shaped PNGs through `csv:` on the calibrated
     weights) the port's dissect CLI (`cli.dissect.main`, resident, B5 x 39 blocks,
     batch 8, 12-layer BERT with the toy vocab, the canonical concept file,
     soft-WPMI) in fp32 with TF32 off and with the bf16 tower, every tensor of the
     `.tar` checked in the loaded module; each CSV compared with the JAX package's
     committed CSV (`tests/assets/fullwidth/`): mammo_calibrated in fp32 must reach
     >= 0.99 per-unit top-1 concept agreement, noise_drawn in fp32 (every score a
     near tie at 0) must keep its similarities within 1e-3 of JAX's, the other
     figures are printed; kernel 2 launched 32 times a batch and kernel 1 once in
     each run; then `cli.analyze` on mammo_calibrated's two CSVs (no figures), the
     neurons over the local and global thresholds and its host seconds.

Phase 2 also prints nvcc's -Xptxas=-v figures (registers, spills) of every kernel
and fails when any instantiation of any kernel spills. Prints the
card's name and power limit and a JSON line {"kernels": [...]} before the last
line; the last line is {"ok": true, "device": {...}}. Imports torch and the port
only."""
from __future__ import annotations

import ast
import contextlib
import copy
import dataclasses
import hashlib
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
TF32_TENSOR_FLOPS = 495e12
FP32_FLOPS = 67e12

MAIN_N = 1024          # probe images of the main path
MAIN_BATCH = 16
C_DISSECT_N = 512      # probe images of the C-dissect phase
WIRE_N = 256           # probe images of each run of the packed-wire phase
IMAGE_HW = (1520, 912)
POOL = 64              # unique synthetic mammograms, repeated cyclically
CONCEPTS = os.path.join(ROOT, "mammodissect", "assets", "concepts",
                        "Specific_concepts_sorted.txt")
# (k, H, W, Cin, Cexp, number of B5 blocks of this shape, the first version's ms,
# the previous fp32 design's ms) at 1520x912; the last two columns are times per
# launch at batch 16 on NVIDIA H100 80GB HBM3 at 700 W (PERF.md), printed beside this
# run's: the first CUDA version's in bf16, and the fp32 instantiation's before its
# strip-walk redesign (3xTF32 on mma.sync in 16 x 15 tiles; the mean of its two runs
# in the call that timed both designs, `tools/ab_phases.py`)
B5_SHAPES = [
    (3, 380, 228, 40, 240, 4, 6.163, 2.4702),     # blocks 4-7
    (5, 190, 114, 64, 384, 4, 2.999, 1.5157),     # 9-12
    (3, 95, 57, 128, 768, 6, 2.153, 0.9166),      # 14-19
    (5, 95, 57, 128, 768, 1, 2.474, 1.1534),      # 20
    (5, 95, 57, 176, 1056, 6, 4.818, 1.9516),     # 21-26
    (5, 48, 29, 304, 1824, 8, 3.217, 1.3330),     # 28-35
    (3, 48, 29, 304, 1824, 1, 2.840, 1.0796),     # 36
    (3, 48, 29, 512, 3072, 2, 7.223, 2.7948),     # 37-38
]
FIRST_VERSION_MS = {"wpmi": 0.923, "mbconv_forward": 124.0}  # same source and card
# one B5 forward's 32 fp32 launches at batch 16 before the strip-walk redesign (the
# same call)
FP32_MMA_SYNC_FORWARD_MS = 51.639
FT_BATCH = 8           # the fine-tune CLI's default batch
FT_TIMED_STEPS = 10
FT_POS_WEIGHT = 15.573306370070778  # VinDr Mass (cli.finetune.DEFAULT_BCE_WEIGHTS)
FT_TRAIN, FT_VALID = 32, 16         # synthetic PNGs of the end-to-end fine-tune
GD_N, GD_BATCH, GD_SIZE = 2048, 128, 224  # G-dissect: probe images, batch, side
CIFAR_TEST_N, CIFAR_TRAIN_N, CIFAR_CLASSES = 10000, 50000, 100  # CIFAR-100's splits
CIFAR_AGREE_N = 512    # stand-in CIFAR-100 images of the narrow card-vs-CPU run
ZS_RGB_N = 64          # RGB PNGs of the ViT zero-shot run


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
    """N-image probe over a small pool (image i is pool image i % len(pool)). `image`
    gives the float32 view the device normalizes the uint8 image to (min-max, then
    mean/std), each pool image normalized once."""

    def __init__(self, pool, n, mean=0.3089279, std=0.25053555):
        self.pool, self.n, self.mean, self.std = pool, n, mean, std
        self.image_shape = tuple(pool.shape[1:])
        self._float = {}

    def __len__(self):
        return self.n

    def image_u8(self, i):
        return self.pool[i % len(self.pool)]

    def image(self, i):
        j = i % len(self.pool)
        if j not in self._float:
            x = self.pool[j].astype(np.float32) / 255.0
            lo, hi = x.min(), x.max()
            x = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
            self._float[j] = ((x - self.mean) / self.std).astype(np.float32)
        return self._float[j]


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
KERNEL_LABELS = {"mbconv bf16 k3": "expand_dw_bf16_kernelILi3ELi2",
                 "mbconv bf16 k3, three blocks an SM": "expand_dw_bf16_kernelILi3ELi3",
                 "mbconv squeeze tiles": "squeeze_tiles_kernel",
                 "mbconv sigmoid (the bf16 SiLU table)": "sigmoid_bf16_kernel",
                 "mbconv bf16 k5": "expand_dw_bf16_kernelILi5ELi2",
                 "mbconv fp32 k3": "expand_dw_f32_kernelILi3",
                 "mbconv fp32 k5": "expand_dw_f32_kernelILi5",
                 "mbconv fp32 weight split": "split_weights_kernel",
                 "wpmi slab": "gather_logsum_slab_kernel",
                 "wpmi gather": "gather_logsum_kernel",
                 "bn epilogue": "bn_epilogue_kernel"}


def kernel_label(function):
    for label, key in KERNEL_LABELS.items():
        if key in function:
            return label
    return function


def phase_build():
    """Every kernel built from csrc/ with -Xptxas=-v; fails when any instantiation of
    any kernel spills registers."""
    from mammodissect_torch.ops import kernels

    t0 = time.perf_counter()
    report = kernels.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    say(f"[build] {sorted(report)} in {seconds:.2f} s (nvcc, sm_90a, in parallel)")
    seen, spills = set(), []
    for name in sorted(report):
        for row in ptxas_summary(report[name]["log"]):
            row["kernel"] = kernel_label(row.pop("function"))
            seen.add(row["kernel"])
            say(f"[ptxas] {row['kernel']}: {row.get('registers')} registers, "
                f"{row.get('static_smem')} bytes static smem, {row.get('stack_frame')} bytes "
                f"stack frame, {row.get('spill_stores')} bytes spill stores, "
                f"{row.get('spill_loads')} bytes spill loads")
            if row.get("spill_stores") != 0 or row.get("spill_loads") != 0:
                spills.append(row)
    check(not spills, f"kernels spill registers: {spills}")
    missing = set(KERNEL_LABELS) - seen
    check(not missing, f"no ptxas figures for {sorted(missing)}")
    return seconds


def wpmi_bound(u, c, k, n):
    """Kernel 1's bound: each input read once and the output written once at 3.35
    TB/s, or 4 fp32 operations a term (x - 1, multiply-add by p, + eps, multiply into
    the product) at 67 TFLOP/s, whichever is longer."""
    t_bytes = (n * c * 4 + u * k * 4 + k * 4 + u * c * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = u * k * c * 4 / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    row = {"shape": {"U": u, "C": c, "k": k, "N": n_images}, "max_abs_err": max(errs.values()),
           "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms, "gather_design_ms": large_ms,
           **wpmi_bound(u, c, k, n_images)}
    say(f"[kernel 1] U={u} C={c} k={k} N={n_images}: {ms:.4f} ms through the wrapper (first "
        f"version {FIRST_VERSION_MS['wpmi']} ms, same span), launch alone {launch_ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
        f"N={n_large} (gather design) {large_ms:.4f} ms through the wrapper")
    return row


def mbconv_bound(b, h, w, cin, cexp, k, dtype):
    """Kernel 2's bound (phases 5, 8 and 13): each input read once and the
    outputs written once (out and the squeeze, and the squeeze's tile partials
    written and read once) at 3.35 TB/s, or the operations, whichever is longer. The
    operations: bf16, the expand at 989 TFLOP/s on the tensor cores beside the
    depthwise at 67 TFLOP/s fp32; fp32, the expand as 3xTF32 (three tf32 products)
    at 495/3 TFLOP/s on the tensor cores beside the depthwise at 67 TFLOP/s. fp32
    also gets `fma_bound_ms`, both on the fp32 FMAs at 67 TFLOP/s (the bound of the
    CUDA-core design before the 3xTF32 one, kept so that earlier ratios still read).
    `fma_bound_ms` goes to the printed lines only, not into the kernels line."""
    import torch

    from mammodissect_torch.ops import kernels

    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    pix = b * h * w
    # the kernel's tiles of an image: its strips x segments
    tiles = kernels.load("mbconv_expand_dw").mbconv_expand_dw_tiles(int(bf16), h, w)
    partials = b * tiles * -(-cexp // 48) * 48  # a squeeze partial a tile and channel
    t_bytes = (pix * (cin + cexp) * size + (cin * cexp + k * k * cexp) * size
               + 6 * cexp * 4 + b * cexp * 4 + 2 * partials * 4) / HBM_BYTES_PER_S * 1e3
    expand, dw = 2 * pix * cin * cexp, 2 * k * k * pix * cexp
    t_ops = (max(expand / BF16_TENSOR_FLOPS, dw / FP32_FLOPS) if bf16
             else max(3 * expand / TF32_TENSOR_FLOPS, dw / FP32_FLOPS)) * 1e3
    row = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if not bf16:
        row["fma_bound_ms"] = max(t_bytes, (expand + dw) / FP32_FLOPS * 1e3)
    return row


# BatchNorm outputs that fall on the bf16 SiLU table's edges (`bf16_wide`): 2^-8 and
# the largest bf16 below it (the table's first magnitude), 5.5625 (r = 1 from here
# up), -87.5 (r flushed to 0 from here down), 128 (its last) and the bf16s beside it,
# zero, each with both signs
TABLE_EDGES = [2.0 ** -8, 2.0 ** -8 - 2.0 ** -16, 5.5625, 5.5, 87.5, 87.0, 128.0, 127.5, 129.0,
               0.0]


def _mbconv_args(b, h, w, cin, cexp, k, dtype, device, seed, expand_dominant=False,
                 wide=False):
    """Random inputs of kernel 2. bf16 uses the scales of tests/test_pallas_mbconv.py
    (x 0.1, weights 0.05), where its 2e-3/2e-2 tolerance was set: at unit scale a
    one-ulp difference in the bf16-rounded expanded tensor (the two versions sum the
    expand in another order before rounding) exceeds it. fp32 runs at unit scale.

    expand_dominant (bf16): x and the expand at unit scale, depthwise weights ~1/K^2
    and no BN2 bias, so each output is about the mean of its window's expanded values
    and any fault of the expand (a dropped channel chunk, a wrong tail tile) moves it
    far: the kernel's bf16 output must equal the plain version's bit for bit.

    wide (bf16): both BatchNorms' mul drawn as +-2^u, u uniform in [-10, 8], so their
    outputs run from below 2^-8 to past 128 in magnitude, both signs: every branch of
    the SiLU table; the first channels take mul 0 and a bias on the table's edges
    (`TABLE_EDGES`, both signs), which the BatchNorm then gives exactly."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    bf16 = dtype == torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    def pos(n):
        return (torch.rand((n,), generator=g) + 0.5).to(device)

    # (x, w_exp, BN1 mean, mul, bias, w_dw, BN2 mean, mul, bias); the means are drawn
    # last, so the other draws are those of the folded interface's inputs
    if wide:
        def wide_mul(n):
            sign = torch.where(torch.rand((n,), generator=g) < 0.5, -1.0, 1.0)
            return sign * 2.0 ** (torch.rand((n,), generator=g) * 18 - 10)

        edges = torch.tensor(TABLE_EDGES + [-e for e in TABLE_EDGES])
        terms = []
        for _ in range(2):
            mul, bias = wide_mul(cexp), torch.randn((cexp,), generator=g) * 0.1
            mul[:len(edges)], bias[:len(edges)] = 0.0, edges
            terms.append((mul.to(device), bias.to(device)))
        x, w_exp = rnd(b, h, w, cin).to(dtype), rnd(cin, cexp, scale=cin ** -0.5).to(dtype)
        w_dw = ((1.0 + rnd(k, k, cexp, scale=0.1)) / (k * k)).to(dtype)
        (mul1, bias1), (mul2, bias2) = terms
        return x, w_exp, rnd(cexp, scale=0.1), mul1, bias1, w_dw, rnd(cexp, scale=0.1), mul2, bias2
    if expand_dominant:
        x, w_exp = rnd(b, h, w, cin).to(dtype), rnd(cin, cexp, scale=cin ** -0.5).to(dtype)
        mul1, bias1 = pos(cexp), rnd(cexp, scale=0.1)
        w_dw = ((1.0 + rnd(k, k, cexp, scale=0.1)) / (k * k)).to(dtype)
        mul2, zeros = pos(cexp), torch.zeros(cexp, device=device)
        return x, w_exp, rnd(cexp, scale=0.1), mul1, bias1, w_dw, zeros, mul2, zeros
    x = rnd(b, h, w, cin, scale=0.1 if bf16 else 1.0).to(dtype)
    w_exp = rnd(cin, cexp, scale=0.05 if bf16 else cin ** -0.5).to(dtype)
    mul1, bias1 = pos(cexp), rnd(cexp, scale=0.1)
    w_dw = rnd(k, k, cexp, scale=0.05 if bf16 else 0.2).to(dtype)
    mul2, bias2 = pos(cexp), rnd(cexp, scale=0.1)
    return x, w_exp, rnd(cexp, scale=0.1), mul1, bias1, w_dw, rnd(cexp, scale=0.1), mul2, bias2


# kernel 2's squeeze against its plain version's: the bf16 values agree bit for bit,
# so only the float32 sums' order differs (a fraction of the sum of |values|); in fp32
# the elementwise tolerance (atol, rtol) summed over H x W
SQUEEZE_BF16_RTOL = 1e-5


def squeeze_err(got, want, out, atol, rtol):
    """The largest |squeeze - plain squeeze| over its bound atol H W + rtol sum |out|
    (out: the plain version's [B, H, W, Cexp]): at most 1 to pass."""
    import torch

    bound = atol * out.shape[1] * out.shape[2] + rtol * out.float().abs().sum(dim=(1, 2))
    err = (got - want).abs()
    # a channel whose every value is 0 (bf16_wide's edge at 0) has a bound of 0: there
    # the error must be 0 too
    return float(torch.where(bound > 0, err / bound, torch.where(err > 0, float("inf"), 0.0)).max())


def silu_table_check(device):
    """Kernel 2's bf16 SiLU table and its builder `sigmoid_bf16_kernel` held bit for bit
    to their plain version on the card, the op chain (`ops.activations._sigmoid_chain`)
    that phase 5's plain version computes: the table against the chain over its 3844
    inputs, and over all 65536 bf16 values the card's sigmoid and the table entry the
    kernel reads in its place (`silu_table_index`: the magnitude clamped to the table's
    range, whose ends hold the constants) against the chain; Inf and NaN take the chain
    in the kernel. Also prints the entries that differ from the table built on the CPU
    (`ops.cuda_mbconv.silu_table`; 0 expected, not gated)."""
    import torch

    from mammodissect_torch.ops.activations import _sigmoid_chain
    from mammodissect_torch.ops.cuda_mbconv import (
        sigmoid_bf16, silu_table, silu_table_index, silu_table_inputs)

    def bits(t):
        return t.view(torch.int16).cpu()

    table = silu_table(device)
    plain = _sigmoid_chain(silu_table_inputs(device))
    codes = torch.arange(65536, dtype=torch.int32)
    a = torch.where(codes >= 0x8000, codes - 0x10000, codes).to(torch.int16).view(torch.bfloat16)
    finite = (codes & 0x7FFF) < 0x7F80
    chain = bits(_sigmoid_chain(a.to(device)))
    card_sigmoid = bits(sigmoid_bf16(a.to(device)))
    row = {"table_entries_differing": int((bits(table) != bits(plain)).sum()),
           "sigmoid_values_differing": int((card_sigmoid != chain)[finite].sum()),
           "table_reads_differing": int((bits(table)[silu_table_index(a)] != chain)[finite].sum()),
           "cpu_table_entries_differing": int((bits(table) != bits(silu_table("cpu"))).sum())}
    say(f"[kernel 2] SiLU table against the op chain on the card: "
        f"{row['table_entries_differing']} of {table.numel()} entries differ; the card's "
        f"sigmoid differs at {row['sigmoid_values_differing']} of {int(finite.sum())} finite "
        f"bf16 values, the table entry the kernel reads at {row['table_reads_differing']}; "
        f"{row['cpu_table_entries_differing']} entries differ from the table built on the CPU")
    check(row["table_entries_differing"] == row["sigmoid_values_differing"]
          == row["table_reads_differing"] == 0,
          f"the SiLU table or its sigmoid kernel disagrees with the op chain on the card: {row}")
    return row


def fp32_precision_check(device):
    """Phase 5's float32 gate: kernel 2's fp32 instantiation at the expand-dominant
    inputs of `tests/_mbconv_f64.py` (batch 2) against the same function in float64
    on the CPU, within F64_TOL (1e-5 + 1e-5 |x|), at every PRECISION_SHAPES entry: B5's
    and V2-S's deep blocks, odd widths, several strips and segments with a ragged
    last strip."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _mbconv_f64 as f64
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw

    errs = {}
    for k, h, w, cin, cexp in f64.PRECISION_SHAPES:
        args = f64.expand_dominant_args(2, h, w, cin, cexp, k, torch.float32, device)
        got = fused_expand_dw(*args)[0].double().cpu()
        errs[f"k{k} {cin}->{cexp} @ {h}x{w}"] = f64.relative_err(
            got, f64.expand_dw_f64(*(a.cpu() for a in args)))
    worst = max(errs.values())
    say(f"[kernel 2 fp32] against float64, max |err| / (1 + |x|) at each precision shape: "
        f"{ {name: float(f'{e:.3g}') for name, e in errs.items()} }; tolerance {f64.F64_TOL}")
    check(worst <= f64.F64_TOL, f"kernel 2 fp32 is {worst:.3g} (1 + |x|) off float64, past "
          f"{f64.F64_TOL}: {errs}")
    return {"max_rel_err": worst, "shapes": len(errs), "tol": f64.F64_TOL}


def phase_mbconv(device):
    import torch

    from mammodissect_torch.ops.cuda_mbconv import expand_dw_plain, fused_expand_dw

    rows = []
    for i, (k, h, w, cin, cexp, n_blocks, first_ms, _) in enumerate(B5_SHAPES):
        row = {"k": k, "H": h, "W": w, "Cin": cin, "Cexp": cexp, "blocks": n_blocks}
        for name, dtype, b, (atol, rtol) in (
                ("bf16", torch.bfloat16, MAIN_BATCH, (0.0, 0.0)),
                ("bf16_unit", torch.bfloat16, 2, (0.0, 0.0)),
                ("bf16_wide", torch.bfloat16, 2, (0.0, 0.0)),
                ("fp32", torch.float32, 2, (1e-4, 1e-4))):
            args = _mbconv_args(b, h, w, cin, cexp, k, dtype, device, seed=10 + i,
                                expand_dominant=name == "bf16_unit", wide=name == "bf16_wide")
            got, squeeze = fused_expand_dw(*args)
            want, want_squeeze = expand_dw_plain(*args)
            again, squeeze_again = fused_expand_dw(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again) and torch.equal(squeeze, squeeze_again),
                  f"kernel 2 ({name}, {row}): two launches differ")
            del again, squeeze_again
            err = (got.float() - want.float()).abs()
            check(bool((err <= atol + rtol * want.float().abs()).all()),
                  f"kernel 2 disagrees ({name}, {row}): max abs err {float(err.max())}")
            sq_tol = (0.0, SQUEEZE_BF16_RTOL) if dtype == torch.bfloat16 else (atol, rtol)
            sq = squeeze_err(squeeze, want_squeeze, want, *sq_tol)
            check(sq <= 1.0, f"kernel 2's squeeze disagrees ({name}, {row}): {sq:.3g} of "
                  f"its bound (atol, rtol) {sq_tol}")
            edge = torch.cat([err[:, :2].flatten(), err[:, -2:].flatten(),
                              err[:, :, :2].flatten(), err[:, :, -2:].flatten()])
            row[f"max_abs_err_{name}"] = float(err.max())
            row[f"border_max_abs_err_{name}"] = float(edge.max())
            row[f"squeeze_err_{name}"] = sq
            row[f"squeeze_max_abs_err_{name}"] = float((squeeze - want_squeeze).abs().max())
            if name == "bf16":
                row["ms"] = cuda_ms(lambda: fused_expand_dw(*args), reps=5)
                row["plain_ms"] = cuda_ms(lambda: expand_dw_plain(*args), reps=2)
                row.update(mbconv_bound(b, h, w, cin, cexp, k, dtype))
            del args, got, want, err, squeeze, want_squeeze
        rows.append(row)
        say(f"[kernel 2] k{k} {cin}->{cexp} @ {h}x{w} B={MAIN_BATCH} bf16: "
            f"max abs err {row['max_abs_err_bf16']:.3g} (border {row['border_max_abs_err_bf16']:.3g}); "
            f"bf16 unit scale B=2: {row['max_abs_err_bf16_unit']:.3g} "
            f"(border {row['border_max_abs_err_bf16_unit']:.3g}); "
            f"fp32 B=2: {row['max_abs_err_fp32']:.3g}; squeeze (share of its bound, max abs "
            f"err) bf16 {row['squeeze_err_bf16']:.3g}, {row['squeeze_max_abs_err_bf16']:.3g}, "
            f"unit {row['squeeze_err_bf16_unit']:.3g}, {row['squeeze_max_abs_err_bf16_unit']:.3g}, "
            f"wide {row['squeeze_err_bf16_wide']:.3g}, {row['squeeze_max_abs_err_bf16_wide']:.3g} "
            f"(bf16 wide B=2 max abs err {row['max_abs_err_bf16_wide']:.3g}), "
            f"fp32 {row['squeeze_err_fp32']:.3g}, {row['squeeze_max_abs_err_fp32']:.3g}; two "
            f"launches identical; {row['ms']:.4f} ms (first version "
            f"{first_ms:.3f} ms), plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    torch.cuda.empty_cache()
    return rows


def b5_epilogue_sites(device):
    """Kernel 3's sites in one bf16 inference forward of B5 at 1520x912 (the main
    path's tower, all 39 blocks captured), recorded at batch 1 from the calls the
    tower makes: {(C, H, W, act, squeeze): sites of that shape}."""
    import torch

    from mammodissect_torch.models import efficientnet
    from mammodissect_torch.models.efficientnet import EfficientNetMammo

    sites = {}
    real = efficientnet.bn_epilogue

    def record(v, mean, mul, bias, act=None, squeeze=False):
        key = (*v.shape[1:], act, squeeze)
        sites[key] = sites.get(key, 0) + 1
        return real(v, mean, mul, bias, act=act, squeeze=squeeze)

    torch.manual_seed(0)
    tower = EfficientNetMammo("efficientnet-b5", in_channels=3, dtype=torch.bfloat16)
    tower = tower.to(device).eval()
    efficientnet.bn_epilogue = record
    try:
        with torch.no_grad():
            tower(torch.zeros(1, *IMAGE_HW, 1, device=device), capture=range(39))
    finally:
        efficientnet.bn_epilogue = real
    return sites


def epilogue_bytes(b, c, h, w, act, squeeze):
    """Bytes of one `bn_epilogue` call: the float32 sums read and the BatchNorm's three
    [C] terms; the bf16 output and, for "silu_f32" or a squeeze, the float32 product
    written; with a squeeze, ATen's sum of that product (read, and [B, C] written)."""
    n = b * c * h * w
    out = (0 if act == "silu_f32" else 2) + (4 if act == "silu_f32" or squeeze else 0)
    return n * (4 + out) + 3 * c * 4 + (n * 4 + b * c * 4 if squeeze else 0)


def phase_bn_epilogue(device):
    """Kernel 3 against its plain version (the ATen chain) at each of the 52 sites of a
    B5 bf16 forward at the main path's batch: random float32 sums (magnitudes from
    e^-4 to e^4) and BatchNorm terms, the output and the squeeze bit for bit, two
    launches bit-identical; each site timed through the wrapper (the squeeze's ATen
    sum included), its plain version and its bound (bytes at 3.35 TB/s)."""
    import torch

    from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue, bn_epilogue_plain

    sites = b5_epilogue_sites(device)
    n_sites = sum(sites.values())
    n_squeeze = sum(n for key, n in sites.items() if key[4])
    check((n_sites, n_squeeze) == (52, 7),
          f"kernel 3: a B5 forward has {n_sites} sites, {n_squeeze} with a squeeze, not 52 and 7")
    gen = torch.Generator(device=device).manual_seed(20)
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)  # noqa: E731
    rows = []
    by_size = sorted(sites.items(), key=lambda kv: -kv[0][0] * kv[0][1] * kv[0][2])
    for (c, h, w, act, squeeze), count in by_size:
        b = MAIN_BATCH
        v = torch.randn(b, h, w, c, device=device, generator=gen)
        v.mul_(torch.empty(b, h, w, c, device=device).uniform_(-4, 4, generator=gen).exp_())
        v = v.permute(0, 3, 1, 2)  # [B, C, H, W] in channels_last memory
        mean = torch.randn(c, device=device, generator=gen)
        mul = torch.rand(c, device=device, generator=gen) * 2 + 0.05
        bias = torch.randn(c, device=device, generator=gen)
        args = (v, mean, mul, bias)
        with torch.no_grad():
            got, sq = bn_epilogue(*args, act=act, squeeze=squeeze)
            again, sq_again = bn_epilogue(*args, act=act, squeeze=squeeze)
            want, want_sq = bn_epilogue_plain(*args, act=act, squeeze=squeeze)
            torch.cuda.synchronize()
            row = {"C": c, "H": h, "W": w, "act": act, "squeeze": squeeze, "sites": count}
            check(torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again)),
                  f"kernel 3 ({row}): its output differs from the ATen chain's or between launches")
            check(not squeeze or (torch.equal(bits(sq), bits(want_sq))
                                  and torch.equal(bits(sq), bits(sq_again))),
                  f"kernel 3 ({row}): its squeeze differs from the ATen chain's or between "
                  "launches")
            del got, sq, again, sq_again, want, want_sq
            row["ms"] = cuda_ms(lambda: bn_epilogue(*args, act=act, squeeze=squeeze), reps=5)
            row["plain_ms"] = cuda_ms(lambda: bn_epilogue_plain(*args, act=act, squeeze=squeeze),
                                      reps=2)
        row["bound_ms"] = epilogue_bytes(b, c, h, w, act, squeeze) / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        say(f"[kernel 3] C={c} @ {h}x{w} B={b} act={act} squeeze={squeeze} x{count}: bit for "
            f"bit, two launches identical; {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
            f"bound {row['bound_ms']:.4f} ms")
        del v, mean, mul, bias, args
    torch.cuda.empty_cache()
    forward = {key: sum(r[key] * r["sites"] for r in rows)
               for key in ("ms", "plain_ms", "bound_ms")}
    say(f"[kernel 3] one forward's 52 launches (7 with a squeeze) at batch {MAIN_BATCH}: "
        f"{forward['ms']:.3f} ms through the wrapper (the squeezes' ATen sums included), "
        f"plain {forward['plain_ms']:.3f} ms, bound {forward['bound_ms']:.3f} ms "
        f"({100 * forward['bound_ms'] / forward['ms']:.1f}% of the bound)")
    return {"rows": rows, **forward}


def flagship_dissector(device):
    """The bf16 BreastClip dissector at full width (12-layer BERT), seed 0, and the
    seconds its build took."""
    from mammodissect_torch.dissect.dissectors import get_dissector

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy WordPiece vocab (no vocab.txt in the repo)
        dissector = get_dissector("breastclip", device=device, dtype="bfloat16",
                                  bert_layers=12, seed=0)
    return dissector, time.perf_counter() - t0


def resident_cfg(work, device, **kw):
    """The flagship resident M-dissect configuration (B5, 39 blocks, 762 concepts,
    soft-WPMI) on `device`; the plain uint8 wire unless `kw` says otherwise."""
    from mammodissect_torch.dissect.engine import DissectConfig

    args = dict(target_model="breastclip", clip_model="breastclip",
                target_layers=[f"blocks.{i}" for i in range(39)], d_probe="synthetic_mammo",
                concept_set=CONCEPTS, batch_size=MAIN_BATCH, similarity_fn="soft_wpmi",
                resident=True, device=device.type, wire_pack="off",
                activation_dir=os.path.join(work, "acts"),
                result_dir=os.path.join(work, "results"))
    args.update(kw)
    return DissectConfig(**args)


def phase_main_path(device, pool, dissector):
    import torch

    from mammodissect_torch.dissect.engine import run_dissection
    from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum

    probe = CyclicProbe(pool, MAIN_N)
    cfg = resident_cfg(tempfile.mkdtemp(prefix="chip_smoke_"), device)
    torch.cuda.reset_peak_memory_stats()
    fused_expand_dw.launches = 0
    fused_expand_dw.reduce_launches = 0
    soft_wpmi_gather_logsum.launches = 0
    bn_epilogue.launches = 0
    bn_epilogue.squeeze_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df, csv_path = run_dissection(cfg, probe=probe, dissector=dissector, log=lambda *_: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mbconv": fused_expand_dw.launches, "wpmi": soft_wpmi_gather_logsum.launches,
                "mbconv_squeeze_reduce": fused_expand_dw.reduce_launches,
                "bn_epilogue": bn_epilogue.launches,
                "bn_epilogue_squeeze": bn_epilogue.squeeze_launches}
    n_batches = -(-MAIN_N // MAIN_BATCH)
    sims = np.array([json.loads(s) if isinstance(s, str) else s for s in df["similarity"]])
    check(len(df) == 6992, f"CSV has {len(df)} rows, expected 6992")
    check(np.isfinite(sims).all(), "non-finite similarities in the CSV")
    check(launches["mbconv"] == 32 * n_batches,
          f"MBConv kernel launched {launches['mbconv']} times, expected {32 * n_batches}")
    check(launches["wpmi"] >= 1, "soft-WPMI kernel never launched on the main path")
    check(launches["mbconv_squeeze_reduce"] == launches["mbconv"],
          f"kernel 2's squeeze reduction launched {launches['mbconv_squeeze_reduce']} times, "
          f"its kernel {launches['mbconv']}")
    check((launches["bn_epilogue"], launches["bn_epilogue_squeeze"]) == (52 * n_batches,
                                                                         7 * n_batches),
          f"kernel 3 launched {launches['bn_epilogue']} times, {launches['bn_epilogue_squeeze']} "
          f"with a squeeze, expected {52 * n_batches} and {7 * n_batches}")
    row = {"images": MAIN_N, "batch": MAIN_BATCH, "batches": n_batches, "wall_s": wall,
           "img_per_s": MAIN_N / wall, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "rows": len(df)}
    say(f"[main path] {MAIN_N} images at {IMAGE_HW[0]}x{IMAGE_HW[1]}, B5 x 39 blocks, 12-layer "
        f"BERT, 762 concepts, soft-WPMI, bf16, plain wire: {wall:.2f} s wall, "
        f"{row['img_per_s']:.2f} img/s, "
        f"peak {row['max_memory_allocated_bytes'] / 2**30:.2f} GiB; launches {launches}; "
        f"{len(df)} CSV rows, similarities finite")
    return row


def csv_similarities(df):
    return np.array([json.loads(s) if isinstance(s, str) else s for s in df["similarity"]])


def fma_forward_ms(rows):
    """One forward's fp32-FMA bound (`mbconv_bound`) over kernel 2's rows, for the
    printed lines."""
    import torch

    return sum(mbconv_bound(MAIN_BATCH, r["H"], r["W"], r["Cin"], r["Cexp"], r["k"],
                            torch.float32)["fma_bound_ms"] * r["blocks"] for r in rows)


def fp32_mbconv_rows(device):
    """Kernel 2's fp32 instantiation (the classifier target's) at each B5 shape at
    batch 16: ms, plain ms, max abs err and the 3xTF32 bound; the printed line adds
    the previous fp32 design's ms and the fp32-FMA bound."""
    import torch

    from mammodissect_torch.ops.cuda_mbconv import expand_dw_plain, fused_expand_dw

    rows = []
    for i, (k, h, w, cin, cexp, n_blocks, _, before_ms) in enumerate(B5_SHAPES):
        args = _mbconv_args(MAIN_BATCH, h, w, cin, cexp, k, torch.float32, device, seed=30 + i)
        got, _ = fused_expand_dw(*args)
        want, _ = expand_dw_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool((err <= 1e-4 + 1e-4 * want.abs()).all()),
              f"kernel 2 fp32 disagrees at batch {MAIN_BATCH}, k{k} {cin}->{cexp}: "
              f"max abs err {float(err.max())}")
        row = {"k": k, "H": h, "W": w, "Cin": cin, "Cexp": cexp, "blocks": n_blocks,
               "max_abs_err": float(err.max())}
        del got, want, err
        row["ms"] = cuda_ms(lambda: fused_expand_dw(*args), reps=3)
        row["plain_ms"] = cuda_ms(lambda: expand_dw_plain(*args), reps=1)
        bound = mbconv_bound(MAIN_BATCH, h, w, cin, cexp, k, torch.float32)
        fma_ms = bound.pop("fma_bound_ms")
        row.update(bound)
        rows.append(row)
        say(f"[kernel 2 fp32] k{k} {cin}->{cexp} @ {h}x{w} B={MAIN_BATCH}: {row['ms']:.4f} ms "
            f"(mma.sync design {before_ms:.4f} ms), plain {row['plain_ms']:.3f} ms"
            f"{slower_than_plain(row)}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"fp32 FMAs {fma_ms:.4f} ms), max abs err {row['max_abs_err']:.3g}")
        del args
    torch.cuda.empty_cache()
    return rows


def slower_than_plain(row):
    return " (slower than plain)" if row["ms"] > row["plain_ms"] else ""


def phase_c_dissect(device, pool, dissector):
    import torch

    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
    from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum

    probe = CyclicProbe(pool, C_DISSECT_N)
    work = tempfile.mkdtemp(prefix="chip_smoke_c_")
    cfg = DissectConfig(target_model="breastclip_classifier", clip_model="breastclip",
                        target_layers=[f"blocks.{i}" for i in range(39)],
                        d_probe="synthetic_mammo", concept_set=CONCEPTS, batch_size=MAIN_BATCH,
                        similarity_fn="soft_wpmi", resident=False, device=device.type,
                        target_kwargs={"seed": 2}, activation_dir=os.path.join(work, "acts"),
                        result_dir=os.path.join(work, "results"))
    n_batches = -(-C_DISSECT_N // MAIN_BATCH)
    runs = []
    for attempt in ("first", "rerun"):
        torch.cuda.reset_peak_memory_stats()
        fused_expand_dw.launches = 0
        fused_expand_dw.weight_launches = 0
        soft_wpmi_gather_logsum.launches = 0
        bn_epilogue.launches = 0
        bn_epilogue.squeeze_launches = 0
        logs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df, _ = run_dissection(cfg, probe=probe, dissector=dissector, log=logs.append)
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t0, "logs": logs, "df": df,
                     "launches": {"mbconv": fused_expand_dw.launches,
                                  "mbconv_weight_split": fused_expand_dw.weight_launches,
                                  "wpmi": soft_wpmi_gather_logsum.launches,
                                  "bn_epilogue": bn_epilogue.launches,
                                  "bn_epilogue_squeeze": bn_epilogue.squeeze_launches},
                     "peak": torch.cuda.max_memory_allocated()})
    first, rerun = runs
    sims = csv_similarities(first["df"])
    check(len(first["df"]) == 6992, f"C-dissect CSV has {len(first['df'])} rows, expected 6992")
    check(np.isfinite(sims).all(), "non-finite similarities in the C-dissect CSV")
    check(first["launches"]["mbconv"] == 2 * 32 * n_batches,
          f"C-dissect: kernel 2 launched {first['launches']['mbconv']} times, expected "
          f"{2 * 32 * n_batches} (fp32 target harvest + bf16 dissector embed)")
    check(first["launches"]["mbconv_weight_split"] == 32 * n_batches,
          f"C-dissect: kernel 2's fp32 weight split launched "
          f"{first['launches']['mbconv_weight_split']} times, expected {32 * n_batches} "
          f"(once a launch of the fp32 target harvest)")
    check(first["launches"]["wpmi"] >= 1, "C-dissect: kernel 1 never launched")
    check((first["launches"]["bn_epilogue"], first["launches"]["bn_epilogue_squeeze"])
          == (52 * n_batches, 7 * n_batches),
          f"C-dissect: kernel 3 launched {first['launches']['bn_epilogue']} times, "
          f"{first['launches']['bn_epilogue_squeeze']} with a squeeze, expected "
          f"{52 * n_batches} and {7 * n_batches} (the bf16 dissector embed; 0 in the fp32 "
          f"target harvest)")
    check(any(l.startswith(f"[harvest] {C_DISSECT_N} images x 39 layers") for l in first["logs"]),
          f"C-dissect did not harvest the target: {first['logs']}")
    for line in ("[harvest] all target activations cached, skipping",
                 "[clip-img] probe embeddings cached, skipping"):
        check(line in rerun["logs"], f"C-dissect rerun did not log {line!r}: {rerun['logs']}")
    check(rerun["launches"]["mbconv"] == 0 and rerun["launches"]["bn_epilogue"] == 0,
          f"C-dissect rerun launched kernels 2 and 3: {rerun['launches']}")
    check(list(rerun["df"]["description"]) == list(first["df"]["description"])
          and list(rerun["df"]["images"]) == list(first["df"]["images"])
          and np.allclose(csv_similarities(rerun["df"]), sims, rtol=1e-6, atol=1e-6),
          "C-dissect rerun wrote another CSV")
    fp32 = fp32_mbconv_rows(device)
    per_forward = {key: sum(r[key] * r["blocks"] for r in fp32)
                   for key in ("ms", "plain_ms", "bound_ms")}
    row = {"images": C_DISSECT_N, "batch": MAIN_BATCH, "batches": n_batches,
           "wall_s": first["wall_s"], "img_per_s": C_DISSECT_N / first["wall_s"],
           "rerun_wall_s": rerun["wall_s"], "max_memory_allocated_bytes": first["peak"],
           "launches": first["launches"], "rerun_launches": rerun["launches"],
           "fp32_shapes": fp32, "fp32_forward_ms": per_forward["ms"],
           "fp32_forward_plain_ms": per_forward["plain_ms"],
           "fp32_forward_bound_ms": per_forward["bound_ms"],
           "fp32_max_abs_err": max(r["max_abs_err"] for r in fp32),
           "stage_logs": [l for l in first["logs"] if l.startswith(("[harvest]", "[clip-"))],
           "work": work}
    say(f"[c-dissect] {C_DISSECT_N} images at {IMAGE_HW[0]}x{IMAGE_HW[1]}, classifier B5 fp32 x "
        f"39 blocks + BreastClip bf16 embed, 762 concepts, soft-WPMI, staged: "
        f"{row['wall_s']:.2f} s wall, {row['img_per_s']:.2f} img/s, peak "
        f"{row['max_memory_allocated_bytes'] / 2**30:.2f} GiB; launches {row['launches']}; "
        f"6992 CSV rows, similarities finite; stages {row['stage_logs']}")
    say(f"[c-dissect] rerun: every cache file found, both harvests skipped, "
        f"{rerun['wall_s']:.2f} s, launches {rerun['launches']}")
    say(f"[kernel 2 fp32] one forward's 32 launches at batch {MAIN_BATCH}: "
        f"{per_forward['ms']:.3f} ms against {FP32_MMA_SYNC_FORWARD_MS} ms before the strip-walk "
        f"redesign, plain {per_forward['plain_ms']:.3f} ms, bound "
        f"{per_forward['bound_ms']:.3f} ms (3xTF32; fp32 FMAs {fma_forward_ms(fp32):.3f} ms)")
    return row


def phase_packed_wire(device, pool, dissector):
    import torch

    from mammodissect_torch.dissect.engine import _decide_wire_pack, run_dissection
    from mammodissect_torch.dissect.packing import (
        native_packer,
        pack_batch_groups_padded,
        sample_pack_fraction,
        unpack_canvas_groups,
    )

    # 1. one batch through the native packer and the card's unpack
    u8 = np.ascontiguousarray(pool[:MAIN_BATCH])
    check(native_packer() == "native", "the native span packer did not build")
    raw = u8.size
    t0 = time.perf_counter()
    flat2d, meta, bucket = pack_batch_groups_padded(u8, 1, quantum=raw // 16, cap=raw)
    pack_ms = (time.perf_counter() - t0) * 1e3
    flat_dev, meta_dev = torch.from_numpy(flat2d).to(device), torch.from_numpy(meta).to(device)
    canvas = unpack_canvas_groups(flat_dev, meta_dev, u8.shape)
    check(bool(torch.equal(canvas.cpu(), torch.from_numpy(u8))),
          "the canvas unpacked on the card differs from the batch")
    unpack_ms = cuda_ms(lambda: unpack_canvas_groups(flat_dev, meta_dev, u8.shape), reps=10)
    del canvas
    say(f"[wire] one batch of {MAIN_BATCH}: native packer, {raw} raw -> {bucket + meta.nbytes} "
        f"wire bytes ({(bucket + meta.nbytes) / raw:.4f}), packed in {pack_ms:.2f} ms on the host, "
        f"unpacked bit-identical on the card in {unpack_ms:.3f} ms")

    # 2. the resident main path, plain and packed wire in turns
    probe = CyclicProbe(pool, WIRE_N)
    runs = []
    for wire in ("off", "on", "on", "off"):
        cfg = resident_cfg(tempfile.mkdtemp(prefix=f"chip_smoke_wire_{wire}_"), device,
                           wire_pack=wire)
        timing, logs = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df, _ = run_dissection(cfg, probe=probe, dissector=dissector, log=logs.append,
                               timing=timing)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        packer = [l for l in logs if "packed uint8 wire" in l]
        check(packer == (["[resident] packed uint8 wire (native packer)"] if wire == "on" else []),
              f"wire {wire}: unexpected packer log {packer}")
        runs.append({"wire": wire, "df": df, "wall_s": wall, "img_per_s": WIRE_N / wall,
                     "wire_bytes_per_batch": float(np.mean([t["wire_bytes"] for t in timing])),
                     "pack_ms_per_batch": float(np.mean([t["pack_s"] for t in timing])) * 1e3,
                     "put_ms_per_batch": float(np.mean([t["put_s"] for t in timing])) * 1e3})
    plain, packed = runs[0]["df"], runs[1]["df"]
    top = [[row[0] for row in d["description"]] for d in (plain, packed)]
    agree = float(np.mean([a == b for a, b in zip(*top)]))
    exact = float(np.mean([a == b for a, b in zip(plain.itertuples(index=False),
                                                   packed.itertuples(index=False))]))
    check(list(plain["images"]) == list(packed["images"]),
          "packed and plain wire wrote other top images")
    check(agree >= 0.99, f"packed vs plain wire: top-1 agreement {agree} < 0.99")
    fraction = sample_pack_fraction(probe)
    auto = _decide_wire_pack("auto", probe)
    for r in runs:
        say(f"[wire] {r['wire']:>3}: {r['img_per_s']:.2f} img/s ({WIRE_N} images), "
            f"{r['wire_bytes_per_batch']:.0f} wire bytes a batch, host packing "
            f"{r['pack_ms_per_batch']:.2f} ms a batch, enqueue of the copy "
            f"{r['put_ms_per_batch']:.3f} ms a batch")
    say(f"[wire] packed vs plain: identical top images, top-1 agreement {agree:.4f}, rows "
        f"identical {exact:.4f}; sampled packed fraction {fraction:.4f}, 'auto' packs: {auto}")
    return {"pack_ms": pack_ms, "unpack_ms": unpack_ms, "bucket": bucket,
            "runs": [{k: v for k, v in r.items() if k != "df"} for r in runs],
            "top1_agreement": agree, "rows_identical": exact,
            "sampled_fraction": fraction, "auto_packs": auto}


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
    bf16 = bf16_tower_card_vs_cpu(cpu.module, probe)
    return {"top1_agreement": agree, "top_images_identical": images, "bf16_tower": bf16}


AGREE_BF16_EARLY = 4      # blocks 0-3: before the first of kernel 2's blocks
AGREE_BF16_EARLY_GAP = 1e-4


def bf16_tower_card_vs_cpu(module, probe):
    """The bf16 resident step card vs CPU: the same module cast to bf16 on both, one
    batch of 8 at 160x96, every block captured. The CPU computes the JAX package's
    bf16 program (`tests/test_torch_bf16.py`); the card runs kernel 2 and cuDNN's
    float32 sums, another order of the same sums, which bf16 rounding amplifies with
    depth (JAX's own CPU program moves as far under a one-ulp change of its
    parameters). Blocks 0-3 precede kernel 2 and must agree within
    AGREE_BF16_EARLY_GAP (mean relative); every block and the embedding are printed."""
    import torch

    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.models.breastclip import BreastClip

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bf16 = get_dissector("breastclip", device="cpu", bert_layers=2, seed=1,
                             dtype="bfloat16").module
    bf16.load_state_dict(module.state_dict())
    sides = {}
    u8 = torch.from_numpy(np.ascontiguousarray(probe.pool[:8]))
    layers = [f"blocks.{i}" for i in range(39)]
    for name in ("cpu", "cuda"):
        clip = BreastClip(copy.deepcopy(bf16).to(name).eval(), device=name)
        step, names, widths = clip.fused_resident_step(tuple(u8.shape), layers, "avg",
                                                       0.3089279, 0.25053555)
        acts = torch.zeros(8, sum(widths), device=name)
        emb = torch.zeros(8, clip.module.image_projection.projection.out_features, device=name)
        step(acts, emb, u8.to(name), 0)
        sides[name] = (acts.cpu().double(), emb.cpu().double())
    gaps, col = [], 0
    for w in widths:
        a, b = (sides[k][0][:, col:col + w] for k in ("cpu", "cuda"))
        gaps.append(float((a - b).abs().mean() / a.abs().mean()))
        col += w
    emb_gap = float((sides["cpu"][1] - sides["cuda"][1]).abs().mean()
                    / sides["cpu"][1].abs().mean())
    check(all(np.isfinite(gaps)) and np.isfinite(emb_gap), "bf16 tower: non-finite output")
    say(f"[agreement] bf16 B5 x 39 blocks at 160x96, 8 images, card vs CPU, mean relative "
        f"gap of each block's pooled output: blocks 0-3 "
        f"{', '.join(f'{g:.3g}' for g in gaps[:AGREE_BF16_EARLY])}; max over blocks "
        f"{max(gaps):.3g} (block {int(np.argmax(gaps))}); embedding {emb_gap:.3g}")
    check(max(gaps[:AGREE_BF16_EARLY]) <= AGREE_BF16_EARLY_GAP,
          f"bf16 tower card vs CPU: blocks 0-3 gaps {gaps[:AGREE_BF16_EARLY]} > "
          f"{AGREE_BF16_EARLY_GAP}")
    return {"block_gaps": gaps, "embedding_gap": emb_gap}


def _ft_batches(pool, n, seed):
    """n uint8 batches of FT_BATCH pool images with labels from `seed` (~1/3 positive)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        first = (i * FT_BATCH) % (len(pool) - FT_BATCH + 1)
        out.append((np.ascontiguousarray(pool[first:first + FT_BATCH]),
                    (rng.random(FT_BATCH) < 0.35).astype(np.float32)))
    return out


def _ft_trainer(cfg, device, warmup_steps=2, total_steps=100, shift_invariant_frozen=False):
    """A Trainer of cfg's classifier on `device` (BCE with VinDr Mass's pos-weight).
    shift_invariant_frozen: the project BatchNorm biases get no update (see
    ft_card_vs_cpu)."""
    from mammodissect_torch.train.experiments import build_model
    from mammodissect_torch.train.trainer import Trainer, make_optimizer

    model = build_model(cfg).to(device)
    labels = None
    if shift_invariant_frozen:
        labels = {k: "frozen" if k.endswith("_bn2.bias") else "train"
                  for k, _ in model.named_parameters()}
    optimizer, scheduler = make_optimizer(model, cfg.lr, cfg.weight_decay, warmup_steps,
                                          total_steps, param_labels=labels)
    return Trainer(model, optimizer, scheduler, loss_kind="bce", pos_weight=FT_POS_WEIGHT,
                   seed=cfg.seed, input_wire=cfg.input_wire, norm_mean=cfg.mean,
                   norm_std=cfg.std, device=device)


def ft_train_steps(device, pool, remat):
    """(a): two warm-up and FT_TIMED_STEPS timed train steps of the B5 classifier at
    full width. Returns (row, trainer)."""
    import torch

    from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.train.experiments import FinetuneConfig

    cfg = FinetuneConfig(seed=3, remat=remat, device=device.type)  # B5, bf16, u8
    trainer = _ft_trainer(cfg, device)
    model = trainer.model
    watched = ("image_encoder._conv_stem.weight", "classifier.fc.weight",
               "image_encoder._blocks.20._bn1.running_mean",
               "image_encoder._blocks.20._bn1.running_var",
               "image_encoder._blocks.38._project_conv.weight")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}
    batches = _ft_batches(pool, 2 + FT_TIMED_STEPS, seed=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_expand_dw.launches = 0
    bn_epilogue.launches = 0
    losses = [trainer.train_batch(u8, y) for u8, y in batches[:2]]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses += [trainer.train_batch(u8, y) for u8, y in batches[2:]]
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_expand_dw.launches
    k3_launches = bn_epilogue.launches
    ms = start.elapsed_time(end) / FT_TIMED_STEPS
    state = model.state_dict()
    unchanged = [k for k in watched if torch.equal(state[k], before[k])]
    check(bool(np.isfinite(losses).all()), f"fine-tune (remat={remat}): non-finite loss {losses}")
    check(not unchanged, f"fine-tune (remat={remat}): unchanged after the steps: {unchanged}")
    check(launches == 0, f"fine-tune (remat={remat}): kernel 2 launched {launches} times in "
          "train steps (the training forward is unfused)")
    check(k3_launches == 0, f"fine-tune (remat={remat}): kernel 3 launched {k3_launches} times "
          "in train steps (training keeps cuDNN's BatchNorm)")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "fine-tune: parameters are not float32")
    row = {"remat": remat, "batch": FT_BATCH, "ms_per_step": ms,
           "img_per_s": FT_BATCH * 1e3 / ms, "wall_s_timed": wall, "first_loss": losses[0],
           "losses": losses, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "kernel2_launches_in_train_steps": launches,
           "kernel3_launches_in_train_steps": k3_launches}
    say(f"[finetune] train steps, B5 classifier at {IMAGE_HW[0]}x{IMAGE_HW[1]}, batch {FT_BATCH}, "
        f"bf16 compute over fp32 weights, u8 wire, remat={remat}: {ms:.2f} ms a step "
        f"({row['img_per_s']:.2f} img/s; host clock {wall * 1e3 / FT_TIMED_STEPS:.2f} ms) over "
        f"{FT_TIMED_STEPS} timed steps, peak {row['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
        f"losses {[round(l, 4) for l in losses]}; weights and BN statistics changed; kernel 2 "
        f"launches in train steps: {launches}, kernel 3: {k3_launches}")
    return row, trainer


def ft_eval_and_checkpoint(device, pool, trainer, work):
    """(b): kernel 2's bf16 instantiation in the trained model's eval; its checkpoint
    as the fp32 C-dissect target."""
    import torch

    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.models.layers import Conv2d, Linear
    from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.normalize import u8_minmax_meanstd
    from mammodissect_torch.train.checkpoints import load_checkpoint, save_checkpoint

    u8, y = _ft_batches(pool, 1, seed=5)[0]
    fused_expand_dw.launches = 0
    bn_epilogue.launches = 0
    loss, preds = trainer.eval_batch(u8, y)
    torch.cuda.synchronize()
    launches = fused_expand_dw.launches
    k3_launches = bn_epilogue.launches
    model = trainer.model
    fused = [b for b in model.image_encoder._blocks if b.fused_front]
    with torch.no_grad():
        dtypes = {b._front_weights_cached()[0].dtype for b in fused}
    check(launches == 32, f"eval of the trained model launched kernel 2 {launches} times, not 32")
    check(k3_launches == 52,
          f"eval of the trained model launched kernel 3 {k3_launches} times, not 52")
    check(dtypes == {torch.bfloat16}, f"kernel 2 ran with weights of {dtypes}, not bf16")
    check(np.isfinite(loss) and np.isfinite(preds).all(), "non-finite eval of the trained model")
    path = os.path.join(work, "finetuned.pth")
    t0 = time.perf_counter()
    save_checkpoint(path, trainer, epoch=0, metrics={"auroc": 0.5}, predictions=preds)
    save_s = time.perf_counter() - t0
    target = get_target_model("breastclip_classifier", finetuned_ckpt=path, device=device.type)
    saved = load_checkpoint(path)["model"]
    got = target.model.state_dict()
    check(set(got) == set(saved) and all(torch.equal(got[k].cpu(), v) for k, v in saved.items()),
          "the C-dissect target's state dict differs from the checkpoint's")
    # the trained model computing in fp32 (its weights are fp32): the target's arithmetic
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = None
    x = u8_minmax_meanstd(torch.from_numpy(u8).to(device), trainer.norm_mean, trainer.norm_std)
    capture = tuple(range(len(fused) + 7))  # all 39 blocks of B5
    with torch.no_grad():
        want = model.eval()(x, capture=capture)
        got_out = target.model(x, capture=capture)
    # the same float32 arithmetic on the same weights (kernel 2 fp32, cuDNN, TF32 off):
    # 1e-4 of each output's largest magnitude
    errs = {"logits": (got_out[0], want[0])}
    errs.update({k: (got_out[1][k], v) for k, v in want[1].items()})
    errs = {k: float((a.float() - b.float()).abs().max()) / (1e-6 + float(b.abs().max()))
            for k, (a, b) in errs.items()}
    worst = max(errs, key=errs.get)
    check(len(errs) == 40 and errs[worst] <= 1e-4,
          f"the C-dissect target differs from the trained model in fp32 at {worst}: {errs[worst]}")
    row = {"eval_kernel2_launches": launches, "eval_kernel2_dtype": "bfloat16",
           "eval_kernel3_launches": k3_launches,
           "checkpoint_bytes": os.path.getsize(path), "checkpoint_save_s": save_s,
           "target_max_rel_err": errs[worst], "target_worst": worst,
           "logit_range": [float(want[0].min()), float(want[0].max())]}
    say(f"[finetune] eval batch of the trained model: kernel 2 launched {launches} times, bf16, "
        f"kernel 3 {k3_launches} times; "
        f"checkpoint {row['checkpoint_bytes']} bytes written in {save_s:.2f} s, loaded as the "
        f"breastclip_classifier target (fp32): state dict equal; its logits and 39 pooled "
        f"blocks vs the trained model computing in fp32: max err {errs[worst]:.3g} of the "
        f"largest entry ({worst}; tol 1e-4); logits in {row['logit_range']}")
    return row


def ft_end_to_end(device, pool, work):
    """(c): do_experiments at full width on synthetic mammogram PNGs, one epoch."""
    import pandas as pd
    import torch
    from PIL import Image

    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum
    from mammodissect_torch.train.experiments import (
        FinetuneConfig,
        checkpoint_path,
        do_experiments,
    )

    root = os.path.join(work, "pngs")
    os.makedirs(root)
    rng = np.random.default_rng(6)
    rows = []
    t0 = time.perf_counter()
    for i in range(FT_TRAIN + FT_VALID):
        Image.fromarray(pool[i % len(pool), :, :, 0]).save(os.path.join(root, f"m{i}.png"))
        rows.append({"image_path": f"m{i}.png", "Mass": int(rng.random() < 0.35),
                     "split": "training" if i < FT_TRAIN else "test"})
    rows[FT_TRAIN]["Mass"], rows[FT_TRAIN + 1]["Mass"] = 0, 1  # both classes in valid
    pd.DataFrame(rows).to_csv(os.path.join(root, "meta.csv"), index=False)
    write_s = time.perf_counter() - t0
    cfg = FinetuneConfig(csv_file=os.path.join(root, "meta.csv"), data_dir=root, dataset="vindr",
                         label="Mass", img_size=IMAGE_HW, epochs=1, weighted_BCE="y",
                         BCE_weights={"fold0": FT_POS_WEIGHT}, seed=7, device=device.type,
                         checkpoints=os.path.join(work, "ck"),
                         output_path=os.path.join(work, "out"),
                         tensorboard_path=os.path.join(work, "tb"))
    logs = []
    fused_expand_dw.launches = 0
    soft_wpmi_gather_logsum.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    oof = do_experiments(cfg, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mbconv": fused_expand_dw.launches, "wpmi": soft_wpmi_gather_logsum.launches}
    eval_batches = (FT_VALID + FT_TRAIN) // FT_BATCH  # the valid fold + the train-eval pass
    timing = [l for l in logs if l.startswith("[time] epoch 1: ")]
    check(len(timing) == 1, f"do_experiments logged no timing line: {logs}")
    split = {k: float(v) for k, v in re.findall(r"(\w+) ([\d.]+) s", timing[0])}
    ckpt = checkpoint_path(cfg)
    oof_csv = os.path.join(cfg.output_path, "oof_predictions.csv")
    check(os.path.exists(ckpt), f"do_experiments wrote no checkpoint at {ckpt}: {logs}")
    check(os.path.exists(oof_csv) and len(oof) == FT_VALID, "no out-of-fold CSV")
    check(bool(np.isfinite(oof["prediction"].values).all()), "non-finite out-of-fold predictions")
    check(launches["mbconv"] == 32 * eval_batches,
          f"do_experiments launched kernel 2 {launches['mbconv']} times, expected "
          f"{32 * eval_batches} (32 an eval batch, none in train steps)")
    row = {"train_images": FT_TRAIN, "valid_images": FT_VALID, "png_write_s": write_s,
           "png_root": root,
           "wall_s": wall, "seconds": split, "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "logs": [l for l in logs if l.startswith(("epoch", "[time]", "[cv]"))]}
    say(f"[finetune] do_experiments, one epoch ({FT_TRAIN} train + {FT_VALID} valid PNGs at "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]}, label Mass, train-eval pass on): {wall:.2f} s wall, of "
        f"which host loading and augmentation {split.get('data', 0.0):.2f} s, train_batch "
        f"{split.get('train_batch', 0.0):.2f} s, eval_batch {split.get('eval_batch', 0.0):.2f} s; "
        f"peak {row['max_memory_allocated_bytes'] / 2**30:.2f} GiB; launches {launches}; "
        f"wrote {os.path.basename(ckpt)} and oof_predictions.csv; {row['logs']}")
    return row


def ft_card_vs_cpu():
    """(d): three fp32 train steps of the test arch at 64x48 on the card and on the CPU
    (TF32 off, set by the entry points' policy). The project BatchNorm biases are
    frozen in both: a batch-statistics BatchNorm after the next 1x1 convolution
    removes any shift, so their gradient is rounding noise, which Adam would turn into
    steps of +-lr whose sign differs between any two implementations."""
    import torch

    from mammodissect_torch.train.experiments import FinetuneConfig

    cfg = FinetuneConfig(arch="t_test_ft", img_size=(64, 48), dtype="float32", pad_mode="same",
                         bn_momentum=0.9, lr=1e-3, seed=8)
    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 256, size=(FT_BATCH, 64, 48, 1), dtype=np.uint8),
                (rng.random(FT_BATCH) < 0.5).astype(np.float32), n) for n in (8, 8, 5)]
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = _ft_trainer(cfg, torch.device(dev), warmup_steps=1, total_steps=10,
                         shift_invariant_frozen=True)
        runs[dev] = (tr.model, [tr.train_batch(*b) for b in batches])
    (cpu, cpu_losses), (gpu, gpu_losses) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
    cpu_state, gpu_state = cpu.state_dict(), gpu.state_dict()
    # tolerance 1e-5 + 1e-3 of each tensor's largest entry: fp32 convolutions summed in
    # another order, then Adam's first, sign-like steps; the atol covers statistics that
    # are 0 up to rounding (the running mean after a BatchNorm whose bias is 0)
    ratio = {k: float((gpu_state[k].cpu() - v).abs().max() / (1e-5 + 1e-3 * v.abs().max()))
             for k, v in cpu_state.items() if v.is_floating_point()}
    worst = max(ratio, key=ratio.get)
    check(loss_err <= 1e-4, f"card vs CPU: losses {gpu_losses} vs {cpu_losses}")
    check(ratio[worst] <= 1.0, f"card vs CPU: {worst} is {ratio[worst]:.3g} x its tolerance")
    say(f"[finetune] card vs CPU, 3 fp32 train steps of t_test_ft at 64x48 (TF32 off): losses "
        f"{[round(l, 6) for l in gpu_losses]} vs {[round(l, 6) for l in cpu_losses]} (max rel "
        f"err {loss_err:.3g}, tol 1e-4); weights and statistics within {ratio[worst]:.3g} of "
        f"their tolerance 1e-5 + 1e-3 max|x| (worst {worst})")
    return {"loss_max_rel_err": loss_err, "state_worst_share_of_tol": ratio[worst],
            "worst": worst}


def phase_finetune(device, pool):
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    remat, _ = ft_train_steps(device, pool, remat=True)
    torch.cuda.empty_cache()
    plain, trainer = ft_train_steps(device, pool, remat=False)
    check(abs(remat["first_loss"] - plain["first_loss"]) <= 1e-3 * abs(plain["first_loss"]),
          f"remat changed the first loss: {remat['first_loss']} vs {plain['first_loss']}")
    check(remat["max_memory_allocated_bytes"] < plain["max_memory_allocated_bytes"],
          "remat did not lower the peak memory")
    say(f"[finetune] remat: first loss {remat['first_loss']:.6f} vs {plain['first_loss']:.6f} "
        f"(tol 1e-3 relative: the same weights and masks, bf16 convolutions whose algorithm "
        f"cuDNN may choose again); peak {remat['max_memory_allocated_bytes'] / 2**30:.2f} vs "
        f"{plain['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
        f"{remat['ms_per_step']:.2f} vs {plain['ms_per_step']:.2f} ms a step")
    evaluated = ft_eval_and_checkpoint(device, pool, trainer, work)
    del trainer
    torch.cuda.empty_cache()
    e2e = ft_end_to_end(device, pool, work)
    torch.cuda.empty_cache()
    agree = ft_card_vs_cpu()
    return {"train": plain, "train_remat": remat, "eval": evaluated, "end_to_end": e2e,
            "card_vs_cpu": agree}


def stage_seconds(logs):
    """{stage: seconds} from the staged run's log lines ("[harvest] ... in 3.1s"): the
    model builds, the three cache stages, scoring, and the top-k and CSV writing."""
    out = {}
    for line in logs:
        m = re.match(r"\[(target|dissector|harvest|clip-img|clip-txt|scoring|results)\] "
                     r".* in ([\d.]+)s", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def gdissect_run(cfg, probe, **kw):
    """One staged `run_dissection` with both kernels' counts zeroed just before and read
    just after: (DataFrame, logs, wall s, launches, peak bytes)."""
    import torch

    from mammodissect_torch.dissect.engine import run_dissection
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum

    logs = []
    torch.cuda.reset_peak_memory_stats()
    fused_expand_dw.launches = 0
    soft_wpmi_gather_logsum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CLIP targets drop num_class, loudly
        df, _ = run_dissection(cfg, probe=probe, log=logs.append, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mbconv": fused_expand_dw.launches, "wpmi": soft_wpmi_gather_logsum.launches}
    return df, logs, wall, launches, torch.cuda.max_memory_allocated()


def gdissect_full_width(device, work):
    """(a) and (c): the ViT-B/16 G-dissect at full width, then clip_rn50 as target on the
    same probe and activation dir."""
    from mammodissect_torch.data.probes import get_probe
    from mammodissect_torch.dissect.engine import DissectConfig, read_concepts

    t0 = time.perf_counter()
    probe_kwargs = {"n": GD_N, "h": GD_SIZE, "w": GD_SIZE, "c": 3}
    probe = get_probe("synthetic", **probe_kwargs)
    probe_s = time.perf_counter() - t0
    n_concepts = len(read_concepts(CONCEPTS))
    cfg = DissectConfig(target_model="ViT-B/16", clip_model="ViT-B/16",
                        target_layers=[f"layers.{i}" for i in range(12)], d_probe="synthetic",
                        probe_kwargs=probe_kwargs, concept_set=CONCEPTS, batch_size=GD_BATCH,
                        similarity_fn="soft_wpmi", resident=False, device=device.type,
                        activation_dir=os.path.join(work, "acts"),
                        result_dir=os.path.join(work, "results"))
    df, logs, wall, launches, peak = gdissect_run(cfg, probe)
    stages = stage_seconds(logs)
    check(len(df) == 12 * 768, f"G-dissect CSV has {len(df)} rows, expected 9216")
    check(np.isfinite(csv_similarities(df)).all(), "non-finite similarities in the G-dissect CSV")
    check(launches == {"mbconv": 0, "wpmi": 1},
          f"G-dissect launches {launches}, expected kernel 1 once and kernel 2 never")
    check(set(stages) == {"target", "dissector", "harvest", "clip-img", "clip-txt", "scoring",
                          "results"}, f"G-dissect stage lines missing: {logs}")
    row = {"images": GD_N, "batch": GD_BATCH, "size": GD_SIZE, "units": len(df),
           "concepts": n_concepts, "wall_s": wall, "img_per_s": GD_N / wall, "probe_s": probe_s,
           "stages_s": stages, "other_s": wall - sum(stages.values()),
           "max_memory_allocated_bytes": peak, "launches": launches}
    say(f"[g-dissect] ViT-B/16 x 12 layers (9216 units) dissected by ViT-B/16, {n_concepts} "
        f"BPE concepts, soft-WPMI, fp32, {GD_N} synthetic images at {GD_SIZE}x{GD_SIZE}x3, "
        f"batch {GD_BATCH}, staged: {wall:.2f} s wall, {row['img_per_s']:.2f} img/s (two "
        f"ViT-B/16 forwards an image); stages {stages} s, other (cache reads and "
        f"writes) {row['other_s']:.2f} s; peak {peak / 2**30:.2f} GiB; launches "
        f"{launches}; probe built in {probe_s:.2f} s (not in the wall)")

    rn_layers = ["conv1", "layer1", "layer2", "layer3", "layer4"]
    rn_cfg = dataclasses.replace(cfg, target_model="clip_rn50", target_layers=rn_layers)
    rn_df, rn_logs, rn_wall, rn_launches, rn_peak = gdissect_run(rn_cfg, probe)
    rn_stages = stage_seconds(rn_logs)
    check(len(rn_df) == 3904, f"clip_rn50 CSV has {len(rn_df)} rows, expected 3904")
    check(np.isfinite(csv_similarities(rn_df)).all(), "non-finite similarities (clip_rn50)")
    check("[clip-img] probe embeddings cached, skipping" in rn_logs
          and not {"dissector", "clip-txt", "clip-img"} & set(rn_stages),
          f"clip_rn50 did not reuse the dissector's caches: {rn_logs}")
    check(rn_launches == {"mbconv": 0, "wpmi": 1}, f"clip_rn50 launches {rn_launches}")
    rn = {"units": len(rn_df), "wall_s": rn_wall, "img_per_s": GD_N / rn_wall,
          "harvest_img_per_s": GD_N / rn_stages["harvest"], "stages_s": rn_stages,
          "max_memory_allocated_bytes": rn_peak, "launches": rn_launches}
    say(f"[g-dissect] clip_rn50 (conv1, layer1-4: 3904 units) on the same probe and "
        f"activation dir: {rn_wall:.2f} s wall, stages {rn_stages} s (the ViT-B/16 image "
        f"and text caches read, not recomputed), peak {rn_peak / 2**30:.2f} GiB, launches "
        f"{rn_launches}")
    return row, rn, n_concepts, probe


def wpmi_gdissect_shape(device, u, c, k, n, label="G-dissect"):
    """(b): kernel 1 at the G-dissect shape (or another staged dissection's, named by
    `label`) against its plain version; times and bound."""
    import torch

    from mammodissect_torch.ops.cuda_wpmi import (
        _launch,
        soft_wpmi_gather_logsum,
        soft_wpmi_gather_logsum_plain,
    )

    g = torch.Generator(device="cpu").manual_seed(11)
    clip_sm = torch.softmax(torch.randn((n, c), generator=g) * 4, dim=1).to(device)
    inds = torch.randint(0, n, (u, k), generator=g, dtype=torch.int32).to(device)
    p_in = (0.998 - torch.arange(k) / 100 * (0.998 - 0.97)).float().to(device)
    got = soft_wpmi_gather_logsum(clip_sm, inds, p_in)
    want = soft_wpmi_gather_logsum_plain(clip_sm, inds, p_in)
    torch.cuda.synchronize()
    err = (got - want).abs()
    check(bool((err <= 1e-5 + 1e-5 * want.abs()).all()),
          f"kernel 1 disagrees at the G-dissect shape: max abs err {float(err.max())}")
    row = {"shape": {"U": u, "C": c, "k": k, "N": n}, "max_abs_err": float(err.max()),
           "ms": cuda_ms(lambda: soft_wpmi_gather_logsum(clip_sm, inds, p_in), reps=20, warmup=2),
           "launch_ms": cuda_ms(lambda: _launch(clip_sm, inds, p_in, 1e-7), reps=20, warmup=2),
           "plain_ms": cuda_ms(lambda: soft_wpmi_gather_logsum_plain(clip_sm, inds, p_in), reps=3),
           **wpmi_bound(u, c, k, n)}
    design = "slab" if n <= 1700 else "gather"  # clip_sm's column block in shared memory
    say(f"[kernel 1] {label} shape U={u} C={c} k={k} N={n} ({design} design): max abs err "
        f"{row['max_abs_err']:.3g} (tol 1e-5 + 1e-5|x|); {row['ms']:.4f} ms through the "
        f"wrapper, launch alone {row['launch_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def gdissect_card_vs_cpu(d_probe="synthetic", probe_kwargs=None, image_size=64,
                         label="narrow ViT (4 x 128, 64x64), 256 images"):
    """(d), and (f)'s CIFAR-100 run: a narrow ViT G-dissect (fp32, TF32 off) on the card
    and on the CPU, the probe resolved by name in each run."""
    import torch

    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
    from mammodissect_torch.models.clip_vit import OpenAIClip

    if probe_kwargs is None:
        probe_kwargs = {"n": 256, "h": 64, "w": 64, "c": 3, "seed": 1}
    narrow = dict(vision_width=128, vision_layers=4, vision_heads=2, text_width=128,
                  text_layers=2, text_heads=2, embed_dim=64, image_size=image_size)
    work = tempfile.mkdtemp(prefix="chip_smoke_gd_agree_")
    dfs = {}
    for dev in ("cpu", "cuda"):
        clip = OpenAIClip("ViT-B/16", seed=1, device=dev, **narrow)
        cfg = DissectConfig(target_model="ViT-B/16", clip_model="ViT-B/16",
                            target_layers=[f"layers.{i}" for i in range(4)], d_probe=d_probe,
                            probe_kwargs=probe_kwargs, concept_set=CONCEPTS, batch_size=64,
                            device=dev, activation_dir=os.path.join(work, dev, "acts"),
                            result_dir=os.path.join(work, dev, "results"))
        dfs[dev], _ = run_dissection(cfg, target=clip, dissector=clip, log=lambda *_: None)
    torch.cuda.synchronize()
    top = {k: [row[0] for row in df["description"]] for k, df in dfs.items()}
    agree = float(np.mean([a == b for a, b in zip(top["cpu"], top["cuda"])]))
    images = float(np.mean([a == b for a, b in zip(dfs["cpu"]["images"], dfs["cuda"]["images"])]))
    say(f"[g-dissect] card vs CPU, {label}, {len(dfs['cuda'])} units, fp32, TF32 off: top-1 "
        f"concept agreement {agree:.4f}, identical top-image lists {images:.4f}")
    check(len(dfs["cuda"]) == len(dfs["cpu"]) == 512, f"G-dissect card vs CPU ({d_probe}): "
          f"{len(dfs['cuda'])} and {len(dfs['cpu'])} rows, expected 512")
    check(agree >= 0.99, f"G-dissect card vs CPU ({d_probe}): top-1 agreement {agree} < 0.99")
    check(images == 1.0, f"G-dissect card vs CPU ({d_probe}): top images differ ({images})")
    return {"top1_agreement": agree, "top_images_identical": images}


@contextlib.contextmanager
def stand_in_cifar100(n_test=CIFAR_TEST_N, seed=0):
    """A `torchvision` module in sys.modules whose `datasets.CIFAR100(root, train,
    download)` refuses to download and gives seeded uint8 `data` of the split's shape
    ([50000 or n_test, 32, 32, 3]) and `targets`, each of the 100 classes equally often,
    reading nothing under `root`. The entry it replaced is put back on the way out."""
    import types

    class CIFAR100:
        def __init__(self, root, train=True, download=False):
            check(download is False, f"CIFAR100(download={download!r}): nothing is downloaded")
            n = CIFAR_TRAIN_N if train else n_test
            rng = np.random.default_rng(seed + int(train))
            self.data = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
            self.targets = rng.permutation(np.arange(n) % CIFAR_CLASSES).tolist()

    tv = types.ModuleType("torchvision")
    tv.datasets = types.SimpleNamespace(CIFAR100=CIFAR100)
    missing = object()
    saved = sys.modules.get("torchvision", missing)
    sys.modules["torchvision"] = tv
    try:
        yield
    finally:
        if saved is missing:
            del sys.modules["torchvision"]
        else:
            sys.modules["torchvision"] = saved


def gdissect_cifar100(device, work, n_concepts, card):
    """(f): ViT-B/16 x 12 layers dissected by ViT-B/16, both towers at CIFAR's 32x32,
    on the stand-in CIFAR-100 test split resolved by name (`cifar100_val`)."""
    from mammodissect_torch.dissect.engine import DissectConfig

    size = {"image_size": 32}
    cfg = DissectConfig(target_model="ViT-B/16", clip_model="ViT-B/16",
                        target_layers=[f"layers.{i}" for i in range(12)], d_probe="cifar100_val",
                        probe_kwargs={"data_root": os.path.join(work, "cifar100")},
                        target_kwargs=size, dissector_kwargs=size, concept_set=CONCEPTS,
                        batch_size=GD_BATCH, similarity_fn="soft_wpmi", resident=False,
                        device=device.type, activation_dir=os.path.join(work, "acts_cifar100"),
                        result_dir=os.path.join(work, "results_cifar100"))
    with stand_in_cifar100():
        df, logs, wall, launches, peak = gdissect_run(cfg, None)
    stages = stage_seconds(logs)
    check(len(df) == 12 * 768, f"CIFAR-100 G-dissect CSV has {len(df)} rows, expected 9216")
    check(np.isfinite(csv_similarities(df)).all(),
          "non-finite similarities in the CIFAR-100 G-dissect CSV")
    check(launches == {"mbconv": 0, "wpmi": 1},
          f"CIFAR-100 G-dissect launches {launches}, expected kernel 1 once and kernel 2 never")
    check(any(l.startswith(f"[harvest] {CIFAR_TEST_N} images x 12 layers") for l in logs),
          f"CIFAR-100 G-dissect did not harvest {CIFAR_TEST_N} images: {logs}")
    check(set(stages) == {"target", "dissector", "harvest", "clip-img", "clip-txt", "scoring",
                          "results"}, f"CIFAR-100 G-dissect stage lines missing: {logs}")
    row = {"images": CIFAR_TEST_N, "batch": GD_BATCH, "size": 32, "units": len(df),
           "concepts": n_concepts, "wall_s": wall, "img_per_s": CIFAR_TEST_N / wall,
           "stages_s": stages, "other_s": wall - sum(stages.values()),
           "max_memory_allocated_bytes": peak, "launches": launches, "card": card}
    say(f"[g-dissect] CIFAR-100 (cifar100_val by name, the stand-in's {CIFAR_TEST_N} images at "
        f"32x32x3): ViT-B/16 x 12 layers (9216 units) dissected by ViT-B/16, both at "
        f"image_size 32, {n_concepts} BPE concepts, soft-WPMI, fp32, batch {GD_BATCH}, "
        f"staged: {wall:.2f} s wall with the probe's build, {row['img_per_s']:.2f} img/s; "
        f"stages {stages} s, other {row['other_s']:.2f} s; peak {peak / 2**30:.2f} GiB; "
        f"launches {launches}; {card}")
    return row


def zeroshot_run(argv, work, name):
    """One `cli.zseval` run on the card with both kernels' counts zeroed just before
    and read just after: (results, wall s, launches)."""
    import torch

    from mammodissect_torch.cli import zseval
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum

    out = os.path.join(work, f"{name}.json")
    fused_expand_dw.launches = 0
    soft_wpmi_gather_logsum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy WordPiece vocab
        rc = zseval.main(argv + ["--device", "cuda", "--output", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"zseval ({name}) exited {rc}")
    with open(out) as f:
        results = json.load(f)
    launches = {"mbconv": fused_expand_dw.launches, "wpmi": soft_wpmi_gather_logsum.launches}
    return results, wall, launches


def phase_zeroshot(png_root):
    """(e): zero-shot with the bf16 BreastClip on the mammogram PNGs, then ViT-B/16 on
    RGB PNGs in two class folders."""
    from PIL import Image

    work = tempfile.mkdtemp(prefix="chip_smoke_zs_")
    meta = os.path.join(png_root, "meta.csv")
    n_mammo = FT_TRAIN + FT_VALID
    batch = 32  # the CLI's default
    results, wall, launches = zeroshot_run(
        ["--clip_model", "breastclip", "--d_probe", f"csv:{meta}",
         "--probe_kwargs", json.dumps({"root": png_root, "label_col": "Mass"}),
         "--dissector_kwargs", json.dumps({"dtype": "bfloat16"}), "--tasks", "Mass"],
        work, "breastclip")
    n_batches = -(-n_mammo // batch)
    auroc = results.get("Mass", {}).get("auroc")
    check(auroc is not None and np.isfinite(auroc), f"zero-shot breastclip: AUROC {results}")
    check(launches == {"mbconv": 32 * n_batches, "wpmi": 0},
          f"zero-shot breastclip launched {launches}, expected kernel 2 {32 * n_batches} times")
    mammo = {"images": n_mammo, "batch": batch, "wall_s": wall, "img_per_s": n_mammo / wall,
             "auroc": auroc, "launches": launches}
    say(f"[zero-shot] breastclip (B5 bf16 at {IMAGE_HW[0]}x{IMAGE_HW[1]}, random weights), "
        f"{n_mammo} mammogram PNGs (csv probe, label Mass), batch {batch}: AUROC {auroc:.4f}, "
        f"{wall:.2f} s wall with the model build ({mammo['img_per_s']:.2f} img/s); launches "
        f"{launches} ({launches['mbconv'] // n_batches} a batch)")

    rng = np.random.default_rng(12)
    root = os.path.join(work, "rgb")
    for i in range(ZS_RGB_N):
        d = os.path.join(root, "0_no_mass" if i % 2 == 0 else "1_mass")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size=(GD_SIZE, GD_SIZE, 3), dtype=np.uint8)).save(
            os.path.join(d, f"{i}.png"))
    results, wall, launches = zeroshot_run(
        ["--clip_model", "ViT-B/16", "--d_probe", f"folder:{root}",
         "--probe_kwargs", json.dumps({"image_shape": [GD_SIZE, GD_SIZE, 3]}), "--tasks", "Mass"],
        work, "vit")
    auroc = results.get("Mass", {}).get("auroc")
    check(auroc is not None and np.isfinite(auroc), f"zero-shot ViT-B/16: AUROC {results}")
    check(launches == {"mbconv": 0, "wpmi": 0}, f"zero-shot ViT-B/16 launched {launches}")
    vit = {"images": ZS_RGB_N, "batch": batch, "wall_s": wall, "img_per_s": ZS_RGB_N / wall,
           "auroc": auroc, "launches": launches}
    say(f"[zero-shot] ViT-B/16 (fp32, random weights), {ZS_RGB_N} RGB PNGs at "
        f"{GD_SIZE}x{GD_SIZE} in two class folders: AUROC {auroc:.4f}, {wall:.2f} s wall with "
        f"the model build ({vit['img_per_s']:.2f} img/s); launches {launches}")
    return {"breastclip": mammo, "vit": vit}


def phase_gdissect(device, png_root, card):
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_gd_")
    full, rn, n_concepts, probe = gdissect_full_width(device, work)
    torch.cuda.empty_cache()
    kernel1 = wpmi_gdissect_shape(device, full["units"], n_concepts, 100, GD_N)
    agree = gdissect_card_vs_cpu()
    torch.cuda.empty_cache()
    say(f"[g-dissect] CIFAR-100 runs: no CIFAR-100 files are here, so `torchvision` is a "
        f"stand-in whose CIFAR100 gives seeded uint8 images (seed 0) of the split's shape, "
        f"{CIFAR_CLASSES} classes")
    cifar = gdissect_cifar100(device, work, n_concepts, card)
    torch.cuda.empty_cache()
    cifar_kernel1 = wpmi_gdissect_shape(device, cifar["units"], n_concepts, 100, CIFAR_TEST_N,
                                        label="CIFAR-100")
    with stand_in_cifar100(n_test=CIFAR_AGREE_N):
        cifar_agree = gdissect_card_vs_cpu(
            "cifar100_val", {"data_root": os.path.join(work, "cifar100")}, image_size=32,
            label=f"narrow ViT (4 x 128, 32x32), {CIFAR_AGREE_N} stand-in CIFAR-100 images")
    torch.cuda.empty_cache()
    zs = phase_zeroshot(png_root)
    return {"vit": full, "clip_rn50": rn, "kernel1": kernel1, "card_vs_cpu": agree,
            "cifar100": cifar, "kernel1_cifar100": cifar_kernel1,
            "card_vs_cpu_cifar100": cifar_agree,
            "zeroshot": zs, "work": work, "probe": probe, "concepts": n_concepts}


ZOO = {  # target: (layers, units), the CLI's default capture points
    "resnet50": (["conv1", "layer1", "layer2", "layer3", "layer4"], 64 + 256 + 512 + 1024 + 2048),
    "vit": ([f"layers.{i}" for i in range(12)], 12 * 768),
    "breastclip_swin": ([f"layers.{i}" for i in range(4)], 96 + 192 + 384 + 768),
}


def zoo_run(name, cfg, probe, n_images, expect_launches):
    """One zoo dissection reading the dissector's caches of an earlier phase: rows,
    finite similarities, the caches read (no dissector built), launches as expected."""
    layers, units = ZOO[name]
    df, logs, wall, launches, peak = gdissect_run(cfg, probe)
    stages = stage_seconds(logs)
    check(len(df) == units, f"{name}: CSV has {len(df)} rows, expected {units}")
    check(np.isfinite(csv_similarities(df)).all(), f"{name}: non-finite similarities")
    check("[clip-img] probe embeddings cached, skipping" in logs
          and not {"dissector", "clip-txt", "clip-img"} & set(stages),
          f"{name} did not read the dissector's caches: {logs}")
    check(launches == expect_launches,
          f"{name}: launches {launches}, expected {expect_launches}")
    row = {"units": units, "images": n_images, "wall_s": wall, "img_per_s": n_images / wall,
           "harvest_img_per_s": n_images / stages["harvest"], "stages_s": stages,
           "other_s": wall - sum(stages.values()), "max_memory_allocated_bytes": peak,
           "launches": launches, "rows": len(df)}
    return row


def zoo_full_width(device, gdissect, c_dissect, pool):
    """(a) resnet50 and vit on phase 11's probe and activation dir, dissected by
    ViT-B/16; (b) breastclip_swin (swin-tiny) on phase 8's 512 mammograms and
    activation dir, dissected by the bf16 breastclip."""
    import torch

    from mammodissect_torch.dissect.engine import DissectConfig

    rows = {}
    work = gdissect["work"]
    for name in ("resnet50", "vit"):
        cfg = DissectConfig(target_model=name, clip_model="ViT-B/16", target_layers=ZOO[name][0],
                            d_probe="synthetic",
                            probe_kwargs={"n": GD_N, "h": GD_SIZE, "w": GD_SIZE, "c": 3},
                            concept_set=CONCEPTS, batch_size=GD_BATCH, similarity_fn="soft_wpmi",
                            resident=False, device=device.type,
                            activation_dir=os.path.join(work, "acts"),
                            result_dir=os.path.join(work, "results"))
        rows[name] = zoo_run(name, cfg, gdissect["probe"], GD_N, {"mbconv": 0, "wpmi": 1})
        torch.cuda.empty_cache()
    work = c_dissect["work"]
    cfg = DissectConfig(target_model="breastclip_swin", clip_model="breastclip",
                        target_layers=ZOO["breastclip_swin"][0], d_probe="synthetic_mammo",
                        concept_set=CONCEPTS, batch_size=MAIN_BATCH, similarity_fn="soft_wpmi",
                        resident=False, device=device.type,
                        target_kwargs={"variant": "swin-tiny", "seed": 3},
                        activation_dir=os.path.join(work, "acts"),
                        result_dir=os.path.join(work, "results"))
    # the dissector's embeddings and text come from phase 8's caches: kernel 2 (the
    # B5 dissector's) does not run here, kernel 1 scores once
    rows["breastclip_swin"] = zoo_run("breastclip_swin", cfg, CyclicProbe(pool, C_DISSECT_N),
                                      C_DISSECT_N, {"mbconv": 0, "wpmi": 1})
    torch.cuda.empty_cache()
    for name, r in rows.items():
        say(f"[zoo] {name} ({r['units']} units, fp32, TF32 off), {r['images']} images, "
            f"dissected by {'ViT-B/16' if name != 'breastclip_swin' else 'breastclip bf16'} "
            f"from the cached embeddings: {r['wall_s']:.2f} s wall, {r['img_per_s']:.2f} img/s "
            f"(harvest {r['harvest_img_per_s']:.2f} img/s); stages {r['stages_s']} s, other "
            f"{r['other_s']:.2f} s; peak {r['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
            f"{r['rows']} CSV rows, similarities finite; launches {r['launches']}")
    return rows


def zoo_card_vs_cpu():
    """(c) a narrow ResNet, ViT encoder and Swin, each dissected end to end on the card
    and on the CPU by the same narrow CLIP ViT (fp32, TF32 off); and BreastClip with a
    narrow Swin and a narrow ViT image tower embedding the same images on both."""
    import torch

    from mammodissect_torch.data.probes import get_probe
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.models.breastclip import BreastClip
    from mammodissect_torch.models.clip_vit import OpenAIClip

    narrow_clip = dict(vision_width=128, vision_layers=4, vision_heads=2, text_width=128,
                       text_layers=2, text_heads=2, embed_dim=64, image_size=64)
    targets = {  # name: (target kwargs, layers)
        "resnet18": ({}, ["conv1", "layer1", "layer2", "layer3", "layer4"]),
        "vit": (dict(image_size=64, width=128, layers=3, heads=2), ["layers.0", "layers.2"]),
        "breastclip_swin": (dict(spec={"embed": 32, "depths": [2, 2, 2], "heads": [2, 2, 4]}),
                            ["layers.0", "layers.1", "layers.2"]),
    }
    probe = get_probe("synthetic", n=256, h=64, w=64, c=3, seed=2)
    work = tempfile.mkdtemp(prefix="chip_smoke_zoo_agree_")
    dfs = {}
    for dev in ("cpu", "cuda"):
        clip = OpenAIClip("ViT-B/16", seed=1, device=dev, **narrow_clip)
        for name, (kw, layers) in targets.items():
            cfg = DissectConfig(target_model=name, clip_model="ViT-B/16", target_layers=layers,
                                d_probe="synthetic", concept_set=CONCEPTS, batch_size=64,
                                device=dev, activation_dir=os.path.join(work, dev, "acts"),
                                result_dir=os.path.join(work, dev, name))
            target = get_target_model(name, device=dev, seed=4, **kw)
            dfs[dev, name], _ = run_dissection(cfg, probe=probe, target=target, dissector=clip,
                                               log=lambda *_: None)
    torch.cuda.synchronize()
    out = {}
    for name in targets:
        cpu, gpu = dfs["cpu", name], dfs["cuda", name]
        agree = float(np.mean([a[0] == b[0] for a, b in zip(cpu["description"],
                                                             gpu["description"])]))
        images = float(np.mean([a == b for a, b in zip(cpu["images"], gpu["images"])]))
        out[name] = {"units": len(cpu), "top1_agreement": agree, "top_images_identical": images}
        say(f"[zoo] card vs CPU, narrow {name} ({len(cpu)} units), 256 images at 64x64, "
            f"dissected by a narrow CLIP ViT, fp32, TF32 off: top-1 concept agreement "
            f"{agree:.4f}, identical top-image lists {images:.4f}")
        check(agree == 1.0, f"zoo card vs CPU ({name}): top-1 agreement {agree} < 1")
        check(images == 1.0, f"zoo card vs CPU ({name}): top images differ ({images})")

    x = probe.images[:32, :, :, :1]  # grayscale, broadcast to 3 channels by the towers
    for tower, geometry in (("swin", {"spec": {"embed": 32, "depths": [2, 2], "heads": [2, 4]}}),
                            ("vit", {"image_size": 64, "width": 128, "layers": 2, "heads": 2})):
        cfg = {"image_encoder": {"model_type": tower, "in_channels": 3, **geometry},
               "text_encoder": {}, "projection_head": {"proj_dim": 64}}
        emb = {dev: BreastClip.create(model_config=cfg, bert_layers=1, vocab_size=64, seed=5,
                                      device=dev).embed_images(x) for dev in ("cpu", "cuda")}
        err = float(np.abs(emb["cuda"] - emb["cpu"]).max())
        out[f"breastclip_{tower}_embed_max_abs_err"] = err
        say(f"[zoo] BreastClip with a narrow {tower} tower, 32 images at 64x64, fp32: card vs "
            f"CPU max abs err of the unit-norm embeddings {err:.3g} (tol 1e-4)")
        check(err <= 1e-4, f"BreastClip {tower} tower card vs CPU: max abs err {err}")
    return out


def phase_zoo(device, gdissect, c_dissect, pool):
    import torch

    rows = zoo_full_width(device, gdissect, c_dissect, pool)
    kernel1 = {name: wpmi_gdissect_shape(device, r["units"], gdissect["concepts"], 100,
                                         r["images"], label=name) for name, r in rows.items()}
    torch.cuda.empty_cache()
    agree = zoo_card_vs_cpu()
    return {"runs": rows, "kernel1": kernel1, "card_vs_cpu": agree}


# (k, H, W, Cin, Cexp, number of V2-S blocks of this shape, the previous fp32
# design's ms) at 1520x912: the 28 stride-1 expanded MBConv blocks of
# EfficientNetV2-S, kernel 2's V2 shapes; the last column as B5_SHAPES' last
V2_SHAPES = [
    (3, 95, 57, 128, 512, 5, 0.6455),      # blocks 11-15
    (3, 95, 57, 128, 768, 1, 0.9044),      # 16
    (3, 95, 57, 160, 960, 8, 1.3377),      # 17-24
    (3, 48, 29, 256, 1536, 14, 0.8061),    # 26-39
]
# one V2-S forward's 28 fp32 launches before the strip-walk redesign (the call of
# B5_SHAPES' last column)
V2_FP32_MMA_SYNC_FORWARD_MS = 26.119
V2_ARCH = "upmc_breast_clip_efficientnetv2-s_ft"
V2_UNITS = 24 * 2 + 48 * 4 + 64 * 4 + 128 * 6 + 160 * 9 + 256 * 15  # 6544, all 40 blocks
PT_BATCH, PT_TIMED_STEPS, PT_TEXT_LEN = 4, 10, 256  # pretraining: B5 + BERT at full width
BERT_VOCAB = 28996  # Bio_ClinicalBERT's word embedding rows
PT_CLI_ROWS = 8        # rows of the pretrain CLI's CSV (two PNGs each)


def v2_mbconv_rows(device):
    """(a): kernel 2 against its plain version at each V2-S MBConv shape at the
    C-dissect's batch, fp32 (tol 1e-4 + 1e-4|x|) and bf16 (the scales and 2e-3/2e-2
    of phase 4), each timed with its plain version and its bound (fp32 adds the
    fp32-FMA bound and the previous fp32 design's time to the printed line)."""
    import torch

    from mammodissect_torch.ops.cuda_mbconv import expand_dw_plain, fused_expand_dw

    rows = []
    for i, (k, h, w, cin, cexp, n_blocks, before_ms) in enumerate(V2_SHAPES):
        row = {"k": k, "H": h, "W": w, "Cin": cin, "Cexp": cexp, "blocks": n_blocks}
        fma_ms = mbconv_bound(MAIN_BATCH, h, w, cin, cexp, k, torch.float32)["fma_bound_ms"]
        for name, dtype, (atol, rtol) in (("fp32", torch.float32, (1e-4, 1e-4)),
                                          ("bf16", torch.bfloat16, (2e-3, 2e-2))):
            args = _mbconv_args(MAIN_BATCH, h, w, cin, cexp, k, dtype, device, seed=50 + i)
            got = fused_expand_dw(*args)[0].float()
            want = expand_dw_plain(*args)[0].float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            check(bool((err <= atol + rtol * want.abs()).all()),
                  f"kernel 2 {name} disagrees at the V2 shape {row}: max abs err {float(err.max())}")
            del got, want
            bound = mbconv_bound(MAIN_BATCH, h, w, cin, cexp, k, dtype)
            bound.pop("fma_bound_ms", None)
            row[name] = {"max_abs_err": float(err.max()),
                         "ms": cuda_ms(lambda: fused_expand_dw(*args), reps=3),
                         "plain_ms": cuda_ms(lambda: expand_dw_plain(*args), reps=1), **bound}
            del args, err
        rows.append(row)
        f = row["fp32"]
        say(f"[kernel 2 V2] k{k} {cin}->{cexp} @ {h}x{w} B={MAIN_BATCH} ({n_blocks} blocks): "
            f"fp32 {f['ms']:.4f} ms (mma.sync design {before_ms:.4f} ms), plain {f['plain_ms']:.3f} ms"
            f"{slower_than_plain(f)}, bound {f['bound_ms']:.4f} ms ({f['bound_by']}; fp32 FMAs "
            f"{fma_ms:.4f} ms), max abs err {f['max_abs_err']:.3g}; "
            f"bf16 {row['bf16']['ms']:.4f} ms, plain {row['bf16']['plain_ms']:.3f} ms, bound "
            f"{row['bf16']['bound_ms']:.4f} ms ({row['bf16']['bound_by']}), max abs err "
            f"{row['bf16']['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return rows


def v2_c_dissect(device, pool, c_dissect):
    """(a): the staged C-dissect of a V2-S classifier (fp32, all 40 blocks, random
    weights from seed 2) on phase 8's 512 mammograms, reading phase 8's dissector
    caches: 28 kernel-2 launches a batch, one kernel-1 launch."""
    import torch

    from mammodissect_torch.dissect.engine import DissectConfig, get_save_names

    work = tempfile.mkdtemp(prefix="chip_smoke_v2_")
    acts = os.path.join(work, "acts")
    os.makedirs(acts)
    # the target's cache names equal phase 8's B5 ones: link only the dissector's files
    _, clip_src, text_src = get_save_names("breastclip", "breastclip_classifier", "blocks.0",
                                           "synthetic_mammo", CONCEPTS, "avg",
                                           os.path.join(c_dissect["work"], "acts"))
    for src in (clip_src, text_src):
        check(os.path.exists(src), f"phase 8's dissector cache {src} is missing")
        os.symlink(src, os.path.join(acts, os.path.basename(src)))
    cfg = DissectConfig(target_model="breastclip_classifier", clip_model="breastclip",
                        target_layers=[f"blocks.{i}" for i in range(40)], d_probe="synthetic_mammo",
                        concept_set=CONCEPTS, batch_size=MAIN_BATCH, similarity_fn="soft_wpmi",
                        resident=False, device=device.type,
                        target_kwargs={"arch": V2_ARCH, "seed": 2}, activation_dir=acts,
                        result_dir=os.path.join(work, "results"))
    n_batches = -(-C_DISSECT_N // MAIN_BATCH)
    df, logs, wall, launches, peak = gdissect_run(cfg, CyclicProbe(pool, C_DISSECT_N))
    stages = stage_seconds(logs)
    check(len(df) == V2_UNITS, f"V2 C-dissect CSV has {len(df)} rows, expected {V2_UNITS}")
    check(np.isfinite(csv_similarities(df)).all(), "V2 C-dissect: non-finite similarities")
    check(any(l.startswith(f"[harvest] {C_DISSECT_N} images x 40 layers") for l in logs),
          f"V2 C-dissect did not harvest all 40 blocks: {logs}")
    check("[clip-img] probe embeddings cached, skipping" in logs
          and not {"dissector", "clip-txt", "clip-img"} & set(stages),
          f"V2 C-dissect did not read phase 8's dissector caches: {logs}")
    check(launches == {"mbconv": 28 * n_batches, "wpmi": 1},
          f"V2 C-dissect: launches {launches}, expected 28 x {n_batches} kernel-2 and 1 kernel-1")
    row = {"units": V2_UNITS, "images": C_DISSECT_N, "batch": MAIN_BATCH, "wall_s": wall,
           "img_per_s": C_DISSECT_N / wall, "harvest_s": stages.get("harvest"),
           "harvest_img_per_s": C_DISSECT_N / stages["harvest"], "stages_s": stages,
           "max_memory_allocated_bytes": peak, "launches": launches, "rows": len(df)}
    say(f"[v2 c-dissect] V2-S classifier fp32 x 40 blocks ({V2_UNITS} units), {C_DISSECT_N} "
        f"images at {IMAGE_HW[0]}x{IMAGE_HW[1]}, dissected by the bf16 breastclip from phase 8's "
        f"caches: {wall:.2f} s wall, {row['img_per_s']:.2f} img/s, harvest {row['harvest_s']:.2f} "
        f"s ({row['harvest_img_per_s']:.2f} img/s); stages {stages} s; peak {peak / 2**30:.2f} GiB; "
        f"launches {launches} (28 a batch of {MAIN_BATCH}); {len(df)} CSV rows, finite")
    torch.cuda.empty_cache()
    return row


def _pt_batches(pool, n, batch, seed):
    """n collated pretraining batches at full width on the u8 wire: images and image
    views from the pool, two report texts per image from the canonical prompts,
    WordPiece (toy vocab) to 256 tokens."""
    from mammodissect_torch.data.prompts import generate_report_from_labels
    from mammodissect_torch.models.tokenizers import WordPieceTokenizer

    with open(os.path.join(ROOT, "mammodissect", "assets", "dataset", "prompts.json")) as f:
        prompts = json.load(f)
    findings = sorted(prompts)
    tok = WordPieceTokenizer.toy()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.choice(len(pool), size=2 * batch, replace=False)
        texts = [generate_report_from_labels(
            [[findings[int(rng.integers(len(findings)))]], [], [], []], prompts, rng=rng)
            for _ in range(2 * batch)]
        t1, t2 = tok(texts[:batch], max_length=PT_TEXT_LEN), tok(texts[batch:], max_length=PT_TEXT_LEN)
        out.append({"images": pool[idx[:batch]], "image_views": pool[idx[batch:]],
                    "input_ids": t1["input_ids"], "attention_mask": t1["attention_mask"],
                    "input_ids2": t2["input_ids"], "attention_mask2": t2["attention_mask"]})
    return out, tok


def _profile_checkpoint(model, step, batch, device, top=8):
    """One pretraining step without and one with BERT's gradient checkpoint under
    torch.profiler: each step's device busy time (the union of its kernels'
    intervals) and kernel count, and the operators whose kernels the checkpoint
    adds most (self device time and calls of each operator, each kernel counted
    once, under the operator that launched it)."""
    import torch
    import torch.profiler as tp
    from torch.autograd import DeviceType

    from mammodissect_torch.train.clip_trainer import batch_to_device

    def self_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    runs = {}
    for checkpointed in (False, True):
        model.text_encoder.encoder.grad_checkpoint = checkpointed
        b = batch_to_device(batch, device)
        torch.cuda.synchronize()
        with tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]) as prof:
            step(b)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for lo, hi in spans:
            busy += max(hi - max(lo, end), 0.0)
            end = max(end, hi)
        ops = {e.key: (self_us(e) / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and self_us(e) > 0}
        runs[checkpointed] = {"busy_ms": busy / 1e3, "kernels": len(spans), "ops": ops}
    model.text_encoder.encoder.grad_checkpoint = False
    plain, ckpt = runs[False], runs[True]
    zero = (0.0, 0)
    delta = sorted(((ckpt["ops"].get(k, zero)[0] - plain["ops"].get(k, zero)[0],
                     ckpt["ops"].get(k, zero)[1] - plain["ops"].get(k, zero)[1], k)
                    for k in set(plain["ops"]) | set(ckpt["ops"])), reverse=True)[:top]
    out = {"plain_busy_ms": plain["busy_ms"], "checkpoint_busy_ms": ckpt["busy_ms"],
           "plain_kernels": plain["kernels"], "checkpoint_kernels": ckpt["kernels"],
           "added_ops": [{"op": k, "added_ms": d, "added_calls": n} for d, n, k in delta]}
    say(f"[pretrain profile] one step, BERT checkpoint off/on: device busy "
        f"{plain['busy_ms']:.2f} / {ckpt['busy_ms']:.2f} ms, {plain['kernels']} / "
        f"{ckpt['kernels']} kernels; operators whose kernels the checkpoint adds most: "
        + "; ".join(f"{o['op']} +{o['added_ms']:.3f} ms (+{o['added_calls']} calls)"
                    for o in out["added_ops"]))
    return out


def pretrain_steps(device, pool):
    """(b): timed contrastive pretraining steps at full width: B5 + 12-layer BERT with
    Bio_ClinicalBERT's 28996-token vocab (the toy WordPiece ids index into it) at
    1520x912, bf16 compute over fp32 weights, the second text view and the image view
    (8 image-tower passes a step at batch 4), without and with BERT's gradient
    checkpoint; one step of each profiled; then batch 8 once, to learn whether it
    fits."""
    import torch

    from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum
    from mammodissect_torch.train.clip_trainer import batch_to_device, make_clip_train_step
    from mammodissect_torch.device import resolve_dtype
    from mammodissect_torch.models.breastclip import BreastClip, default_model_config
    from mammodissect_torch.train.pretrain import PretrainConfig
    from mammodissect_torch.train.trainer import make_optimizer

    batches, tok = _pt_batches(pool, 2 + PT_TIMED_STEPS, PT_BATCH, seed=13)
    cfg = PretrainConfig(device=device.type)
    t0 = time.perf_counter()
    # `train.pretrain.build_clip`'s model, with the word embedding sized to
    # Bio_ClinicalBERT's vocab rather than the toy tokenizer's
    model_config = default_model_config()
    model_config["image_encoder"]["variant"] = cfg.image_variant
    model = BreastClip.create(model_config=model_config, tokenizer=tok, seed=cfg.seed,
                              bert_layers=cfg.bert_layers, vocab_size=BERT_VOCAB,
                              dtype=resolve_dtype(cfg.dtype), param_dtype=torch.float32,
                              device=device).module
    build_s = time.perf_counter() - t0
    optimizer, scheduler = make_optimizer(model, 5e-5, 1e-4, 100, 1000)
    step = make_clip_train_step(model, optimizer, scheduler, input_wire="u8",
                                norm_mean=0.3089279, norm_std=0.25053555,
                                generator=torch.Generator(device=device).manual_seed(14))
    last = len(model.text_encoder.encoder.layer) - 1
    watched = ("image_encoder._conv_stem.weight", "image_encoder._blocks.20._bn1.running_var",
               f"text_encoder.encoder.layer.{last}.output.dense.weight", "logit_scale",
               "image_projection.projection.weight")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}

    def run(bs, checkpointed):
        model.text_encoder.encoder.grad_checkpoint = checkpointed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_expand_dw.launches = 0
        soft_wpmi_gather_logsum.launches = 0
        bn_epilogue.launches = 0
        losses = [float(step(batch_to_device(b, device))) for b in bs[:2]]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses += [step(batch_to_device(b, device)) for b in bs[2:]]
        end.record()
        torch.cuda.synchronize()
        losses = [float(l) for l in losses]
        n = len(bs) - 2
        return {"batch": len(bs[0]["images"]), "bert_checkpoint": checkpointed,
                "ms_per_step": start.elapsed_time(end) / n,
                "img_per_s": 2 * len(bs[0]["images"]) * n * 1e3 / start.elapsed_time(end),
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "losses": losses,
                "launches": {"mbconv": fused_expand_dw.launches,
                             "wpmi": soft_wpmi_gather_logsum.launches,
                             "bn_epilogue": bn_epilogue.launches}}

    # in turns: plain, checkpoint, checkpoint, plain
    turns = [run(batches, ckpt) for ckpt in (False, True, True, False)]
    rows = {"plain": turns[0], "bert_checkpoint": turns[1],
            "bert_checkpoint_again": turns[2], "plain_again": turns[3]}
    state = model.state_dict()
    unchanged = [k for k in watched if torch.equal(state[k], before[k])]
    check(not unchanged, f"pretraining: unchanged after the steps: {unchanged}")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "pretraining: parameters are not float32")
    for name, r in rows.items():
        check(bool(np.isfinite(r["losses"]).all()), f"pretraining ({name}): losses {r['losses']}")
        check(r["launches"] == {"mbconv": 0, "wpmi": 0, "bn_epilogue": 0},
              f"pretraining ({name}): kernel launches {r['launches']} in train steps")
        say(f"[pretrain] B5 + 12-layer BERT at {IMAGE_HW[0]}x{IMAGE_HW[1]}, batch {r['batch']} "
            f"(+ image views: {2 * r['batch']} tower passes a step), {PT_TEXT_LEN} tokens x 2 "
            f"texts, bf16 over fp32 weights, BERT checkpoint {r['bert_checkpoint']}: "
            f"{r['ms_per_step']:.2f} ms a step ({r['img_per_s']:.2f} tower images/s) over "
            f"{PT_TIMED_STEPS} timed steps, peak {r['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
            f"losses {[round(l, 4) for l in r['losses']]}; launches {r['launches']}")
    rows["profile"] = _profile_checkpoint(model, step, batches[0], device)
    del batches
    big, _ = _pt_batches(pool, 3, 2 * PT_BATCH, seed=15)
    try:
        rows["batch8"] = run(big, False)
        rows["batch8"]["fits"] = True
        say(f"[pretrain] batch {2 * PT_BATCH}: fits, {rows['batch8']['ms_per_step']:.2f} ms a step "
            f"(1 timed), peak {rows['batch8']['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    except torch.cuda.OutOfMemoryError:
        rows["batch8"] = {"batch": 2 * PT_BATCH, "fits": False,
                          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        say(f"[pretrain] batch {2 * PT_BATCH}: out of memory (peak before the failure "
            f"{rows['batch8']['max_memory_allocated_bytes'] / 2**30:.2f} GiB)")
    optimizer.zero_grad(set_to_none=True)
    del model, optimizer, step, big
    torch.cuda.empty_cache()
    rows["build_s"] = build_s
    return rows


def pretrain_cli(device, png_root):
    """(c): `cli.pretrain` for one short epoch on phase 10's mammogram PNGs with a
    generated CSV of *_FINDING labels (the default prompts.json), batch 4; its
    `final.pth` then builds the breastclip dissector."""
    import contextlib
    import io

    import pandas as pd
    import torch

    from mammodissect_torch.cli.pretrain import main as pretrain_main
    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum
    from mammodissect_torch.train.checkpoints import load_checkpoint

    work = tempfile.mkdtemp(prefix="chip_smoke_pt_")
    findings = ["Mass", "Suspicious Calcification", "No Finding", "Focal Asymmetry"]
    rows = [{"view": "['CC', 'MLO']", "CC": f"['m{2 * i}.png']", "MLO": f"['m{2 * i + 1}.png']",
             "CC_FINDING": str([[findings[i % 4]], [], [], []]),
             "MLO_FINDING": str([[], [findings[(i + 1) % 4]], [], []])} for i in range(PT_CLI_ROWS)]
    pd.DataFrame(rows).to_csv(os.path.join(work, "pretrain.csv"), index=False)
    argv = ["--csv-file", os.path.join(work, "pretrain.csv"), "--root", png_root, "--epochs", "1",
            "--batch-size", str(PT_BATCH), "--warmup-steps", "1",
            "--img-size", str(IMAGE_HW[0]), str(IMAGE_HW[1]),
            "--checkpoints", os.path.join(work, "ck"), "--device", device.type]
    out = io.StringIO()
    cwd = os.getcwd()
    fused_expand_dw.launches = 0
    soft_wpmi_gather_logsum.launches = 0
    t0 = time.perf_counter()
    os.chdir(work)  # the CLI's tensorboard directory is relative to the working directory
    try:
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = pretrain_main(argv)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mbconv": fused_expand_dw.launches, "wpmi": soft_wpmi_gather_logsum.launches}
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    steps = PT_CLI_ROWS // PT_BATCH
    check(rc == 0 and result["steps"] == steps and np.isfinite(result["last_loss"]),
          f"cli.pretrain: rc {rc}, result {result}")
    check(launches == {"mbconv": 0, "wpmi": 0}, f"cli.pretrain launched kernels: {launches}")
    saved = load_checkpoint(result["final_checkpoint"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy WordPiece vocab
        dissector = get_dissector("breastclip", ckpt_path=result["final_checkpoint"],
                                  device=device.type, dtype="float32", bert_layers=12)
    state = dissector.module.state_dict()
    check(set(state) == set(saved["model"])
          and all(torch.equal(state[k].cpu(), v) for k, v in saved["model"].items()),
          "the dissector built from final.pth differs from the checkpoint")
    u8 = _pngs_u8(png_root, 4)
    emb = dissector.embed_images_u8(u8, 0.3089279, 0.25053555)
    check(emb.shape == (len(u8), 512) and np.isfinite(emb).all(),
          "the dissector from final.pth gave no finite embeddings")
    row = {"rows": PT_CLI_ROWS, "steps": result["steps"], "last_loss": result["last_loss"],
           "wall_s": wall, "launches": launches,
           "checkpoint_bytes": os.path.getsize(result["final_checkpoint"])}
    say(f"[pretrain] cli.pretrain, {PT_CLI_ROWS} rows x 2 PNGs at {IMAGE_HW[0]}x{IMAGE_HW[1]}, "
        f"batch {PT_BATCH}, one epoch: {result['steps']} steps, last loss "
        f"{result['last_loss']:.4f}, {wall:.2f} s wall (model build and host loading "
        f"included); final.pth ({row['checkpoint_bytes']} bytes) built the breastclip "
        f"dissector with equal weights, finite embeddings; launches {launches}")
    del dissector
    torch.cuda.empty_cache()
    return row


def _pngs_u8(png_root, n):
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(png_root, f"m{i}.png")))[..., None]
                     for i in range(n)])


def pretrain_and_v2_card_vs_cpu():
    """(d): three narrow fp32 pretraining steps (efficientnet-test, 2-layer BERT, both
    second views, u8 wire; the shift-invariant BatchNorm and key biases frozen) on the
    card and on the CPU: losses within 1e-4 relative, every weight and statistic within
    1e-5 + 1e-3 of its tensor's largest entry but for at most 1e-4 of the entries
    (gradients of rounding noise, which Adam turns into +-lr steps), all within 6 lr;
    and a V2-S tower (fp32, eval) at 64x64 on both: 28 kernel-2 launches on the card,
    each of the 40 blocks within 1e-4 of the largest entry."""
    import torch

    from mammodissect_torch.models.breastclip import BreastClipModule
    from mammodissect_torch.models.efficientnet import EfficientNet
    from mammodissect_torch.models.layers import init_weights
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
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
        losses = [float(step(batch_to_device(b, torch.device(dev)))) for b in batches]
        runs[dev] = ({k: v.cpu() for k, v in model.state_dict().items()}, losses)
    (cpu, cpu_losses), (gpu, gpu_losses) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
    outside = total = 0
    worst = 0.0
    for k, v in cpu.items():
        if v.is_floating_point():
            err = (gpu[k] - v).abs()
            outside += int((err > 1e-5 + 1e-3 * float(v.abs().max())).sum())
            total += v.numel()
            worst = max(worst, float(err.max()))
    check(loss_err <= 1e-4, f"pretrain card vs CPU: losses {gpu_losses} vs {cpu_losses}")
    check(outside <= 1e-4 * total and worst <= 6e-3,
          f"pretrain card vs CPU: {outside} of {total} entries outside the tolerance, worst {worst}")
    say(f"[pretrain] card vs CPU, 3 narrow fp32 steps (TF32 off): losses "
        f"{[round(l, 6) for l in gpu_losses]} vs {[round(l, 6) for l in cpu_losses]} (max rel err "
        f"{loss_err:.3g}, tol 1e-4); {outside} of {total} entries outside 1e-5 + 1e-3 max|x| "
        f"(tol 1e-4 of them), largest difference {worst:.3g} (tol 6 lr = 6e-3)")

    tower = EfficientNet("efficientnetv2-s", in_channels=3)
    init_weights(tower, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 64, 64, 1)).astype(np.float32))
    caps = {}
    for dev in ("cpu", "cuda"):
        m = tower.to(dev).eval()
        fused_expand_dw.launches = 0
        with torch.no_grad():
            _, captured = m(x.to(dev), capture=tuple(range(40)))
        caps[dev] = ({k: v.cpu() for k, v in captured.items()}, fused_expand_dw.launches)
    errs = {k: float((caps["cuda"][0][k] - v).abs().max() / v.abs().max())
            for k, v in caps["cpu"][0].items()}
    v2_worst = max(errs, key=errs.get)
    check(caps["cuda"][1] == 28 and caps["cpu"][1] == 0,
          f"V2 tower: kernel-2 launches card {caps['cuda'][1]}, CPU {caps['cpu'][1]}")
    check(len(errs) == 40 and errs[v2_worst] <= 1e-4,
          f"V2 tower card vs CPU: {v2_worst} at {errs[v2_worst]:.3g} of the largest entry")
    say(f"[v2] V2-S tower fp32 at 64x64 card vs CPU: 40 blocks within {errs[v2_worst]:.3g} of "
        f"the largest entry (tol 1e-4; worst {v2_worst}); kernel 2 launched 28 times on the card")
    return {"pretrain_loss_max_rel_err": loss_err, "pretrain_entries_outside": outside,
            "pretrain_entries": total, "pretrain_worst_abs_err": worst,
            "v2_max_rel_err": errs[v2_worst], "v2_worst": v2_worst}


def phase_v2_pretrain(device, pool, c_dissect, png_root):
    """Phase 13: the rest of the EfficientNet family and contrastive pretraining."""
    import torch

    from mammodissect_torch.dissect.engine import read_concepts

    c_v2 = v2_c_dissect(device, pool, c_dissect)
    kernel1 = wpmi_gdissect_shape(device, V2_UNITS, len(read_concepts(CONCEPTS)), 100,
                                  C_DISSECT_N, label="V2 C-dissect")
    shapes = v2_mbconv_rows(device)
    per_forward = {d: {key: sum(r[d][key] * r["blocks"] for r in shapes)
                       for key in ("ms", "plain_ms", "bound_ms")} for d in ("fp32", "bf16")}
    for d, f in per_forward.items():
        before = (f" against {V2_FP32_MMA_SYNC_FORWARD_MS} ms before the strip-walk redesign"
                  if d == "fp32" else "")
        fma = f"; fp32 FMAs {fma_forward_ms(shapes):.3f} ms" if d == "fp32" else ""
        say(f"[kernel 2 V2] one V2-S forward's 28 launches at batch {MAIN_BATCH}, {d}: "
            f"{f['ms']:.3f} ms{before}, plain {f['plain_ms']:.3f} ms, bound "
            f"{f['bound_ms']:.3f} ms{fma}")
    pt = pretrain_steps(device, pool)
    cli = pretrain_cli(device, png_root)
    torch.cuda.empty_cache()
    agree = pretrain_and_v2_card_vs_cpu()
    return {"c_dissect_v2": c_v2, "kernel1": kernel1, "v2_shapes": shapes,
            "v2_forward": per_forward, "pretrain": pt, "pretrain_cli": cli,
            "card_vs_cpu": agree}


# ------------------------------------------------------------------ phase 14
PAR_N = 250            # images of the two-rank resident M-dissect (odd: wrap padding, trim)
PAR_NCCL_N = 64        # images of the one-rank NCCL run
PAR_FT_ROWS = 4        # fine-tune rows a rank (global batch 8)
PAR_PT_BATCH = 4       # pretraining's global batch (model_parallel 2: every rank all 4)
PAR_BF16_LOSS_TOL = 2e-2  # ~5 units of bf16 rounding (2**-8) on the first step's loss
PAR_TIMEOUT_S = 420    # shared by the spawned ranks of one run


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(world, backend, work, task):
    """Run `world` copies of this script as the ranks of one process group (each its
    own process and CUDA context, `--rank` arguments, the topology in the environment
    torchrun would set), within one shared timeout; a rank that fails or hangs fails
    the phase (the others are killed). Returns each rank's results."""
    import torch

    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(work, f"{task}_rank{r}.log"), "w")
        logs.append(log)
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--backend", backend,
             "--work", work, "--task", task],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"{task}_rank{r}.log")) as f:
            text = f.read()
        check(p.returncode == 0, f"{task} rank {r} of {world} failed (rc {p.returncode}):\n"
              f"{text[-6000:]}")
    return [torch.load(os.path.join(work, f"{task}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def par_dissect(device, pool, n, work, dissector=None):
    """The resident M-dissect at full width on `n` probe images (run_dissection), the
    kernels' counts zeroed just before and read just after; under a process group each
    rank harvests its shard. Returns the frame, the CSV path and the counts."""
    import torch
    import torch.distributed as dist

    from mammodissect_torch.dissect.engine import run_dissection
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum

    if dissector is None:
        dissector, _ = flagship_dissector(device)
    cfg = resident_cfg(work, device)
    torch.cuda.synchronize()
    if dist.is_initialized():
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    fused_expand_dw.launches = 0
    soft_wpmi_gather_logsum.launches = 0
    t0 = time.perf_counter()
    df, csv_path = run_dissection(cfg, probe=CyclicProbe(pool, n), dissector=dissector,
                                  log=lambda *_: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mbconv": fused_expand_dw.launches, "wpmi": soft_wpmi_gather_logsum.launches}
    return {"df": df.to_dict("list"), "csv_path": csv_path, "wall_s": wall, "launches": launches,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def _pt_single_batch(pool):
    """The global pretraining batch of phase 14 (images and two text views' first, no
    image views: two ranks of the whole batch share one card's memory)."""
    batches, tok = _pt_batches(pool, 3, PAR_PT_BATCH, seed=21)
    keep = ("images", "input_ids", "attention_mask")
    return [{k: b[k] for k in keep} for b in batches], tok


def _pt_model(device, tok):
    """B5 + 12-layer BERT with the 28996-row word embedding, bf16 over fp32 weights,
    weights from the pretraining config's seed."""
    import torch

    from mammodissect_torch.device import resolve_dtype
    from mammodissect_torch.models.breastclip import BreastClip, default_model_config
    from mammodissect_torch.train.pretrain import PretrainConfig

    cfg = PretrainConfig(device=device.type)
    model_config = default_model_config()
    model_config["image_encoder"]["variant"] = cfg.image_variant
    return BreastClip.create(model_config=model_config, tokenizer=tok, seed=cfg.seed,
                             bert_layers=cfg.bert_layers, vocab_size=BERT_VOCAB,
                             dtype=resolve_dtype(cfg.dtype), param_dtype=torch.float32,
                             device=device).module


def par_pretrain(device, pool, mesh=None):
    """Three contrastive steps (the first's loss compared; steps 2-3 timed) of the
    full-width model, tensor-parallel when `mesh` is given (BERT and the heads split
    over its model axis, `apply_tensor_parallel`)."""
    import torch

    from mammodissect_torch.parallel.sharding import apply_tensor_parallel, full_state_dict
    from mammodissect_torch.train.clip_trainer import batch_to_device, make_clip_train_step
    from mammodissect_torch.train.trainer import make_optimizer

    batches, tok = _pt_single_batch(pool)
    model = _pt_model(device, tok)
    plan = apply_tensor_parallel(model, mesh) if mesh is not None else {}
    optimizer, scheduler = make_optimizer(model, 5e-5, 1e-4, 100, 1000)
    step = make_clip_train_step(model, optimizer, scheduler, input_wire="u8",
                                norm_mean=0.3089279, norm_std=0.25053555,
                                generator=torch.Generator(device=device).manual_seed(22),
                                mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(batch_to_device(batches[0], device)))]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [step(batch_to_device(b, device)) for b in batches[1:]]
    end.record()
    torch.cuda.synchronize()
    row = {"losses": [float(l) for l in losses],
           "ms_per_step": start.elapsed_time(end) / (len(batches) - 1),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "split_params": len(plan)}
    if mesh is not None:
        whole = full_state_dict(model)
        row["whole_word_embedding"] = tuple(
            whole["text_encoder.embeddings.word_embeddings.weight"].shape)
        row["local_word_embedding"] = tuple(
            model.text_encoder.embeddings.word_embeddings.weight.shape)
    optimizer.zero_grad(set_to_none=True)
    del model, optimizer, step
    torch.cuda.empty_cache()
    return row


def par_finetune(device, pool, rank, world):
    """Three data-parallel steps of the B5 classifier at full width (bf16, u8 wire):
    this rank's PAR_FT_ROWS of each global batch of 8; then an eval batch through
    kernel 2 and gather_predictions. Steps 2-3 timed."""
    import torch

    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.parallel.collectives import all_gather
    from mammodissect_torch.parallel.multihost import gather_predictions
    from mammodissect_torch.train.experiments import FinetuneConfig

    cfg = FinetuneConfig(seed=3, device=device.type)  # B5, bf16, u8
    trainer = _ft_trainer(cfg, device)
    batches = _ft_batches(pool, 3, seed=4)
    sl = slice(rank * PAR_FT_ROWS, (rank + 1) * PAR_FT_ROWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_expand_dw.launches = 0
    losses = [trainer.train_batch(batches[0][0][sl], batches[0][1][sl])]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [trainer.train_batch(u8[sl], y[sl]) for u8, y in batches[1:]]
    end.record()
    torch.cuda.synchronize()
    train_launches = fused_expand_dw.launches
    peak = torch.cuda.max_memory_allocated()
    u8, y = _ft_batches(pool, 1, seed=5)[0]
    fused_expand_dw.launches = 0
    _, local = trainer.eval_batch(u8[sl], y[sl])
    eval_launches = fused_expand_dw.launches
    preds = gather_predictions(local, FT_BATCH)
    stats = torch.stack([v.float().sum() for k, v in trainer.model.state_dict().items()
                         if k.endswith(("running_mean", "running_var", "weight"))])
    same = all_gather(stats[None]).cpu()
    check(bool((same == same[0]).all()), "DP fine-tune: the ranks' weights or statistics differ")
    row = {"losses": losses, "ms_per_step": start.elapsed_time(end) / 2,
           "max_memory_allocated_bytes": peak, "train_launches": train_launches,
           "eval_launches": eval_launches, "predictions": preds.tolist()}
    del trainer
    torch.cuda.empty_cache()
    return row


def par_card_vs_cpu(rank, world):
    """(c): narrow data- and tensor-parallel steps of this rank group on the card and
    on the CPU (gloo takes both): three fp32 DP fine-tune steps of t_test_ft at 64x48
    (this rank's half of each batch of 8) and one TP (1, 2) pretraining step of a
    narrow BreastClip; the tolerances of phases 10d and 13d."""
    import torch

    from mammodissect_torch.models.breastclip import BreastClipModule
    from mammodissect_torch.models.layers import init_weights
    from mammodissect_torch.parallel.mesh import make_mesh
    from mammodissect_torch.parallel.sharding import apply_tensor_parallel, full_state_dict
    from mammodissect_torch.train.clip_trainer import batch_to_device, make_clip_train_step
    from mammodissect_torch.train.experiments import FinetuneConfig
    from mammodissect_torch.train.trainer import make_optimizer

    cfg = FinetuneConfig(arch="t_test_ft", img_size=(64, 48), dtype="float32", pad_mode="same",
                         bn_momentum=0.9, lr=1e-3, seed=8)
    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 256, size=(FT_BATCH, 64, 48, 1), dtype=np.uint8),
                (rng.random(FT_BATCH) < 0.5).astype(np.float32), n) for n in (8, 8, 5)]
    half = FT_BATCH // world
    sl = slice(rank * half, (rank + 1) * half)
    ft = {}
    for dev in ("cpu", "cuda"):
        tr = _ft_trainer(cfg, torch.device(dev), warmup_steps=1, total_steps=10,
                         shift_invariant_frozen=True)
        losses = [tr.train_batch(u8[sl], y[sl], min(max(n - rank * half, 0), half))
                  for u8, y, n in batches]
        ft[dev] = ({k: v.cpu().clone() for k, v in tr.model.state_dict().items()}, losses)
    (cpu, cpu_l), (gpu, gpu_l) = ft["cpu"], ft["cuda"]
    ft_loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_l, cpu_l))
    ratio = {k: float((gpu[k] - v).abs().max() / (1e-5 + 1e-3 * v.abs().max()))
             for k, v in cpu.items() if v.is_floating_point()}
    ft_worst = max(ratio, key=ratio.get)
    check(ft_loss_err <= 1e-4, f"DP fine-tune card vs CPU: losses {gpu_l} vs {cpu_l}")
    check(ratio[ft_worst] <= 1.0,
          f"DP fine-tune card vs CPU: {ft_worst} is {ratio[ft_worst]:.3g} x its tolerance")

    narrow = dict(image_variant="efficientnet-test", bert_layers=2, bert_hidden=64,
                  bert_heads=2, bert_intermediate=128, proj_dim=32, vocab_size=64)
    base = BreastClipModule(**narrow)
    init_weights(base, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    batch = {"images": rng.integers(0, 256, (6, 64, 48, 1), dtype=np.uint8),
             "image_views": rng.integers(0, 256, (6, 64, 48, 1), dtype=np.uint8),
             "input_ids": rng.integers(5, 64, (6, 12)), "attention_mask": np.ones((6, 12)),
             "input_ids2": rng.integers(5, 64, (6, 12)), "attention_mask2": np.ones((6, 12))}
    mesh = make_mesh(model_parallel=world)
    tp = {}
    for dev in ("cpu", "cuda"):
        model = BreastClipModule(**narrow)
        model.load_state_dict(base.state_dict())
        model.to(dev)
        apply_tensor_parallel(model, mesh)
        labels = {k: "frozen" if k.endswith(("_bn2.bias", "attention.self.key.bias")) else "train"
                  for k, _ in model.named_parameters()}
        optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 1, 10, param_labels=labels)
        step = make_clip_train_step(model, optimizer, scheduler, input_wire="u8",
                                    norm_mean=0.3, norm_std=0.25, mesh=mesh)
        loss = float(step(batch_to_device(batch, torch.device(dev))))
        tp[dev] = ({k: v.cpu() for k, v in full_state_dict(model).items()}, loss)
    (cpu, cpu_loss), (gpu, gpu_loss) = tp["cpu"], tp["cuda"]
    tp_loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    outside = total = 0
    tp_worst = 0.0
    for k, v in cpu.items():
        if v.is_floating_point():
            err = (gpu[k] - v).abs()
            outside += int((err > 1e-5 + 1e-3 * float(v.abs().max())).sum())
            total += v.numel()
            tp_worst = max(tp_worst, float(err.max()))
    check(tp_loss_err <= 1e-4, f"TP pretrain card vs CPU: loss {gpu_loss} vs {cpu_loss}")
    check(outside <= 1e-4 * total and tp_worst <= 6e-3,
          f"TP pretrain card vs CPU: {outside} of {total} entries outside the tolerance, "
          f"worst {tp_worst}")
    return {"ft_loss_max_rel_err": ft_loss_err, "ft_worst_share_of_tol": ratio[ft_worst],
            "ft_worst": ft_worst, "tp_loss_rel_err": tp_loss_err, "tp_entries_outside": outside,
            "tp_entries": total, "tp_worst_abs_err": tp_worst}


def rank_main(argv):
    """One spawned rank of phase 14 (`--rank r --backend b --work dir --task gloo|nccl`,
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT in the environment, as
    torchrun sets them): its results go to <work>/<task>_rank<r>.pt."""
    import argparse

    import torch
    import torch.distributed as dist

    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    for flag in ("--backend", "--work", "--task"):
        p.add_argument(flag, required=True)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from mammodissect_torch.device import set_fp32_policy
    from mammodissect_torch.parallel.multihost import initialize

    # the torchrun path: the topology from the environment, at any world size
    check(initialize(backend=a.backend, device="cuda"), "no process group started")
    world = dist.get_world_size()
    set_fp32_policy()
    torch.set_num_threads(max((os.cpu_count() or 2) // world, 1))  # the ranks share the host
    device = torch.device("cuda", torch.cuda.current_device())
    pool = np.load(os.path.join(a.work, "pool.npy"))
    t0 = time.perf_counter()
    out = {"part_s": {}}

    def part(name, fn, *args, **kw):
        t = time.perf_counter()
        out[name] = fn(*args, **kw)
        out["part_s"][name] = time.perf_counter() - t
        torch.cuda.empty_cache()

    if a.task == "nccl":
        part("dissect", par_dissect, device, pool, PAR_NCCL_N, os.path.join(a.work, "nccl"))
    else:
        from mammodissect_torch.parallel.mesh import make_mesh

        part("dissect", par_dissect, device, pool, PAR_N, os.path.join(a.work, "gloo"))
        part("finetune", par_finetune, device, pool, a.rank, world)
        part("pretrain", par_pretrain, device, pool, mesh=make_mesh(model_parallel=world))
        part("card_vs_cpu", par_card_vs_cpu, a.rank, world)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(a.work, f"{a.task}_rank{a.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_parallel(device, pool):
    """Phase 14: the data- and tensor-parallel paths. The single-process references
    first (resident M-dissect on PAR_N and PAR_NCCL_N images, the first pretraining
    step), then (a) and (c) on two gloo ranks sharing the card, then (b) on one NCCL
    rank."""
    import pandas as pd
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_par_")
    np.save(os.path.join(work, "pool.npy"), pool)
    t_start = time.perf_counter()
    dissector, _ = flagship_dissector(device)
    single = par_dissect(device, pool, PAR_N, os.path.join(work, "single"), dissector)
    single_64 = par_dissect(device, pool, PAR_NCCL_N, os.path.join(work, "single64"), dissector)
    del dissector
    torch.cuda.empty_cache()
    pt_single = par_pretrain(device, pool)
    ref_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    ranks = spawn_ranks(2, "gloo", work, "gloo")
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = spawn_ranks(1, "nccl", work, "nccl")
    nccl_s = time.perf_counter() - t0

    # (a) 1: the resident M-dissect over two ranks against the single process
    per_rank = -(-PAR_N // 2)
    n_batches = -(-per_rank // MAIN_BATCH)
    frames = [r["dissect"]["df"] for r in ranks]
    check(frames[0] == frames[1], "the two ranks scored different rows")
    check(ranks[1]["dissect"]["csv_path"] is None, "a rank other than the first wrote the CSV")
    for r, res in enumerate(ranks):
        check(res["dissect"]["launches"] == {"mbconv": 32 * n_batches, "wpmi": 1},
              f"rank {r} launches {res['dissect']['launches']}, expected "
              f"{{'mbconv': {32 * n_batches}, 'wpmi': 1}}")
    got = pd.read_csv(ranks[0]["dissect"]["csv_path"])
    want = pd.read_csv(single["csv_path"])
    top1 = np.mean([ast.literal_eval(a)[0] == ast.literal_eval(b)[0]
                    for a, b in zip(got["description"], want["description"])])
    same_images = float(np.mean(got["images"] == want["images"]))
    sims = csv_similarities(got)
    check(len(got) == 6992 and np.isfinite(sims).all(), "two-rank CSV: rows or similarities")
    check(top1 >= 0.99, f"two-rank top-1 agreement with the single process {top1:.4f} < 0.99")
    wall_2 = max(r["dissect"]["wall_s"] for r in ranks)

    # (b): one NCCL rank writes the single process's CSV
    n64 = pd.read_csv(nccl["dissect"]["csv_path"])
    w64 = pd.read_csv(single_64["csv_path"])
    identical = all(list(n64[c]) == list(w64[c]) for c in ("layer", "unit", "description",
                                                             "similarity", "images"))
    check(identical, "the one-rank NCCL CSV differs from the single-process CSV")
    n64_batches = -(-PAR_NCCL_N // MAIN_BATCH)
    check(nccl["dissect"]["launches"] == {"mbconv": 32 * n64_batches, "wpmi": 1},
          f"NCCL rank launches {nccl['dissect']['launches']}")

    # (a) 2: DP fine-tune
    fts = [r["finetune"] for r in ranks]
    check(fts[0]["losses"] == fts[1]["losses"] and np.isfinite(fts[0]["losses"]).all(),
          f"DP fine-tune losses {[f['losses'] for f in fts]}")
    check(all(f["train_launches"] == 0 and f["eval_launches"] == 32 for f in fts),
          f"DP fine-tune kernel-2 launches {[(f['train_launches'], f['eval_launches']) for f in fts]}")
    check(fts[0]["predictions"] == fts[1]["predictions"] and len(fts[0]["predictions"]) == FT_BATCH
          and np.isfinite(fts[0]["predictions"]).all(), "DP eval predictions")

    # (a) 3: DP + TP pretraining step against the single process's
    pts = [r["pretrain"] for r in ranks]
    loss_err = abs(pts[0]["losses"][0] - pt_single["losses"][0]) / abs(pt_single["losses"][0])
    check(pts[0]["losses"] == pts[1]["losses"] and np.isfinite(pts[0]["losses"]).all(),
          f"TP pretraining losses {[p['losses'] for p in pts]}")
    check(loss_err <= PAR_BF16_LOSS_TOL,
          f"TP pretraining first loss {pts[0]['losses'][0]} vs single {pt_single['losses'][0]}")
    check(pts[0]["whole_word_embedding"] == (BERT_VOCAB, 768)
          and pts[0]["local_word_embedding"] == (BERT_VOCAB // 2, 768),
          f"TP word embedding {pts[0]['local_word_embedding']} of {pts[0]['whole_word_embedding']}")
    cvc = ranks[0]["card_vs_cpu"]

    gib = 2 ** 30
    say(f"[parallel] references (single process: dissector build, {PAR_N} + {PAR_NCCL_N} "
        f"images, pretraining steps) {ref_s:.1f} s; two gloo ranks {gloo_s:.1f} s (rank 0's "
        f"parts { {k: round(v, 1) for k, v in ranks[0]['part_s'].items()} } s of "
        f"{ranks[0]['seconds']:.1f}); one NCCL rank {nccl_s:.1f} s (its dissection "
        f"{nccl['part_s']['dissect']:.1f} s)")
    say(f"[parallel] (a) resident M-dissect, {PAR_N} images, B5 x 39 blocks at "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]}, bf16, 12-layer BERT, 762 concepts: two gloo ranks sharing "
        f"the card {wall_2:.2f} s ({PAR_N / wall_2:.2f} img/s), single process "
        f"{single['wall_s']:.2f} s ({PAR_N / single['wall_s']:.2f} img/s); top-1 agreement "
        f"{top1:.4f}, identical top images {same_images:.4f}; launches a rank "
        f"{ranks[0]['dissect']['launches']} ({n_batches} batches of {MAIN_BATCH}); peak a rank "
        f"{[round(r['dissect']['max_memory_allocated_bytes'] / gib, 2) for r in ranks]} GiB")
    say(f"[parallel] (a) DP fine-tune, B5 at {IMAGE_HW[0]}x{IMAGE_HW[1]}, global batch 8 "
        f"({PAR_FT_ROWS} a rank), bf16: {[round(f['ms_per_step'], 2) for f in fts]} ms a step "
        f"(2 timed), losses {[round(l, 4) for l in fts[0]['losses']]}, peak "
        f"{[round(f['max_memory_allocated_bytes'] / gib, 2) for f in fts]} GiB; eval launches "
        f"kernel 2 {fts[0]['eval_launches']} times a rank, {len(fts[0]['predictions'])} "
        f"predictions gathered")
    say(f"[parallel] (a) DP + TP (1, 2) pretraining, B5 + 12-layer BERT ({BERT_VOCAB}-row vocab, "
        f"{pts[0]['local_word_embedding'][0]} a rank), global batch {PAR_PT_BATCH}, bf16: "
        f"{[round(p['ms_per_step'], 2) for p in pts]} ms a step (2 timed) vs single "
        f"{pt_single['ms_per_step']:.2f}; first loss {pts[0]['losses'][0]:.6f} vs single "
        f"{pt_single['losses'][0]:.6f} (rel err {loss_err:.3g}, tol {PAR_BF16_LOSS_TOL}); peak "
        f"{[round(p['max_memory_allocated_bytes'] / gib, 2) for p in pts]} GiB vs single "
        f"{pt_single['max_memory_allocated_bytes'] / gib:.2f} GiB; {pts[0]['split_params']} "
        f"parameters split")
    say(f"[parallel] (b) one NCCL rank, {PAR_NCCL_N} images: CSV identical to the single "
        f"process's; launches {nccl['dissect']['launches']}")
    say(f"[parallel] (c) card vs CPU on two ranks: DP fine-tune losses max rel err "
        f"{cvc['ft_loss_max_rel_err']:.3g} (tol 1e-4), weights within "
        f"{cvc['ft_worst_share_of_tol']:.3g} of tolerance (worst {cvc['ft_worst']}); TP step loss "
        f"rel err {cvc['tp_loss_rel_err']:.3g}, {cvc['tp_entries_outside']} of "
        f"{cvc['tp_entries']} entries outside 1e-5 + 1e-3 max|x|, worst {cvc['tp_worst_abs_err']:.3g}")
    return {"images": PAR_N, "two_rank_wall_s": wall_2, "single_wall_s": single["wall_s"],
            "top1_agreement": top1, "identical_top_images": same_images,
            "launches_dissect_per_rank": [r["dissect"]["launches"] for r in ranks],
            "launches_nccl": nccl["dissect"]["launches"],
            "finetune": fts, "pretrain": pts, "pretrain_single": pt_single,
            "card_vs_cpu": cvc, "reference_s": ref_s, "gloo_s": gloo_s, "nccl_s": nccl_s}


FW_TOP1_BAR = 0.99     # BASELINE.md's per-unit top-1 concept agreement
FW_GATED = "mammo_calibrated"  # the reference whose scores carry the image's signal
# on noise_drawn every score is 0 within float32 rounding (a few 1e-5): the port's
# similarities must stay that close to JAX's, while its top-1 concepts are near-ties
FW_NOISE = "noise_drawn"
FW_NOISE_SIM_TOL = 1e-3
FW_PRECISIONS = (("fp32", ()), ("bf16", ("--dissector_kwargs", '{"dtype": "bfloat16"}')))
# JAX's bf16 program on mammo_calibrated: the card's bf16 run is compared with it (and,
# for continuity, with JAX's fp32 CSV) and the figure printed, not gated: the port's
# CPU run does not reach 0.99 either (bf16's sensitivity to the float32 summation
# order, PERF.md §6)
FW_BF16_REF = "mammo_calibrated_bf16"


def phase_fullwidth(device):
    """Phase 15: the flagship M-dissect's full-width agreement with the JAX package.
    The seeded Mammo-CLIP `.tar`s (drawn and calibrated weights) and the mammo_png
    probe's images are rebuilt and their SHA-256 held to the manifest's; for the
    references noise_drawn and mammo_calibrated the port's dissect CLI runs on the
    card with the manifest's arguments in fp32 (TF32 off) and with the bf16 tower,
    each CSV compared with the committed JAX CSV (`tests/assets/fullwidth/`):
    mammo_calibrated in fp32 must reach >= 0.99 top-1, noise_drawn in fp32 (every
    score a near tie at 0) must keep its similarities within 1e-3 of JAX's, the rest is
    printed; mammo_calibrated's bf16 run is also compared with JAX's bf16 CSV
    (FW_BF16_REF), printed; then `cli.analyze` reads mammo_calibrated's two CSVs."""
    import pandas as pd
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _fullwidth_agreement as fw
    from mammodissect_torch.cli import analyze
    from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue
    from mammodissect_torch.ops.cuda_mbconv import fused_expand_dw
    from mammodissect_torch.ops.cuda_wpmi import soft_wpmi_gather_logsum

    t_start = time.perf_counter()
    with open(fw.MANIFEST) as f:
        manifest = json.load(f)
    refs = (FW_NOISE, FW_GATED)
    for ref in (*refs, FW_BF16_REF):
        check(manifest["references"][ref]["cli"] == fw.manifest_cli(ref),
              f"the manifest's {ref} arguments are not the agreement run's")
    work = tempfile.mkdtemp(prefix="chip_smoke_fullwidth_")
    t0 = time.perf_counter()
    tars = {}
    for weights in fw.WEIGHTS:
        tars[weights] = fw.write_weights(manifest["seed"],
                                         os.path.join(work, f"mammo_clip_{weights}.tar"), weights)
        check(tars[weights][1] == manifest["weights_sha256"][weights],
              f"{weights} weights sha256 {tars[weights][1]} != the manifest's")
    probe_dir = os.path.join(work, "mammo_png")
    images_sha = fw.write_mammo_probe(probe_dir, manifest["seed"])
    setup_s = time.perf_counter() - t0
    check(images_sha == manifest["images_sha256"]["mammo_png"],
          f"mammo_png images sha256 {images_sha} != the manifest's")
    n_batches = -(-fw.N_IMAGES // fw.BATCH)
    runs, csvs = {}, {}
    for ref in refs:
        probe, weights = fw.REFERENCES[ref]
        path, _, sd = tars[weights]
        jax_df = fw.read_csv(fw.jax_csv(ref))
        check(len(jax_df) == manifest["references"][ref]["rows"] == fw.N_UNITS,
              f"the JAX {ref} CSV has {len(jax_df)} rows")
        for precision, extra in FW_PRECISIONS:
            name = f"{ref} {precision}"
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            fused_expand_dw.launches = 0
            soft_wpmi_gather_logsum.launches = 0
            bn_epilogue.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            csvs[name] = fw.run_port(probe, "cuda", os.path.join(work, ref, precision), path,
                                     sd, extra, log=lambda *_: None, probe_dir=probe_dir)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"mbconv": fused_expand_dw.launches,
                        "wpmi": soft_wpmi_gather_logsum.launches,
                        "bn_epilogue": bn_epilogue.launches}
            k3 = 52 * n_batches if precision == "bf16" else 0  # the bf16 tower's only
            check(launches == {"mbconv": 32 * n_batches, "wpmi": 1, "bn_epilogue": k3},
                  f"full-width {name}: launches {launches}, expected kernel 2 32 x "
                  f"{n_batches}, kernel 1 once and kernel 3 {k3} times")
            stats = fw.compare_csvs(str(csvs[name]), jax_df)
            with open(csvs[name], "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            runs[name] = {"wall_s": wall, "launches": launches, **fw.summary(stats),
                          "disagreements": stats["disagreements"], "csv_sha256": digest}
            say(f"[fullwidth] {name}: CLI {wall:.2f} s with the model build, launches "
                f"{launches}; CSV sha256 {digest}; vs JAX fp32: {json.dumps(fw.summary(stats))}")
            if ref == FW_GATED and precision == "bf16":
                stats = fw.compare_csvs(str(csvs[name]), fw.read_csv(fw.jax_csv(FW_BF16_REF)))
                vs_bf16 = {**fw.summary(stats), "disagreements": stats["disagreements"]}
                say(f"[fullwidth] {name} vs JAX bf16 ({FW_BF16_REF}): "
                    f"{json.dumps(fw.summary(stats))}")
    check(runs[f"{FW_GATED} fp32"]["top1"] >= FW_TOP1_BAR,
          f"full-width {FW_GATED} fp32 top-1 agreement with JAX "
          f"{runs[f'{FW_GATED} fp32']['top1']} < {FW_TOP1_BAR}")
    check(runs[f"{FW_NOISE} fp32"]["max_similarity_diff"] <= FW_NOISE_SIM_TOL,
          f"full-width {FW_NOISE} fp32 similarities differ from JAX's by "
          f"{runs[f'{FW_NOISE} fp32']['max_similarity_diff']} > {FW_NOISE_SIM_TOL}")
    out = os.path.join(work, "processed")
    t0 = time.perf_counter()
    rc = analyze.main(["--csv", str(csvs[f"{FW_GATED} fp32"]), "--csv_b",
                       str(csvs[f"{FW_GATED} bf16"]), "--out_dir", out])
    analyze_s = time.perf_counter() - t0
    for path, _, _ in tars.values():
        os.remove(path)
    check(rc == 0, f"cli.analyze returned {rc}")
    processed = sorted(f for f in os.listdir(out) if f.endswith("_processed.csv"))
    check(len(processed) == 2, f"cli.analyze wrote {processed}")
    over = {}
    for f in processed:
        df = pd.read_csv(os.path.join(out, f))
        check(len(df) == fw.N_UNITS, f"{f}: {len(df)} rows")
        over[f] = {"local": int(df["Threshold_met"].sum()),
                   "global": int(df["Global_thresh_met"].sum())}
    say(f"[fullwidth] cli.analyze on {FW_GATED}'s fp32 and bf16 CSVs: {analyze_s:.2f} s on "
        f"the host; neurons over the local and the global threshold {over}")
    wall = time.perf_counter() - t_start
    say(f"[fullwidth] phase 15 in {wall:.1f} s (weights and probe images written in "
        f"{setup_s:.1f} s)")
    return {"runs": runs, "bf16_vs_jax_bf16": vs_bf16, "analyze_s": analyze_s,
            "over_threshold": over,
            "setup_s": setup_s, "wall_s": wall}


def main():
    import torch

    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA GPU available")
        return 1
    if "--rank" in sys.argv:  # a spawned rank of phase 14
        return rank_main(sys.argv[1:])
    sys.path.insert(0, ROOT)
    import mammodissect_torch  # noqa: F401  (fails outside a checkout of the repo)
    from mammodissect_torch.device import set_fp32_policy

    set_fp32_policy()
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    wpmi = phase_wpmi(MAIN_N, device)
    silu_table = silu_table_check(device)
    mbconv = phase_mbconv(device)
    epilogue = phase_bn_epilogue(device)
    fp32_f64 = fp32_precision_check(device)
    say("[library] library_ms n/a for every kernel: no single PyTorch call computes "
        "any of the fused functions")
    t0 = time.perf_counter()
    pool = mammo_pool(POOL, *IMAGE_HW, seed=0)
    dissector, dissector_s = flagship_dissector(device)
    say(f"[setup] pool of {POOL} images {time.perf_counter() - t0 - dissector_s:.2f} s, "
        f"dissector {dissector_s:.2f} s")
    main_path = phase_main_path(device, pool, dissector)
    agreement = phase_agreement()
    c_dissect = phase_c_dissect(device, pool, dissector)
    wire = phase_packed_wire(device, pool, dissector)
    del dissector
    torch.cuda.empty_cache()
    finetune = phase_finetune(device, pool)
    torch.cuda.empty_cache()
    gdissect = phase_gdissect(device, finetune["end_to_end"]["png_root"], card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zoo = phase_zoo(device, gdissect, c_dissect, pool)
    say(f"[zoo] phase 12 in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v2pt = phase_v2_pretrain(device, pool, c_dissect, finetune["end_to_end"]["png_root"])
    say(f"[v2/pretrain] phase 13 in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    par = phase_parallel(device, pool)
    say(f"[parallel] phase 14 in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    fullwidth = phase_fullwidth(device)
    fw_launches = {key: {name: r["launches"][key] for name, r in fullwidth["runs"].items()}
                   for key in ("mbconv", "wpmi")}
    fw_top1 = {name: round(r["top1"], 4) for name, r in fullwidth["runs"].items()}
    pt_launches = {key: [v2pt["pretrain"][name]["launches"][key]
                         for name in ("plain", "bert_checkpoint", "bert_checkpoint_again",
                                      "plain_again")] + [v2pt["pretrain_cli"]["launches"][key]]
                   for key in ("mbconv", "wpmi")}

    per_forward = lambda key: sum(r[key] * r["blocks"] for r in mbconv)  # noqa: E731
    t_bytes_share = sum(r["bound_ms"] * r["blocks"] for r in mbconv if r["bound_by"] == "bytes")
    kernels = [
        {"name": "soft_wpmi_gather_logsum", "route": "cuda",
         "source": "mammodissect_torch/csrc/wpmi_gather_logsum.cu",
         "replaces": "mammodissect/ops/pallas_wpmi.py:81",
         "launches": main_path["launches"]["wpmi"],
         "launches_c_dissect": c_dissect["launches"]["wpmi"],
         "launches_finetune": finetune["end_to_end"]["launches"]["wpmi"],
         "launches_gdissect": gdissect["vit"]["launches"]["wpmi"],
         "launches_gdissect_clip_rn50": gdissect["clip_rn50"]["launches"]["wpmi"],
         "launches_gdissect_cifar100": gdissect["cifar100"]["launches"]["wpmi"],
         "launches_zeroshot": gdissect["zeroshot"]["breastclip"]["launches"]["wpmi"],
         "launches_zoo": {n: r["launches"]["wpmi"] for n, r in zoo["runs"].items()},
         "max_abs_err": max(wpmi["max_abs_err"], gdissect["kernel1"]["max_abs_err"],
                            gdissect["kernel1_cifar100"]["max_abs_err"],
                            *(r["max_abs_err"] for r in zoo["kernel1"].values())),
         # ms and wrapper_ms: through the wrapper (the first version's span); launch_ms: alone
         "ms": wpmi["ms"], "wrapper_ms": wpmi["ms"], "launch_ms": wpmi["launch_ms"],
         "plain_ms": wpmi["plain_ms"], "bound_ms": wpmi["bound_ms"],
         "bound_by": wpmi["bound_by"], "library_ms": None,
         # at the G-dissect shape (U = 9216 ViT-B/16 units, N = 2048: the gather design)
         "gdissect": gdissect["kernel1"],
         # at the CIFAR-100 G-dissect's shape (U = 9216, N = 10000: the gather design)
         "gdissect_cifar100": gdissect["kernel1_cifar100"],
         # at each zoo dissection's shape (phase 12)
         "zoo": zoo["kernel1"],
         # the V2-S C-dissect (phase 13a: 40 blocks, 6544 units, N = 512) and pretraining
         # (phase 13c/d: the two timed runs and the CLI's epoch)
         "launches_c_dissect_v2": v2pt["c_dissect_v2"]["launches"]["wpmi"],
         "launches_pretrain": pt_launches["wpmi"],
         "c_dissect_v2": v2pt["kernel1"],
         # phase 14: each rank of the two-rank resident M-dissect scores the gathered
         # rows once; the one-rank NCCL run once
         "launches_parallel_per_rank": [r["wpmi"] for r in par["launches_dissect_per_rank"]],
         "launches_parallel_nccl": par["launches_nccl"]["wpmi"],
         # phase 15: once in each full-width agreement run (two probes, fp32 and bf16)
         "launches_fullwidth": fw_launches["wpmi"]},
        {"name": "fused_expand_dw", "route": "cuda",
         "source": "mammodissect_torch/csrc/mbconv_expand_dw.cu",
         "replaces": "mammodissect/ops/pallas_mbconv.py:118",
         "launches": main_path["launches"]["mbconv"],
         # its second kernel, which adds the squeeze's tile partials: one a launch
         "reduce_launches": main_path["launches"]["mbconv_squeeze_reduce"],
         "launches_c_dissect": c_dissect["launches"]["mbconv"],
         # the end-to-end fine-tune: 32 an eval batch (validation, train-eval), 0 in train steps
         "launches_finetune": finetune["end_to_end"]["launches"]["mbconv"],
         "launches_gdissect": gdissect["vit"]["launches"]["mbconv"],
         "launches_gdissect_cifar100": gdissect["cifar100"]["launches"]["mbconv"],
         # zero-shot with the bf16 BreastClip: 32 a batch in embed_images
         "launches_zeroshot": gdissect["zeroshot"]["breastclip"]["launches"]["mbconv"],
         # the zoo dissections read phase 8's and 11's dissector caches: no B5 forward
         "launches_zoo": {n: r["launches"]["mbconv"] for n, r in zoo["runs"].items()},
         "max_abs_err": max(r["max_abs_err_bf16"] for r in mbconv),
         # the squeeze: the largest share of its bound, and |error|, over the shapes
         "squeeze_err": max(r[f"squeeze_err_{n}"] for r in mbconv
                            for n in ("bf16", "bf16_unit", "bf16_wide", "fp32")),
         # the bf16 SiLU table and its sigmoid kernel against the op chain on the card,
         # and the table against the CPU's (phase 5)
         **silu_table,
         "squeeze_max_abs_err_bf16": max(r["squeeze_max_abs_err_bf16"] for r in mbconv),
         # one forward's 32 launches at the main path's batch
         "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
         "bound_ms": per_forward("bound_ms"),
         "bound_by": "bytes" if t_bytes_share * 2 >= per_forward("bound_ms") else "operations",
         "library_ms": None,
         # the fp32 instantiation (the C-dissect target's), one forward at batch 16
         "fp32_ms": c_dissect["fp32_forward_ms"], "fp32_plain_ms": c_dissect["fp32_forward_plain_ms"],
         "fp32_bound_ms": c_dissect["fp32_forward_bound_ms"],
         "fp32_max_abs_err": c_dissect["fp32_max_abs_err"],
         # phase 5: the fp32 instantiation against float64 at the precision shapes
         # (max |err| / (1 + |x|)), and the C-dissect's fp32 weight-split launches
         "fp32_f64_max_rel_err": fp32_f64["max_rel_err"],
         "weight_launches_c_dissect": c_dissect["launches"]["mbconv_weight_split"],
         # the V2-S C-dissect's target: 28 a batch of 16 (phase 13a); pretraining: 0
         "launches_c_dissect_v2": v2pt["c_dissect_v2"]["launches"]["mbconv"],
         "launches_pretrain": pt_launches["mbconv"],
         # at each V2-S shape, fp32 and bf16, batch 16, and one V2-S forward's 28 launches
         "v2_shapes": v2pt["v2_shapes"], "v2_forward": v2pt["v2_forward"],
         # phase 14: 32 a batch on each rank of the two-rank resident M-dissect, the
         # one-rank NCCL run, and 32 in each rank's DP fine-tune eval batch
         "launches_parallel_per_rank": [r["mbconv"] for r in par["launches_dissect_per_rank"]],
         "launches_parallel_nccl": par["launches_nccl"]["mbconv"],
         "launches_parallel_finetune_eval": [f["eval_launches"] for f in par["finetune"]],
         # phase 15: 32 a batch of 8 in each full-width agreement run (two probes,
         # fp32 and bf16)
         "launches_fullwidth": fw_launches["mbconv"]},
        {"name": "bn_epilogue", "route": "cuda",
         "source": "mammodissect_torch/csrc/bn_epilogue.cu",
         # no TPU kernel: XLA fuses the conv's BatchNorm and SiLU chains
         "replaces": None,
         # 52 a batch of the bf16 tower, 7 of them with the SE's squeeze
         "launches": main_path["launches"]["bn_epilogue"],
         "squeeze_launches": main_path["launches"]["bn_epilogue_squeeze"],
         # the bf16 dissector's embed only: the fp32 target bypasses it
         "launches_c_dissect": c_dissect["launches"]["bn_epilogue"],
         "launches_finetune_train_steps": finetune["train"]["kernel3_launches_in_train_steps"],
         "launches_finetune_eval": finetune["eval"]["eval_kernel3_launches"],
         "launches_pretrain": [v2pt["pretrain"][name]["launches"]["bn_epilogue"]
                               for name in ("plain", "bert_checkpoint", "bert_checkpoint_again",
                                            "plain_again")],
         "launches_fullwidth": {name: r["launches"]["bn_epilogue"]
                                for name, r in fullwidth["runs"].items()},
         # bit for bit its plain version at every site (phase 5)
         "max_abs_err": 0.0,
         # one forward's 52 launches at the main path's batch, through the wrapper (the
         # 7 squeezes' ATen sums included), and each distinct site
         "ms": epilogue["ms"], "plain_ms": epilogue["plain_ms"],
         "bound_ms": epilogue["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "sites": epilogue["rows"]},
    ]
    say(f"[kernel 2] one forward's 32 launches at batch {MAIN_BATCH}, bf16: "
        f"{per_forward('ms'):.3f} ms (first version {FIRST_VERSION_MS['mbconv_forward']} ms), "
        f"bound {per_forward('bound_ms'):.3f} ms")
    say(f"[done] torch {torch.__version__}, CUDA {torch.version.cuda}, build {build_s:.2f} s, "
        f"agreement {agreement['top1_agreement']:.4f}, C-dissect {c_dissect['img_per_s']:.2f} img/s, "
        f"wire off/on/on/off {[round(r['img_per_s'], 2) for r in wire['runs']]} img/s, "
        f"fine-tune {finetune['train']['ms_per_step']:.2f} ms a step (remat "
        f"{finetune['train_remat']['ms_per_step']:.2f}), "
        f"G-dissect {gdissect['vit']['img_per_s']:.2f} img/s (CIFAR-100 "
        f"{gdissect['cifar100']['img_per_s']:.2f}), zoo "
        f"{ {n: round(r['img_per_s'], 2) for n, r in zoo['runs'].items()} } img/s, "
        f"V2 C-dissect {v2pt['c_dissect_v2']['img_per_s']:.2f} img/s, pretrain "
        f"{v2pt['pretrain']['plain']['ms_per_step']:.2f} ms a step (BERT checkpoint "
        f"{v2pt['pretrain']['bert_checkpoint']['ms_per_step']:.2f}), "
        f"two-rank M-dissect {par['images'] / par['two_rank_wall_s']:.2f} img/s (single "
        f"{par['images'] / par['single_wall_s']:.2f}), "
        f"full-width top-1 vs JAX {fw_top1}, bf16 vs JAX bf16 "
        f"{fullwidth['bf16_vs_jax_bf16']['top1']:.4f}, "
        f"total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
