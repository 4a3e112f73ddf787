"""Variants of kernel 2 (`mammodissect_torch/csrc/mbconv_expand_dw.cu`), bf16 or
fp32, timed on the card at the EfficientNet-B5 shapes of `chip_smoke.py` phase 5 and
the V2-S shapes of phase 13 (batch 16). Imports the port only (no JAX).

    python tools/kernel_variants.py VARIANTS.json [bf16|fp32]

VARIANTS.json maps a variant's name to a list of [old, new] text substitutions applied
to the source (an empty list is the source as it is), or to the path of a whole
source file. Each variant is compiled with the port's nvcc flags into
`build/kernel_variants/` (all nvcc processes started together), loaded through
ctypes and run through the wrapper's own launch (`ops.cuda_mbconv._launch`) with its
library in the tree's place. Prints each variant's ptxas registers and spills for the
kernels of the dtype (bf16 by default), then its ms a B5 forward (32 launches) and a
V2-S forward (28 launches), its ms at each B5 shape, and whether its output equals the
first variant's bit for bit at each shape (a variant that leaves out work, to see
what that work costs, is not equal).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from mammodissect_torch.device import set_fp32_policy  # noqa: E402
from mammodissect_torch.ops import kernels  # noqa: E402
from mammodissect_torch.ops.cuda_mbconv import _launch, silu_table  # noqa: E402

BATCH = 16
OUT = os.path.join(ROOT, "build", "kernel_variants")


def build(variants, dtype):
    """{name: ctypes library} of the variants that compiled; prints their ptxas figures."""
    src = open(os.path.join(kernels.CSRC, "mbconv_expand_dw.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = open(subs).read() if isinstance(subs, str) else src
        for old, new in [] if isinstance(subs, str) else subs:
            if old not in text:
                raise ValueError(f"{name}: {old[:60]!r} is not in the source")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas=-v", "-I", str(kernels.CSRC),
               "-o", os.path.join(OUT, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        kernel = "expand_dw_bf16" if dtype == torch.bfloat16 else "expand_dw_f32"
        rows = [r for r in smoke.ptxas_summary(log) if kernel in r["function"]]
        print(name, [(smoke.kernel_label(r["function"]), r.get("registers"), r.get("spill_stores"))
                     for r in rows], flush=True)
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
    return libs


def main(path, dtype) -> int:
    set_fp32_policy()
    device = torch.device("cuda")
    silu_table(device)  # built once by the tree's own sigmoid, before any variant loads
    libs = build(json.load(open(path)), dtype)
    shapes = [s[:6] for s in smoke.B5_SHAPES] + [s[:6] for s in smoke.V2_SHAPES]
    results = {name: [] for name in libs}
    for i, (k, h, w, cin, cexp, n_blocks) in enumerate(shapes):
        args = smoke._mbconv_args(BATCH, h, w, cin, cexp, k, dtype, device, seed=10 + i)
        first = None
        for name, lib in libs.items():
            # the wrapper's own launch (arguments, partials, table) with this variant's library
            with mock.patch.object(kernels, "load", lambda _, lib=lib: lib):
                ms = smoke.cuda_ms(lambda: _launch(*args), reps=10, warmup=2)
                out, _ = _launch(*args)
            same = None if first is None else bool(torch.equal(out, first))
            if first is None:
                first = out
            results[name].append((ms * n_blocks, ms, same))
        del args, first
    n_b5 = len(smoke.B5_SHAPES)
    for name, rows in results.items():
        print(f"{name}: B5 forward {sum(r[0] for r in rows[:n_b5]):.3f} ms, V2-S "
              f"{sum(r[0] for r in rows[n_b5:]):.3f} ms; at each B5 shape "
              f"{[round(r[1], 4) for r in rows[:n_b5]]}; equal to the first "
              f"{[r[2] for r in rows]}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["bf16"], ["fp32"]):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], torch.float32 if sys.argv[2:] == ["fp32"] else torch.bfloat16))
