"""Kernel 2's time a B5 forward, the main path's and the C-dissects' img/s, of one or
more checkouts of the repo on one card: `chip_smoke.py`'s phases 2 (build), 5
(kernel 2 at the B5 shapes, bf16), 6 (the flagship resident M-dissect), 8 (the
C-dissect, with kernel 2's fp32 shapes), 13a (the V2-S C-dissect) and 13's kernel 2
at the V2-S shapes of each checkout, run in a process of its own and in the order
given. Imports the port only
(no JAX).

    python tools/ab_phases.py ROOT [ROOT ...]

Give the same checkouts in a mirrored order (parent, change, change, parent) to
compare two trees within one call. Each checkout's phases check what they check in
`chip_smoke.py` (a failure stops the run). Prints the card's name and power limit,
then for each checkout its phase-5 lines (kernel 2 at each B5 shape) and one JSON
line: its root, kernel 2's bf16 and fp32 ms a B5 forward (32 launches at batch 16)
with the bf16 bound, fp32 at each B5 and V2-S shape, the main path's img/s and peak
memory, the C-dissect's and the V2-S C-dissect's img/s, kernel 2's bf16 and fp32 ms a
V2-S forward (28 launches) with the bf16 bound.
"""
from __future__ import annotations

import json
import subprocess
import sys

CHILD = r"""
import importlib.util, json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch
from mammodissect_torch.device import set_fp32_policy
set_fp32_policy()
device = torch.device("cuda")
smoke.phase_build()
rows = smoke.phase_mbconv(device)
pool = smoke.mammo_pool(smoke.POOL, *smoke.IMAGE_HW, seed=0)
dissector, _ = smoke.flagship_dissector(device)
main = smoke.phase_main_path(device, pool, dissector)
c = smoke.phase_c_dissect(device, pool, dissector)
c_v2 = smoke.v2_c_dissect(device, pool, c)
v2 = smoke.v2_mbconv_rows(device)
print("AB " + json.dumps({
    "root": sys.argv[1],
    "kernel2_bf16_forward_ms": sum(r["ms"] * r["blocks"] for r in rows),
    "kernel2_bf16_forward_bound_ms": sum(r["bound_ms"] * r["blocks"] for r in rows),
    "kernel2_fp32_forward_ms": c["fp32_forward_ms"],
    "kernel2_fp32_shapes_ms": [r["ms"] for r in c["fp32_shapes"]],
    "kernel2_v2_fp32_shapes_ms": [r["fp32"]["ms"] for r in v2],
    "main_img_per_s": main["img_per_s"],
    "main_peak_gib": main["max_memory_allocated_bytes"] / 2 ** 30,
    "c_dissect_img_per_s": c["img_per_s"],
    "v2_c_dissect_img_per_s": c_v2["img_per_s"],
    "kernel2_v2_bf16_forward_ms": sum(r["bf16"]["ms"] * r["blocks"] for r in v2),
    "kernel2_v2_fp32_forward_ms": sum(r["fp32"]["ms"] * r["blocks"] for r in v2),
    "kernel2_v2_bf16_forward_bound_ms": sum(r["bf16"]["bound_ms"] * r["blocks"] for r in v2)}),
      flush=True)
"""


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            print(f"ab_phases: {root} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():  # kernel 2's lines, at each B5 shape
            if line.startswith("[kernel 2]"):
                print(f"{root} {line}", flush=True)
        results.append(json.loads(lines[-1][3:]))
        print(json.dumps(results[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
