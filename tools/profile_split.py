"""The device time of a `mammodissect_torch.cli.dissect --profile` trace, split by the
kind of kernel, and the device's idle share. Imports the port only (no JAX).

    python tools/profile_split.py run DIR [N]
        the flagship resident M-dissect at `chip_smoke.py` phase 6's configuration
        (B5 at 1520x912, all 39 blocks, the bf16 BreastClip with its 12-layer BERT,
        the 762 concepts, soft-WPMI, batch 16, the plain wire, random weights from
        seed 0) on N `synthetic_u8` images (default 256) through the CLI with
        `--profile DIR`, then the split of DIR/trace.json
    python tools/profile_split.py run-c DIR [N]
        the same for the staged C-dissect at phase 8's configuration: the fine-tuned
        classifier target (B5 fp32, random weights from seed 2, all 39 blocks)
        dissected by that BreastClip, N images (default 256)
    python tools/profile_split.py DIR
        the split of an existing DIR/trace.json

Prints one JSON object: device busy seconds, the span from the first device op to the
last, the idle share of that span, and for each kind its seconds and share of the
device time (kernels, copies and memsets), with the largest ops left in "other". The
port's kernels are told by name, every other kernel by the ATen op that launched it;
the profiler slows the host, so the idle share overstates an unprofiled run's.
"""
from __future__ import annotations

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONCEPTS = os.path.join(ROOT, "mammodissect", "assets", "concepts",
                        "Specific_concepts_sorted.txt")

# the port's kernels, by name
OWN_KERNELS = (("kernel 2 fp32 (MBConv front half and its weight split)",
                r"expand_dw_f32|split_weights_kernel"),
               ("kernel 2 bf16 (MBConv front half and its SiLU table)", r"expand_dw_bf16|sigmoid_bf16"),
               ("kernel 2's squeeze partials", r"squeeze_tiles_kernel"),
               ("kernel 1 (soft-WPMI)", r"gather_logsum"))
# every other kernel by the ATen op that launched it (the innermost op, linked by the
# trace's "External id")
OP_KINDS = (
    ("copies and casts", ("aten::copy_", "aten::_to_copy", "aten::clone", "aten::cat")),
    ("BatchNorm (sub, addcmul)", ("aten::sub", "aten::addcmul", "aten::cudnn_batch_norm",
                                  "aten::native_batch_norm")),
    ("SiLU and sigmoid chains (neg, exp, reciprocal, flush)",
     ("aten::neg", "aten::exp", "aten::reciprocal", "aten::where")),
    ("products and sums (SiLU products, SE gate, residuals)", ("aten::mul", "aten::add",
                                                               "aten::div")),
    ("convolutions (cuDNN)", ("aten::cudnn_convolution", "aten::_convolution")),
    ("matrix products (1x1 convolution sums, BERT)", ("aten::mm", "aten::addmm", "aten::bmm")),
    ("reductions (pooling, SE mean, norms)", ("aten::sum", "aten::mean", "aten::amax",
                                              "aten::linalg_vector_norm", "aten::_softmax",
                                              "aten::native_layer_norm")),
)


def split(trace_path: str) -> dict:
    from mammodissect_torch.cli.dissect import device_busy

    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = device_busy(events)
    op_of = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    kind_of = {op: kind for kind, ops in OP_KINDS for op in ops}
    kinds = dict.fromkeys([k for k, _ in OWN_KERNELS] + [k for k, _ in OP_KINDS], 0.0)
    other = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        s = e.get("dur", 0) / 1e6
        own = next((k for k, pattern in OWN_KERNELS if re.search(pattern, e.get("name", ""))),
                   None)
        if own is not None:
            kinds[own] += s
            continue
        op = op_of.get(e.get("args", {}).get("External id"), e.get("cat"))
        if op in kind_of:
            kinds[kind_of[op]] += s
        else:
            other[op] = other.get(op, 0.0) + s
    total = sum(kinds.values()) + sum(other.values())
    kinds["other"] = sum(other.values())
    span = dev["first_to_last_s"]
    return {"device_busy_s": dev["busy_s"], "first_to_last_s": span,
            "idle_share_of_span": 1 - dev["busy_s"] / span if span else None,
            "device_s": total,
            "kinds": {k: {"s": v, "share": v / total if total else 0.0}
                      for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])},
            "other_ops": dict(sorted(other.items(), key=lambda kv: -kv[1])[:8])}


def run(out_dir: str, n: int, c_dissect: bool = False) -> None:
    from mammodissect_torch.cli import dissect

    target = (["--target_model", "breastclip_classifier", "--target_kwargs", json.dumps({"seed": 2})]
              if c_dissect else ["--target_model", "breastclip"])
    argv = [*target, "--clip_model", "breastclip",
            "--dissector_kwargs", json.dumps({"dtype": "bfloat16", "bert_layers": 12, "seed": 0}),
            "--target_layers", ",".join(f"blocks.{i}" for i in range(39)),
            "--d_probe", "synthetic_u8",
            "--probe_kwargs", json.dumps({"n": n, "h": 1520, "w": 912, "c": 1}),
            "--concept_set", CONCEPTS, "--batch_size", "16",
            *([] if c_dissect else ["--resident", "--wire_pack", "off"]),
            "--activation_dir", os.path.join(out_dir, "acts"),
            "--result_dir", os.path.join(out_dir, "results"), "--profile", out_dir]
    rc = dissect.main(argv)
    if rc:
        raise SystemExit(rc)


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    if argv and argv[0] in ("run", "run-c"):
        out_dir = argv[1]
        run(out_dir, int(argv[2]) if len(argv) > 2 else 256, c_dissect=argv[0] == "run-c")
    else:
        out_dir = argv[0]
    print(json.dumps(split(os.path.join(out_dir, "trace.json"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
