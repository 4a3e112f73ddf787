"""Shared small sizes of the benchmark's CPU tests: the cells' configurations and
traffic with the published widths kept and the images, depth of BERT, concepts and
jobs cut, so that a run takes seconds on the CPU."""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402

CONCEPTS = ["mass", "calcification", "BI-RADS density A", "architectural distortion",
            "skin thickening", "nipple retraction", "lymph node", "focal asymmetry"]


def configs():
    out = {}
    for name in ("mammoclip_b5_bf16", "mammoclip_b5_classifier"):
        c = core.load_config(name)
        c.update(image_height=256, image_width=160)
        if "num_hidden_layers" in c:
            c.update(num_hidden_layers=1, max_length=24)
        out[name] = c
    return out


def traffic(workload: str, concept_file: str, images: int = 8) -> dict:
    bench = core.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    name = next(w["traffic"] for w in bench["workloads"] if w["name"] == workload)
    t = core.read_json(core.bench_path("traffic", f"{name}.json"))
    if t["kind"] == "train_steps":
        t.update(batch_size=4, pool_images=12, trace_steps=2)
    else:
        t.update(images_per_job=images, batch_size=4, warmup_images=4,
                 calibration_images=images, concepts=concept_file, top_k=4)
    return t


def concept_file(tmp_path) -> str:
    path = tmp_path / "concepts.txt"
    path.write_text("\n".join(CONCEPTS))
    return str(path)
