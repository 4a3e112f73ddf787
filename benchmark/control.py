"""Readings of the numbers that decide `correct`, over many seeds in one process: the
program's sound runs (the lower readings), the control (the upper readings), or a
planted fault, each at the cell's own size on the card.

    python3 benchmark/control.py --workload <cell> --as program|control|<fault> \
        --seeds 11,12,13 [--seconds 1] [--set compute_dtype='"float32"']

`control` puts the plain reference, computed in the nearest precision below the
configurations' (float32 as TF32, bf16 as fp8 e4m3), in the program's place.
The faults (`FAULTS`) break the timed path underneath the program's entry point:
`image` gives one unit's first top image another image, `concept` gives one unit's
first concept another concept, each where the results are produced (dissection);
`half_batch` takes each step's loss over half the batch, `unchanged` leaves the
state as it was after each step (training). Prints one
JSON line a seed with every reading, then their largest and smallest, and the
limits that `limits/<workload>.json` holds. The benchmark's own runs never run
this."""
from __future__ import annotations

import json
import os
import sys
import time

T_START = time.perf_counter()


_WRITERS = {}


def _alter(field):
    """A fault: the engine's results writer alters unit 0's first `field` entry."""
    def hook(cell):
        from mammodissect_torch.dissect import engine

        write = _WRITERS.setdefault("write_results", engine.write_results)
        pool = len(cell.concepts) if field == "description" else cell.traffic["images_per_job"]

        def altered(outputs, cfg, **kw):
            row = list(outputs[field][0])
            if field == "description":
                row[0] = cell.concepts[(cell.concepts.index(row[0]) + 1) % pool]
            else:
                row[0] = (int(row[0]) + 1) % pool
            outputs[field][0] = row
            return write(outputs, cfg, **kw)

        engine.write_results = altered
    return hook


def _control(cell):
    if hasattr(cell, "control_job"):
        cell.job = cell.control_job
    else:
        cell.first_steps = cell.control_steps


def _half_batch(cell):
    """A fault: each step's loss is the mean over the first half of the batch."""
    loss = cell.trainer._loss

    def half(logits, labels, weights):
        weights = weights.clone()
        weights[weights.shape[0] // 2:] = 0
        return loss(logits, labels, weights)

    cell.trainer._loss = half


def _unchanged(cell):
    """A fault: each step leaves the weights and the optimizer's state as they were."""
    cell.trainer.optimizer.step = lambda *args, **kwargs: None


FAULTS = {"program": None, "control": _control, "image": _alter("images"),
          "concept": _alter("description"), "half_batch": _half_batch,
          "unchanged": _unchanged}


def main(argv) -> int:
    import argparse

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import core

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--as", dest="kind", choices=sorted(FAULTS), default="program")
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                        help="replace one entry of the cell's traffic mix for these readings")
    args = parser.parse_args(argv)
    traffic = None
    if args.set:
        bench = core.read_json(os.path.join(core.ROOT, "BENCHMARK.json"))
        name = next(w["traffic"] for w in bench["workloads"] if w["name"] == args.workload)
        traffic = core.read_json(core.bench_path("traffic", f"{name}.json"))
        for item in args.set:
            key, value = item.split("=", 1)
            traffic[key] = json.loads(value)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = core.run(seed, args.workload, args.seconds, False, t0, traffic=traffic,
                        driver_hook=FAULTS[args.kind])
        rows.append({k: v["value"] for k, v in line["checks"].items()})
        print(json.dumps({"seed": seed, "as": args.kind, "correct": line["correct"],
                          "readings": rows[-1], "metrics": line["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    keys = rows[0].keys()
    print(json.dumps({"as": args.kind, "max": {k: max(r[k] for r in rows) for k in keys},
                      "min": {k: min(r[k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
