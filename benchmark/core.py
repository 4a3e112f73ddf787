"""The harness's frame: finds a cell's configuration, traffic mix and metric readers by
the names in `BENCHMARK.json`, runs the traffic's driver, and prints the result.

Everything that belongs to one configuration, one traffic mix or one metric is a
file of its own, found by name:
- `configs/<config>.json`: the configuration, sizes as run;
- `traffic/<traffic>.json`: the traffic mix; its `kind` names the driver that runs
  it, `drivers/<kind>.py`;
- `metrics/<metric>.py`: a reader, `read(run) -> float | dict | None`; None leaves
  the metric out of the line;
- `limits/<workload>.json`: the limit of each number that decides `correct`.
A later cell, mix or metric is new files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "mammodissect")  # top-level module names, whole


class RunError(Exception):
    """The run cannot produce a result; the message says why."""


@dataclass
class Context:
    """What a driver gets: the run's arguments and the cell's files, already read."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    config_of: object = None  # name -> another configuration (a dissector's)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def bench_path(*parts: str) -> str:
    return os.path.join(BENCH_DIR, *parts)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_config(name: str) -> dict:
    return read_json(bench_path("configs", f"{name}.json"))


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end metrics untraced, its per-layer
    metrics traced (listed for the cell, or with no list, moving an end-to-end metric
    the cell reports)."""
    def listed(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if listed(m) or (listed(m) is None and m["moves"] in names)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX package,
    compared whole (`mammodissect_torch` is not `mammodissect`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def metric_value(reader_out, unit: str):
    if isinstance(reader_out, dict):
        return {"value": reader_out["value"], "unit": unit,
                **{k: v for k, v in reader_out.items() if k != "value"}}
    return {"value": reader_out, "unit": unit}


def run(argv_seed: int, workload_name: str, seconds: float, trace: bool, t_start: float,
        device=None, bench: Optional[dict] = None, configs: Optional[dict] = None,
        traffic: Optional[dict] = None, limits: Optional[dict] = None,
        driver_hook=None) -> dict:
    """One run of a cell: the result line as a dict. `device`, `bench`, `configs`
    (name -> configuration), `traffic`, `limits` and `driver_hook` replace what the
    card and the files give (tests)."""
    import torch

    bench = bench if bench is not None else read_json(os.path.join(ROOT, "BENCHMARK.json"))
    workload = next((w for w in bench["workloads"] if w["name"] == workload_name), None)
    if workload is None:
        raise RunError(f"no workload {workload_name!r} in BENCHMARK.json")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
            raise RunError(f"the cell needs {workload['chips']} CUDA device(s); "
                           f"{torch.cuda.device_count()} available")
        device = torch.device("cuda", 0)
    try:
        import mammodissect_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        raise RunError(f"the program is not here: {e}") from e
    configs = configs or {}

    def config_of(name):
        return configs[name] if name in configs else load_config(name)

    traffic = traffic if traffic is not None else read_json(
        bench_path("traffic", f"{workload['traffic']}.json"))
    limits_path = bench_path("limits", f"{workload_name}.json")
    if limits is None:
        limits = read_json(limits_path) if os.path.exists(limits_path) else {}
    ctx = Context(workload=workload, config=config_of(workload["config"]), traffic=traffic,
                  seed=int(argv_seed), seconds=float(seconds), trace=trace, device=device,
                  t_start=t_start, config_of=config_of)
    driver = load_module(bench_path("drivers", f"{traffic['kind']}.py"),
                         f"benchmark_driver_{traffic['kind']}")
    result = driver.run(ctx, hook=driver_hook)
    found = forbidden_modules()
    if found:
        raise RunError(f"forbidden modules loaded in this process: {found}")
    metrics = {}
    for m in cell_metrics(bench, workload_name, trace):
        reader = load_module(bench_path("metrics", f"{m['name']}.py"), f"benchmark_metric_{m['name']}")
        value = reader.read(result)
        if value is not None:
            metrics[m["name"]] = metric_value(value, m["unit"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(result.memory_peak_bytes)}
    if result.power:
        dev["power"] = result.power
    # the limits file names the numbers compared; every one must be read and within
    compared = {k: result.readings.get(k) for k in limits} if limits else dict(result.readings)
    correct = bool(limits) and all(v is not None and v <= limits[k] for k, v in compared.items())
    line = {"correct": correct, "attempted": result.attempted,
            "failed": 0, "metrics": metrics, "device": dev}
    if trace and result.trace is not None:
        dev["busy_s"] = result.trace.busy_s
        dev["window_s"] = result.trace.wall_s
        line["breakdown"] = {
            "device_ops": [[k, v] for k, v in list(result.trace.classes.items())[:10]],
            "idle_gaps": [[k, v] for k, v in result.trace.idle_gaps[:10]]}
        line["launches"] = result.trace.launches
    line["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in compared.items()}
    return line


def main(argv: List[str], t_start: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Benchmark of mammodissect_torch on one cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    try:
        line = run(args.seed, args.workload, args.seconds, bool(args.trace), t_start)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
