"""The readers of the program's spans (`benchmark/spans.py`, the `program_span` metrics
that read it) on tiny runs of the three cells on the CPU: each gives a number in the
cells its entry lists and None where its stage does not run, and none raises where
the program keeps no spans."""
from __future__ import annotations

import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.tests import _tiny
from benchmark import core, window

CELLS = ("mdissect_b5_resident", "cdissect_b5_staged", "finetune_b5_steps")


def _bench():
    return core.read_json(os.path.join(core.ROOT, "BENCHMARK.json"))


def _span_metrics():
    return [m for m in _bench()["per_layer"] if m["source"] == "program_span"
            and m["name"] not in ("resident_host_ms_per_batch", "results_s_per_job")]


def _reader(name):
    return core.load_module(core.bench_path("metrics", f"{name}.py"),
                            "test_spans_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Each cell's driver result at the tiny sizes, its units untraced."""
    concepts = _tiny.concept_file(tmp_path_factory.mktemp("c"))
    configs = _tiny.configs()
    out = {}
    for name in CELLS:
        workload = next(w for w in _bench()["workloads"] if w["name"] == name)
        traffic = _tiny.traffic(name, concepts)
        ctx = core.Context(workload=workload, config=configs[workload["config"]],
                           traffic=traffic, seed=11, seconds=0.1, trace=False,
                           device=torch.device("cpu"), t_start=time.perf_counter(),
                           config_of=configs.__getitem__)
        driver = core.load_module(core.bench_path("drivers", f"{traffic['kind']}.py"),
                                  f"test_spans_driver_{traffic['kind']}")
        out[name] = driver.run(ctx)
    return out


def test_every_span_metric_reads_its_listed_cells_and_nothing_elsewhere(results):
    metrics = _span_metrics()
    assert len(metrics) == 15
    for m in metrics:
        reader = _reader(m["name"])
        for cell, run in results.items():
            got = reader.read(run)
            if cell in m["workloads"]:
                assert isinstance(got, float) and got >= 0, (m["name"], cell, got)
            else:
                assert got is None, (m["name"], cell, got)


def test_stages_and_other_add_up_to_the_job(results):
    for cell in ("mdissect_b5_resident", "cdissect_b5_staged"):
        run = results[cell]
        parts = sum(_reader(f"stage_s_per_job.{s}").read(run) or 0.0 for s in
                    ("harvest", "embed", "text", "score", "results", "io", "other"))
        unit = run.window.untraced()[0]
        assert parts == pytest.approx(unit.seconds, rel=0.05), cell
    run = results["finetune_b5_steps"]
    phases = sum(_reader(f"train_phase_ms.{p}").read(run)
                 for p in ("h2d", "forward", "backward", "optimizer", "sync"))
    steps = [1e3 * u.seconds for u in run.window.untraced()]
    assert phases <= sum(steps) / len(steps)


def test_results_line_is_still_read(results):
    got = _reader("results_s_per_job").read(results["cdissect_b5_staged"])
    spans = _reader("stage_s_per_job.results").read(results["cdissect_b5_staged"])
    assert got is not None and got == pytest.approx(spans, abs=0.006)


def test_nothing_without_the_program_s_spans(results, monkeypatch):
    """A program that keeps no spans (one that predates them), or a ring that has
    dropped spans of the window: every reader gives None and none raises."""
    from mammodissect_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    for m in _span_metrics():
        for run in results.values():
            assert _reader(m["name"]).read(run) is None, m["name"]
    monkeypatch.undo()
    run = results["mdissect_b5_resident"]
    late = window.Window(start=run.window.start, end=run.window.end, units=run.window.units)
    full = [profiling.SpanRecord(0, "x", int(late.start * 1e9) + 1, int(late.start * 1e9) + 2,
                                 None, None, 0)] * profiling.RING_SIZE
    monkeypatch.setattr(profiling, "spans", lambda: full)
    assert _reader("stage_s_per_job.harvest").read(SimpleNamespace(window=late)) is None
