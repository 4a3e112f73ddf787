"""The checks that decide `correct`, driven through the whole harness on the CPU at
a small size with the card's look skipped: the control (the plain reference in the
nearest precision below the configuration's, in the program's place) and each fault
the cell can have, planted underneath the program's entry point, must come out not
correct, on a number that the sound run at the same size passes. The limits are the
cells' own (`limits/<workload>.json`)."""
from __future__ import annotations

import pytest
import torch

from benchmark.tests import _tiny
from benchmark import control, core

CASES = [("mdissect_b5_resident", ("control", "image", "concept")),
         ("cdissect_b5_staged", ("control", "image", "concept")),
         ("finetune_b5_steps", ("control", "half_batch", "unchanged"))]


def run(workload, kind, concepts, seed=5):
    line = core.run(seed, workload, 0.1, False, 0.0, device=torch.device("cpu"),
                    configs=_tiny.configs(), traffic=_tiny.traffic(workload, concepts),
                    driver_hook=control.FAULTS[kind])
    return line


@pytest.fixture(scope="module")
def concepts(tmp_path_factory):
    return _tiny.concept_file(tmp_path_factory.mktemp("concepts"))


@pytest.fixture(scope="module")
def sound(concepts):
    """The sound run of a workload, made once a worker when first asked for."""
    cache = {}

    def get(workload):
        if workload not in cache:
            cache[workload] = run(workload, "program", concepts)
        return cache[workload]

    return get


@pytest.mark.parametrize("workload,kind", [(w, k) for w, kinds in CASES for k in kinds])
def test_broken_run_is_not_correct(workload, kind, concepts, sound, monkeypatch):
    from mammodissect_torch.dissect import engine

    good = sound(workload)  # before a fault is planted
    monkeypatch.setattr(engine, "write_results", engine.write_results)  # restored after
    broken = run(workload, kind, concepts)
    assert broken["correct"] is False
    passed = {k for k, c in good["checks"].items() if c["value"] <= c["limit"]}
    failed = {k for k, c in broken["checks"].items() if c["value"] > c["limit"]}
    assert failed & passed, (good["checks"], broken["checks"])
