"""The port's span recorder (`mammodissect_torch/utils/profiling.py`) and the spans
the program records: nesting, parents and job ids, the ring, the profiler ranges on
the profiler's clock, and the spans of a tiny resident and staged dissection, a
training step and the CLI's `--profile` table, on the CPU."""
import re
import sys
import threading
import time
import warnings
from collections import deque

import numpy as np
import pytest
import torch

from mammodissect_torch.utils import profiling
from mammodissect_torch.utils.profiling import span

SMALL = {"bert_layers": 2, "model_config": {
    "name": "clip_custom", "temperature": 0.07,
    "image_encoder": {"model_type": "cnn", "variant": "efficientnet-test", "in_channels": 1},
    "text_encoder": {"pooling": "eos"},
    "projection_head": {"name": "linear", "proj_dim": 32}}}
CONCEPTS = "tests/assets/tiny_concepts.txt"


def _since(t0_ns):
    return [r for r in profiling.spans() if r.start_ns >= t0_ns]


def _names(records):
    return [r.name for r in records]


def test_spans_nest_link_parents_and_share_the_job():
    t0 = time.perf_counter_ns()
    job = profiling.new_job()
    with span("outer", job=job) as outer:
        assert profiling.current_job() == job
        with span("inner") as inner:
            with span("leaf.wait"):
                pass
            assert inner.seconds >= 0 and inner.end is None
        with span("other", job=job + 1000):
            assert profiling.current_job() == job + 1000
    assert profiling.current_job() is None
    got = {r.name: r for r in _since(t0)}
    assert _names(_since(t0)) == ["leaf.wait", "inner", "other", "outer"]  # in end order
    assert got["outer"].parent is None and got["outer"].id == outer.id
    assert got["inner"].parent == outer.id and got["leaf.wait"].parent == inner.id
    assert got["other"].parent == outer.id
    assert {got[n].job for n in ("outer", "inner", "leaf.wait")} == {job}
    assert got["other"].job == job + 1000
    assert got["outer"].start_ns <= got["inner"].start_ns <= got["leaf.wait"].start_ns
    assert got["leaf.wait"].end_ns <= got["inner"].end_ns <= got["outer"].end_ns
    assert got["outer"].seconds == pytest.approx(outer.seconds)
    assert profiling.last("inner") == got["inner"]
    # a span closed out of order (a generator's) leaves the others' parents right
    a, b = span("a"), span("b")
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)
    with span("c") as c:
        pass
    b.__exit__(None, None, None)
    assert profiling.last("c").parent == b.id and profiling.current_job() is None


def test_ring_drops_its_oldest_records(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", deque(maxlen=4))
    for i in range(6):
        with span(f"s{i}"):
            pass
    assert _names(profiling.spans()) == ["s2", "s3", "s4", "s5"]
    assert profiling.last("s0") is None and profiling.last("s5").name == "s5"


def test_ring_takes_every_thread_s_spans(monkeypatch):
    """More writers than cores, a short switch interval: no span lost or torn."""
    monkeypatch.setattr(profiling, "_ring", deque(maxlen=1 << 16))
    n_threads, n_spans = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write(k):
            with span("thread.outer", job=k):
                for _ in range(n_spans):
                    with span("thread.inner"):
                        pass
        threads = [threading.Thread(target=write, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    records = profiling.spans()
    assert len(records) == n_threads * (n_spans + 1)
    assert len({r.id for r in records}) == len(records)
    outer = {r.id: r for r in records if r.name == "thread.outer"}
    assert sorted(r.job for r in outer.values()) == list(range(n_threads))
    for r in records:
        if r.name == "thread.inner":
            assert r.job == outer[r.parent].job and r.thread == outer[r.parent].thread


def test_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    t0 = time.perf_counter_ns()
    with span("quiet"):
        with profiling.kernel_range("kernel1"):
            pass
    assert _names(_since(t0)) == ["quiet"]  # a kernel range is not a span


def test_spans_are_profiler_ranges_on_the_trace_s_clock():
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # the first range's set-up
            pass
        for i in range(3):
            with span(f"clock.{i}"):
                torch.ones(64).mul_(2)
                time.sleep(0.002)
        with profiling.kernel_range("kernel2.bf16"):
            torch.ones(64).add_(1)
    offset = profiling.clock_offset_ns()
    mine = {r.name: r for r in _since(t0)}
    assert set(mine) == {"clock.0", "clock.1", "clock.2"}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert "kernel2.bf16" in events
    for name, r in mine.items():
        assert abs(events[name].start_ns() - (r.start_ns + offset)) < 1e6, name
        assert events[name].duration_ns() == pytest.approx(r.end_ns - r.start_ns, abs=1e6)


def test_span_table_counts_total_and_self_seconds():
    R = profiling.SpanRecord
    table = profiling.span_table([R(1, "job", 0, 10_000_000_000, None, 0, 1),
                                  R(2, "stage", 0, 4_000_000_000, 1, 0, 1),
                                  R(3, "stage", 5_000_000_000, 6_000_000_000, 1, 0, 1)])
    rows = {line.split()[0]: line.split()[1:] for line in table.splitlines()[1:]}
    assert rows == {"job": ["1", "10.000", "5.000"], "stage": ["2", "5.000", "5.000"]}


@pytest.fixture(scope="module")
def dissector():
    from mammodissect_torch.dissect.dissectors import get_dissector

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy-vocab warning
        return get_dissector("breastclip", device="cpu", **SMALL)


def _probe(n=20, h=64, w=48):
    from mammodissect_torch.data.probes import ArrayProbe

    images = np.random.default_rng(0).integers(0, 256, size=(n, h, w, 1), dtype=np.uint8)
    return ArrayProbe(images, mean=0.3, std=0.25)


def _children(records, parent):
    return [r for r in records if r.parent == parent.id]


def test_resident_job_shares_one_id_across_its_threads(dissector, tmp_path):
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

    cfg = DissectConfig(target_model="breastclip", clip_model="breastclip",
                        target_layers=["blocks.0", "blocks.5"], d_probe="synthetic_u8",
                        concept_set=CONCEPTS, batch_size=8, resident=True, device="cpu",
                        activation_dir=str(tmp_path / "a"), result_dir=str(tmp_path / "r"))
    t0 = time.perf_counter_ns()
    timing, logs = [], []
    run_dissection(cfg, probe=_probe(), dissector=dissector, log=logs.append, timing=timing)
    records = _since(t0)
    (job,) = [r for r in records if r.name == "dissect.job"]
    assert {r.job for r in records} == {job.job}
    stages = _children(records, job)
    assert _names(stages) == ["dissect.harvest", "dissect.text", "dissect.score",
                              "dissect.results"]
    harvest, text, score, results = stages
    batches = [r for r in _children(records, harvest) if r.name == "harvest.batch"]
    assert len(batches) == 3 == len(timing)
    for batch, row in zip(batches, timing):
        put, step = _children(records, batch)
        assert (put.name, step.name) == ("harvest.put", "harvest.step")
        assert row["assemble_s"] == (put.start_ns - batch.start_ns) / 1e9
        assert row["put_s"] == put.seconds and row["step_s"] == step.seconds
        assert row["sync_s"] == 0.0  # no 16th batch: no wait
    me = job.thread
    for name, count in (("harvest.assemble", 3), ("harvest.spill", 1)):
        on_thread = [r for r in records if r.name == name]
        assert len(on_thread) == count and all(r.thread != me for r in on_thread), name
    assert _names(_children(records, text)) == ["text.wait"]
    assert _names(_children(records, score)) == ["score.wait"] * 3
    assert not _children(records, results)
    seconds = float(re.search(r"\[resident\] dissected .* in ([0-9.]+)s$",
                              next(l for l in logs if l.startswith("[resident] dissected")))[1])
    assert seconds == pytest.approx((score.end_ns - harvest.start_ns) / 1e9, abs=0.05)


def test_staged_job_spans_and_stage_lines(dissector, tmp_path):
    """The staged path with an EfficientNet target on the uint8 wire: every stage
    nested in the job, each stage's saves and the loads as `dissect.io`, the waits in
    their stages, and the stage lines' seconds those of their spans."""
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

    cfg = DissectConfig(target_model="breastclip_classifier", clip_model="breastclip",
                        target_kwargs={"arch": "upmc_breast_clip_det_test_ft"},
                        target_layers=["blocks.0", "blocks.3"], d_probe="synthetic_u8",
                        concept_set=CONCEPTS, batch_size=8, resident=False, device="cpu",
                        activation_dir=str(tmp_path / "a"), result_dir=str(tmp_path / "r"))
    t0 = time.perf_counter_ns()
    logs = []
    run_dissection(cfg, probe=_probe(), dissector=dissector, log=logs.append)
    records = _since(t0)
    (job,) = [r for r in records if r.name == "dissect.job"]
    assert {r.job for r in records} == {job.job}
    stages = _children(records, job)
    assert _names(stages) == ["build.target", "dissect.harvest", "dissect.embed",
                              "dissect.text", "dissect.io", "dissect.score",
                              "dissect.results"]
    build, harvest, embed, text, load, score, results = stages
    assert _names(_children(records, harvest)) == ["harvest.wait"] * 3 + ["dissect.io"]
    assert _names(_children(records, embed)) == ["embed.wait"] * 3 + ["dissect.io"]
    assert _names(_children(records, text)) == ["text.wait", "dissect.io"]
    assert _names(_children(records, score)) == ["dissect.io", "score.wait"]
    assert len([r for r in records if r.name == "embed.assemble"]) == 3
    lines = {"[target]": build, "[harvest]": harvest, "[clip-img]": embed, "[clip-txt]": text,
             "[scoring]": score, "[results]": results}
    for prefix, stage in lines.items():
        line = next(l for l in logs if l.startswith(prefix))
        seconds = float(re.search(r"in ([0-9.]+)s", line)[1])
        assert seconds == pytest.approx(stage.seconds, abs=0.051), line
    assert re.match(r"^\[results\].* in ([0-9.]+)s$",
                    next(l for l in logs if l.startswith("[results]")))


def test_train_step_spans_its_phases():
    from mammodissect_torch.train.experiments import FinetuneConfig, build_model
    from mammodissect_torch.train.trainer import Trainer, make_optimizer

    t0 = time.perf_counter_ns()
    model = build_model(FinetuneConfig(arch="t_test_ft", img_size=(32, 24), dtype="float32",
                                       pad_mode="same", seed=1, device="cpu"))
    optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 0, 10)
    tr = Trainer(model, optimizer, scheduler, input_wire="u8", norm_mean=0.3, norm_std=0.25,
                 device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        tr.train_batch(rng.integers(0, 256, (4, 32, 24, 1), dtype=np.uint8),
                       np.array([0, 1, 0, 1], np.float32))
    records = _since(t0)
    assert [r.name for r in records if r.name.startswith("build.")] == ["build.model"]
    steps = [r for r in records if r.name == "train.step"]
    assert [r.job for r in steps] == [0, 1]
    for step in steps:
        phases = _children(records, step)
        assert _names(phases) == ["train.h2d", "train.forward", "train.backward",
                                  "train.optimizer", "train.sync"]
        assert {r.job for r in phases} == {step.job}


def test_cli_profile_prints_the_run_s_spans(tmp_path, capsys):
    from mammodissect_torch.cli.dissect import main

    rc = main(["--target_model", "tiny_cnn", "--clip_model", "random", "--target_layers",
               "blocks.0", "--d_probe", "synthetic_u8", "--batch_size", "4",
               "--probe_kwargs", '{"n": 6, "h": 40, "w": 32}', "--concept_set", CONCEPTS,
               "--device", "cpu", "--activation_dir", str(tmp_path / "a"),
               "--result_dir", str(tmp_path / "r"), "--profile", str(tmp_path / "p")])
    assert rc == 0
    out = capsys.readouterr().out
    header = next(i for i, l in enumerate(out.splitlines()) if re.match(r"span +count", l))
    rows = {l.split()[0]: l.split()[1:] for l in out.splitlines()[header + 1:]
            if l.startswith(("dissect.", "build."))}
    assert rows["dissect.job"][0] == "1"
    assert {"dissect.harvest", "dissect.text", "dissect.score", "dissect.results",
            "build.target", "build.dissector"} <= set(rows)
