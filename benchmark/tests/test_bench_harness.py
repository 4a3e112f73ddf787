"""The harness's frame: files found by name, the result line, the refusals, and
what the benchmark imports."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests import _tiny
from benchmark import core

BENCH = core.BENCH_DIR


def test_dropped_in_config_traffic_and_metric_are_found(tmp_path, monkeypatch):
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new_model.json").write_text(json.dumps({"width": 3}))
    (tmp_path / "traffic" / "new_mix.json").write_text(json.dumps({"kind": "dissect_jobs"}))
    (tmp_path / "metrics" / "new_metric.x.py").write_text("def read(run):\n    return run * 2\n")
    monkeypatch.setattr(core, "BENCH_DIR", str(tmp_path))
    assert core.load_config("new_model") == {"width": 3}
    assert core.read_json(core.bench_path("traffic", "new_mix.json"))["kind"] == "dissect_jobs"
    reader = core.load_module(core.bench_path("metrics", "new_metric.x.py"), "m_new")
    assert reader.read(21) == 42
    bench = {"end_to_end": [{"name": "a", "workloads": ["c1"]}, {"name": "s"}],
             "per_layer": [{"name": "new_metric.x", "moves": "a", "workloads": ["c1"]},
                           {"name": "every", "moves": "s"}, {"name": "other", "moves": "a",
                                                             "workloads": ["c2"]}]}
    assert [m["name"] for m in core.cell_metrics(bench, "c1", False)] == ["a", "s"]
    assert [m["name"] for m in core.cell_metrics(bench, "c1", True)] == ["new_metric.x", "every"]
    assert [m["name"] for m in core.cell_metrics(bench, "c2", True)] == ["every", "other"]


def test_every_listed_file_exists():
    bench = core.read_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(core.ROOT, c["file"]))
    for w in bench["workloads"]:
        traffic = core.read_json(core.bench_path("traffic", f"{w['traffic']}.json"))
        assert os.path.exists(core.bench_path("drivers", f"{traffic['kind']}.py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(core.bench_path("metrics", f"{m['name']}.py")), m["name"]


def test_trace_readers_read_one_slice_alike():
    """The per-layer readers of the traced slice: each pair of `.dissect` and `.train`
    readers gives one number on one slice, counting the traced units' images; every
    reader gives nothing without a trace."""
    from types import SimpleNamespace

    from benchmark import flops, trace, window

    cfg = core.load_config("mammoclip_b5_bf16")
    sl = trace.Slice(wall_s=2.0, busy_s=1.5, events=10,
                     classes={"copies and casts": 0.3, "products and sums": 0.1,
                              "convolutions (cuDNN)": 0.2, "kernel2.bf16": 0.5},
                     launches={"kernel2.bf16": 64})
    win = window.Window(0.0, 3.0, [window.Unit(0, 0.0, 2.0, 16, traced=True),
                                   window.Unit(1, 2.0, 3.0, 16)])
    run = SimpleNamespace(trace=sl, window=win, ctx=SimpleNamespace(traffic={"batch_size": 16}),
                          dissector_cfg=cfg, target_cfg=cfg, power="card")

    def read(name):
        path = core.bench_path("metrics", f"{name}.py")
        return core.load_module(path, "test_" + name.replace(".", "_")).read(run)

    for kind in ("dissect", "train"):
        assert read(f"elementwise_ms_per_img.{kind}") == pytest.approx(1e3 * 0.4 / 16)
        assert read(f"conv_ms_per_img.{kind}") == pytest.approx(1e3 * 0.2 / 16)
        assert read(f"device_idle_share.{kind}") == pytest.approx(25.0)
    forward = flops.kernel2_forward(cfg, 16, True)
    assert forward["launches"] == 32
    got = read("kernel2_roofline.bf16")
    assert got["value"] == pytest.approx(100.0 * 2 * forward["seconds"] / 0.5)
    assert got["bound_by"] == forward["by"] and got["card"] == "card"
    assert read("kernel2_roofline.fp32") is None  # no fp32 launch in the slice
    run.trace = None
    for name in ("elementwise_ms_per_img.dissect", "conv_ms_per_img.train",
                 "device_idle_share.dissect", "kernel2_roofline.bf16", "kernel1_roofline"):
        assert read(name) is None, name


@pytest.fixture(scope="module")
def tiny_line(tmp_path_factory):
    concepts = _tiny.concept_file(tmp_path_factory.mktemp("c"))
    line = core.run(7, "mdissect_b5_resident", 0.1, False, 0.0, device=torch.device("cpu"),
                    configs=_tiny.configs(),
                    traffic=_tiny.traffic("mdissect_b5_resident", concepts))
    return line


def test_result_line_keys(tiny_line):
    line = tiny_line
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"dissect_img_per_s", "setup_s"}  # no peak off the card
    for m in line["metrics"].values():
        assert set(m) >= {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(line)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    rc = core.main(["--workload", "mdissect_b5_resident", "--seed", "1", "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_only_benchmark_files_gives_no_result(tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "mdissect_b5_resident", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={k: v for k, v in os.environ.items()
                                            if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_forbidden_import_in_any_source():
    for path in _sources():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in core.FORBIDDEN, (path, name)
                if os.sep + "reference" + os.sep in path:
                    assert name.split(".")[0] != "mammodissect_torch", (path, name)


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            yield node.body[0].value


def test_reads_nothing_of_the_old_measuring_scripts():
    """No import of chip_smoke, tools or bench, and no string in the code (docstrings
    aside) that names them or the JAX package's BENCH_*.json."""
    banned = ("chip_smoke", "tools/", "bench.py", "BENCH_")
    this = os.path.abspath(__file__)
    for path in _sources():
        if os.path.abspath(path) == this:
            continue
        tree = ast.parse(open(path).read())
        docs = set(map(id, _docstrings(tree)))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not {a.name.split(".")[0] for a in node.names} & {"chip_smoke", "tools", "bench"}
            elif isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.split(".")[0] not in ("chip_smoke", "tools", "bench")
            elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert not any(w in node.value for w in banned), (path, node.value)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mammodissect_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert core.forbidden_modules() == ["flax"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = ("import sys, torch; sys.path.insert(0, %r); from benchmark.tests import _tiny; "
            "from benchmark import core; import pathlib; "
            "p = pathlib.Path(%r); c = _tiny.concept_file(p); "
            "core.run(5, 'cdissect_b5_staged', 0.1, True, 0.0, device=torch.device('cpu'), "
            "configs=_tiny.configs(), traffic=_tiny.traffic('cdissect_b5_staged', c)); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(core.FORBIDDEN)))"
            % (core.ROOT, str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
