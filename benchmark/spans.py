"""The program's own spans (`mammodissect_torch.utils.profiling.spans`), read after the
window from its in-memory ring.

A span's stamps are `time.perf_counter_ns()`, the clock of the window's units
(`time.perf_counter()`), so a unit's spans are those that start and end within the
unit. The readers take the untraced units (the traced one runs under the profiler,
whose ranges slow each span). Everything here returns None where the program keeps
no spans (a checkout that predates them) or where the ring has dropped spans since
the time it is asked from."""
from __future__ import annotations

from typing import Dict, List, Optional

STAGES = ("harvest", "embed", "text", "score", "results", "io")


def program_spans(since_s: float) -> Optional[list]:
    """The program's spans, or None where it keeps none or the ring, full, has dropped
    spans that ended after `since_s` (seconds on `time.perf_counter`'s clock)."""
    try:
        from mammodissect_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    records = read()
    if not records:
        return None
    if len(records) >= profiling.RING_SIZE and records[0].end_ns > since_s * 1e9:
        return None
    return records


def per_unit(run) -> Optional[List[list]]:
    """For each untraced unit of the window, the spans that lie within the unit's
    [start, end]; None as `program_spans` from the window's start."""
    records = program_spans(run.window.start)
    if records is None:
        return None
    out = []
    for u in run.window.untraced():
        lo, hi = u.start * 1e9, u.end * 1e9
        out.append([r for r in records if r.start_ns >= lo and r.end_ns <= hi])
    return out


def _seconds(r) -> float:
    return (r.end_ns - r.start_ns) / 1e9


def _stage_of(r, by_id) -> Optional[str]:
    """The stage of the nearest `dissect.<stage>` span around `r` other than I/O."""
    parent = by_id.get(r.parent)
    while parent is not None:
        stage = parent.name[len("dissect."):] if parent.name.startswith("dissect.") else None
        if stage in STAGES and stage != "io":
            return stage
        parent = by_id.get(parent.parent)
    return None


def dissect_job(records) -> Optional[Dict[str, float]]:
    """One unit's `dissect.job` spans, summed: each stage's seconds (its `dissect.<stage>`
    spans less the `dissect.io` spans inside them, which count as `io`), `other` (the
    job's self time: its length less the spans directly inside it), `wait_s` and
    `waits` (the `*.wait` spans of the job, on any thread). Stages that did not run are
    absent; None where the unit holds no job."""
    jobs = [r for r in records if r.name == "dissect.job"]
    if not jobs:
        return None
    ids = {r.job for r in jobs}
    by_id = {r.id: r for r in records}
    out: Dict[str, float] = {"other": 0.0, "wait_s": 0.0, "waits": 0}
    for r in records:
        if r.job not in ids:
            continue
        if r.name == "dissect.io":
            out["io"] = out.get("io", 0.0) + _seconds(r)
            stage = _stage_of(r, by_id)
            if stage is not None:
                out[stage] = out.get(stage, 0.0) - _seconds(r)
        elif r.name.startswith("dissect.") and r.name[len("dissect."):] in STAGES:
            stage = r.name[len("dissect."):]
            out[stage] = out.get(stage, 0.0) + _seconds(r)
        elif r.name.endswith(".wait"):
            out["wait_s"] += _seconds(r)
            out["waits"] += 1
    for job in jobs:
        inner = sum(_seconds(r) for r in records if r.parent == job.id)
        out["other"] += _seconds(job) - inner
    return out


def mean_per_job(run, key: str, per_image: bool = False) -> Optional[float]:
    """The mean over the untraced jobs of `dissect_job(...)[key]` (over the job's images
    with `per_image`); None where no job holds it."""
    units = per_unit(run)
    if units is None:
        return None
    values = []
    for u, records in zip(run.window.untraced(), units):
        job = dissect_job(records)
        if job is not None and key in job:
            values.append(job[key] / u.work if per_image else job[key])
    return sum(values) / len(values) if values else None


def train_phase_ms(run, phase: str) -> Optional[float]:
    """The mean over the untraced units holding a `train.step` of the unit's
    `train.<phase>` seconds per step, in ms; None where no unit holds a step."""
    units = per_unit(run)
    if units is None:
        return None
    values = []
    for records in units:
        steps = sum(1 for r in records if r.name == "train.step")
        if steps:
            values.append(sum(_seconds(r) for r in records if r.name == f"train.{phase}") / steps)
    return 1e3 * sum(values) / len(values) if values else None


def build_seconds(run) -> Optional[float]:
    """Seconds of the `build.*` spans that start after the process's start and end
    before the window's, each counted once (none inside another); None where there is
    none or the ring has dropped spans since the process's start."""
    records = program_spans(run.ctx.t_start)
    if records is None:
        return None
    lo, hi = run.ctx.t_start * 1e9, run.window.start * 1e9
    by_id = {r.id: r for r in records}

    def inside_build(r):
        parent = by_id.get(r.parent)
        while parent is not None:
            if parent.name.startswith("build."):
                return True
            parent = by_id.get(parent.parent)
        return False

    builds = [r for r in records if r.name.startswith("build.") and r.start_ns >= lo
              and r.end_ns <= hi and not inside_build(r)]
    return sum(_seconds(r) for r in builds) if builds else None
