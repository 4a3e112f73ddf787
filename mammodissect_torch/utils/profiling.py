"""Spans, profiling and debug hooks (counterpart of `mammodissect/utils/profiling.py`).

- `span(name, job=None)`: records one span of the program: its name, its start and
  end on `time.perf_counter_ns()` (the clock of the benchmark's window), the span open
  around it on the same thread (`parent`), the thread, and a `job` id that every span
  of one unit of work shares (a `run_dissection` call, a `Trainer.train_batch` step).
  A span given no `job` takes its parent's; `new_job()` draws a fresh id and
  `current_job()` reads the innermost open span's, for a thread the unit starts. Spans
  are always on. While a `torch.profiler` session is active each span is also a
  `record_function` range of its name, so it shows in the profiler's events and in a
  Chrome trace on the trace's clock; with no profiler active no range is opened. A
  span whose name ends in `.wait` marks the host blocked on the device (a `.cpu()`,
  `.item()`, `float(tensor)` or `torch.cuda.synchronize`): their count is the host's
  syncs, their durations the time it waited.
- `spans()`: the finished spans (`SpanRecord`), oldest first, from a ring that keeps
  the newest `RING_SIZE` and is written from every thread; `last(name)`: the newest
  of `name` finished on this thread; `clock_offset_ns()`: what to add to a span's
  stamps to put them on the profiler's clock (kineto stamps its events in Unix-epoch
  ns); `span_table(records)`: per name, the count, total and self seconds.
- `kernel_range(name)`: a `record_function` range around a hand kernel's launch while
  a profiler is active, and nothing otherwise (it is not a span and not in the ring).
- `trace(logdir)`: a torch.profiler run (the CPU, and the GPU when there is one)
  whose Chrome trace is written to `logdir/trace.json`; yields the profiler.
- `enable_debug_nans()`: the counterpart of `jax_debug_nans`: a forward hook on
  every module raises FloatingPointError at the first module whose output holds a
  NaN or an Inf, naming it (`torch.autograd.set_detect_anomaly` checks only the
  backward). Each check reads the result back to the host: a debugging mode.
- `PhaseTimer`: wall-clock seconds per named phase (copied).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch import nn

TRACE_FILE = "trace.json"
RING_SIZE = 1 << 16  # spans kept: a dissection job records a few hundred


class SpanRecord(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # the id of the span open around it on its thread
    job: Optional[int]
    thread: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_ring: deque = deque(maxlen=RING_SIZE)  # append and copy are atomic: no lock
_span_ids = itertools.count()
_job_ids = itertools.count()
_local = threading.local()  # .stack: the thread's open spans, innermost last
_now_ns = time.perf_counter_ns
_thread_id = threading.get_ident
_new_record = tuple.__new__
_NO_RANGE = contextlib.nullcontext()


class span:
    """`with span(name) as s:` records a span of `name` when the block ends (see the
    module's docstring); `s.seconds` is its length so far, or its whole length after."""

    __slots__ = ("name", "job", "id", "parent", "start", "end", "_range")

    def __init__(self, name: str, job: Optional[int] = None):
        self.name, self.job = name, job
        self.start = self.end = None

    def __enter__(self) -> "span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        if stack:
            outer = stack[-1]
            self.parent = outer.id
            if self.job is None:
                self.job = outer.job
        else:
            self.parent = None
        self.id = next(_span_ids)
        stack.append(self)
        self._range = None
        # the stamps lie outside the profiler's range: its event lies within the span
        self.start = _now_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self.end = _now_ns()
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        else:  # closed out of order (a generator's span resumed elsewhere)
            stack.remove(self)
        _ring.append(_new_record(SpanRecord, (self.id, self.name, self.start, self.end,
                                              self.parent, self.job, _thread_id())))
        return False

    @property
    def seconds(self) -> float:
        return ((self.end if self.end is not None else _now_ns()) - self.start) / 1e9


def new_job() -> int:
    """A fresh job id."""
    return next(_job_ids)


def current_job() -> Optional[int]:
    """The job of the innermost span open on this thread (None outside any span)."""
    stack = getattr(_local, "stack", None)
    return stack[-1].job if stack else None


def spans() -> List[SpanRecord]:
    """The finished spans the ring holds, oldest first."""
    return list(_ring.copy())


def last(name: str) -> Optional[SpanRecord]:
    """The newest span of `name` finished on this thread, or None."""
    me = _thread_id()
    return next((r for r in reversed(_ring.copy()) if r.name == name and r.thread == me), None)


def clock_offset_ns() -> int:
    """Nanoseconds to add to a span's stamps to put them on the profiler's clock
    (Unix-epoch ns, `time.time_ns()`): the tightest of a few paired reads."""
    best = None
    for _ in range(5):
        t0 = _now_ns()
        wall = time.time_ns()
        t1 = _now_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, wall - (t0 + t1) // 2)
    return best[1]


def span_table(records: Iterable[SpanRecord]) -> str:
    """Per span name, largest total first: the count, the total seconds and the self
    seconds (each span less the spans directly inside it on its thread)."""
    records = list(records)
    inner: Dict[int, int] = {}
    for r in records:
        if r.parent is not None:
            inner[r.parent] = inner.get(r.parent, 0) + r.end_ns - r.start_ns
    rows: Dict[str, list] = {}
    for r in records:
        row = rows.setdefault(r.name, [0, 0, 0])
        row[0] += 1
        row[1] += r.end_ns - r.start_ns
        row[2] += r.end_ns - r.start_ns - inner.get(r.id, 0)
    width = max([len("span")] + [len(n) for n in rows])
    lines = [f"{'span':<{width}} {'count':>7} {'total s':>10} {'self s':>10}"]
    for name, (n, total, own) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<{width}} {n:>7} {total / 1e9:>10.3f} {own / 1e9:>10.3f}")
    return "\n".join(lines)


def kernel_range(name: str):
    """A `record_function` range of `name` while a profiler is active, else a context
    that does nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(tp.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tp.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


_NAN_HOOKS: list = []
_NAMES: "weakref.WeakKeyDictionary[nn.Module, str]" = weakref.WeakKeyDictionary()


def _name_modules(module: nn.Module, _inputs) -> None:
    """Pre-hook: the first (outermost) module entered names its submodules."""
    if module not in _NAMES:
        for name, m in module.named_modules():
            _NAMES.setdefault(m, name or type(m).__name__)


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def _check_output(module: nn.Module, _inputs, output) -> None:
    for t in _tensors(output):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            name = _NAMES.get(module, type(module).__name__)
            raise FloatingPointError(
                f"NaN or Inf in the output of module {name!r} ({type(module).__name__})")


def enable_debug_nans(enable: bool = True) -> None:
    """Install (or with False remove) the NaN/Inf check on every module's forward."""
    while _NAN_HOOKS:
        _NAN_HOOKS.pop().remove()
    if enable:
        _NAN_HOOKS.append(nn.modules.module.register_module_forward_pre_hook(_name_modules))
        _NAN_HOOKS.append(nn.modules.module.register_module_forward_hook(_check_output))


class PhaseTimer:
    """Accumulates wall-clock per named phase; `report()` returns {phase: seconds}."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> Dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
