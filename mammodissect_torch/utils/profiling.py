"""Profiling and debug hooks (counterpart of `mammodissect/utils/profiling.py`).

- `trace(logdir)`: a torch.profiler run (the CPU, and the GPU when there is one)
  whose Chrome trace is written to `logdir/trace.json`; yields the profiler.
- `annotate(name)`: a labelled range inside a trace (`record_function`).
- `enable_debug_nans()`: the counterpart of `jax_debug_nans`: a forward hook on
  every module raises FloatingPointError at the first module whose output holds a
  NaN or an Inf, naming it (`torch.autograd.set_detect_anomaly` checks only the
  backward). Each check reads the result back to the host: a debugging mode.
- `PhaseTimer`: wall-clock seconds per named phase (copied).
"""
from __future__ import annotations

import contextlib
import os
import time
import weakref
from typing import Dict, Iterator

import torch
from torch import nn

TRACE_FILE = "trace.json"


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


def annotate(name: str):
    return torch.profiler.record_function(name)


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
