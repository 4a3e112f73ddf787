"""The measured window of a closed loop with one client.

Units of work (dissection jobs, training steps) start back to back from the
window's start. None starts once `seconds` have passed; the window ends when the
last one that started has ended. Rates take all the work over the whole window;
percentiles take every unit of the window."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


@dataclass
class Unit:
    index: int
    start: float
    end: float
    work: int  # images of the job or the step
    out: object = None
    traced: bool = False

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    start: float
    end: float
    units: List[Unit] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def rate(self) -> float:
        """All the work of the window over the whole window."""
        return sum(u.work for u in self.units) / self.seconds

    def untraced(self) -> List[Unit]:
        """The units that ran without the profiler (all of them, if every one did)."""
        plain = [u for u in self.units if not u.traced]
        return plain or list(self.units)


def closed_loop(run: Callable[[int, bool], tuple], seconds: float, trace_units: int = 0,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run `run(i, traced) -> (work, out)` back to back until `seconds` have passed
    at a unit's start; the first `trace_units` units run traced."""
    window = Window(start=clock(), end=0.0)
    i = 0
    while True:
        start = clock()
        if i and start - window.start >= seconds:
            break
        traced = i < trace_units
        work, out = run(i, traced)
        window.units.append(Unit(i, start, clock(), work, out, traced))
        i += 1
    window.end = window.units[-1].end
    return window


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100), linear between the closest ranks (numpy's
    default rule); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
