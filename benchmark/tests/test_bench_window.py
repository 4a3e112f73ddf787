"""The window's arithmetic: a closed loop on a fake clock."""
from __future__ import annotations

from benchmark.tests import _tiny  # noqa: F401  (puts the repo on sys.path)
from benchmark.window import closed_loop, percentile


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def loop(durations, seconds, work=16, trace_units=0):
    clock = FakeClock()
    seen = []

    def run(i, traced):
        seen.append(traced)
        clock.t += durations[i]
        return work, i

    return closed_loop(run, seconds, trace_units, clock=clock), seen


def test_rate_is_all_work_over_the_whole_window_with_the_straddling_job():
    window, _ = loop([3.0, 4.0, 5.0, 6.0], seconds=10.0)
    # jobs start at 0, 3 and 7 s; the third straddles the deadline and counts whole;
    # none starts at 12 s
    assert [u.index for u in window.units] == [0, 1, 2]
    assert window.seconds == 12.0
    assert window.rate() == 3 * 16 / 12.0


def test_first_unit_always_runs_and_a_unit_at_the_deadline_does_not_start():
    window, _ = loop([20.0, 1.0], seconds=10.0)
    assert len(window.units) == 1 and window.seconds == 20.0
    window, _ = loop([5.0, 5.0, 1.0], seconds=10.0)
    assert len(window.units) == 2  # the third would start at exactly 10 s


def test_traced_units_are_the_first_and_untraced_excludes_them():
    window, seen = loop([1.0] * 5, seconds=4.5, trace_units=1)
    assert seen == [True, False, False, False, False]
    assert [u.index for u in window.untraced()] == [1, 2, 3, 4]
    window, _ = loop([9.0], seconds=4.0, trace_units=1)
    assert [u.index for u in window.untraced()] == [0]


def test_p90_takes_every_step_of_the_window():
    durations = [0.2] * 9 + [1.0]
    window, _ = loop(durations, seconds=2.75)  # the tenth step starts at 1.8 s
    steps = [u.seconds for u in window.units]
    assert len(steps) == 10
    # numpy's linear rule: position 0.9 * 9 = 8.1 between the 9th (0.2) and 10th (1.0)
    assert abs(percentile(steps, 90) - (0.2 + 0.1 * 0.8)) < 1e-9
    assert percentile([3.0], 90) == 3.0 and percentile([], 90) is None
