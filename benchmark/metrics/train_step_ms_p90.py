"""train_step_ms_p90: the 90th percentile of the step times of the window (each step
from its call to its loss read back on the host), in ms, over every untraced step."""
from benchmark.window import percentile


def read(run):
    p = percentile(run.step_seconds, 90)
    return None if p is None else 1e3 * p
