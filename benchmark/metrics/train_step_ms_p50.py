"""train_step_ms_p50: the median step time of the window's untraced steps, in ms: a
steadier statistic beside the rate."""
from benchmark.window import percentile


def read(run):
    p = percentile(run.step_seconds, 50)
    return None if p is None else 1e3 * p
