"""device_idle_share.train: the device's idle share of the traced steps
(`trace.idle_share`), in %."""
from benchmark.trace import idle_share


def read(run):
    return idle_share(run)
