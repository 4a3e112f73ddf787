"""Progress meters (a copy of `mammodissect/utils/meters.py`): the reference's missing
external `utils` members `AverageMeter` and `timeSince` (`Classifiers/experiments.py:20,377,455`)."""
from __future__ import annotations

import math
import time


class AverageMeter:
    """Tracks current value, running sum, count and average (torch-utils idiom)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def asMinutes(s: float) -> str:
    m = math.floor(s / 60)
    s -= m * 60
    return "%dm %ds" % (m, s)


def timeSince(since: float, percent: float) -> str:
    """Elapsed / remaining-time string given start timestamp and completed fraction."""
    now = time.time()
    s = now - since
    es = s / max(percent, 1e-12)
    rs = es - s
    return "%s (remain %s)" % (asMinutes(s), asMinutes(rs))
