"""The CLI's `--profile` summary: device-busy time from a Chrome trace's device
events, overlapping spans counted once. Runs on the CPU on hand-written traces."""
import pytest

from mammodissect_torch.cli.dissect import device_busy


def _ev(cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur}


@pytest.mark.parametrize("events,busy_us,span_us", [
    ([], 0, 0),
    ([_ev("kernel", 10, 5)], 5, 5),
    # disjoint kernels, a copy and a memset: the gaps are idle
    ([_ev("kernel", 0, 10), _ev("gpu_memcpy", 20, 5), _ev("gpu_memset", 30, 2)], 17, 32),
    # overlapping and nested spans (two streams) count once, in any order
    ([_ev("kernel", 5, 10), _ev("kernel", 0, 10), _ev("kernel", 2, 3), _ev("kernel", 30, 1)],
     16, 31),
    # host-side events are not device time
    ([_ev("cpu_op", 0, 100), _ev("cuda_runtime", 0, 50), _ev("kernel", 60, 4)], 4, 4),
])
def test_device_busy_counts_each_device_microsecond_once(events, busy_us, span_us):
    got = device_busy(events)
    assert got["busy_s"] == pytest.approx(busy_us / 1e6)
    assert got["first_to_last_s"] == pytest.approx(span_us / 1e6)
