"""elementwise_ms_per_img.train: device ms an image, in the traced steps (forward,
backward and optimizer), in kernels whose ATen op is an elementwise op, a copy or a
cast (`trace.ELEMENTWISE`)."""
from benchmark.trace import ELEMENTWISE, ms_per_image


def read(run):
    return ms_per_image(run, ELEMENTWISE)
