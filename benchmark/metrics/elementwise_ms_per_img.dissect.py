"""elementwise_ms_per_img.dissect: device ms an image, in the traced job, in kernels
whose ATen op is an elementwise op, a copy or a cast (`trace.ELEMENTWISE`)."""
from benchmark.trace import ELEMENTWISE, ms_per_image


def read(run):
    return ms_per_image(run, ELEMENTWISE)
