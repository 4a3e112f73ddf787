"""conv_ms_per_img.train: device ms an image, in the traced steps, in cuDNN's forward
and backward convolutions (`trace.CONVOLUTIONS`)."""
from benchmark.trace import CONVOLUTIONS, ms_per_image


def read(run):
    return ms_per_image(run, CONVOLUTIONS)
