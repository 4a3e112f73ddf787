"""conv_ms_per_img.dissect: device ms an image, in the traced job, under
`aten::cudnn_convolution` / `aten::_convolution` (`trace.CONVOLUTIONS`)."""
from benchmark.trace import CONVOLUTIONS, ms_per_image


def read(run):
    return ms_per_image(run, CONVOLUTIONS)
