"""kernel2_roofline.bf16: kernel 2's least time over its measured device time, in %, for
its bf16 launches in the traced job (the dissector's bf16 tower; `trace.kernel2_roofline`)."""
from benchmark.trace import kernel2_roofline


def read(run):
    return kernel2_roofline(run, "kernel2.bf16", run.dissector_cfg, True)
