"""kernel2_roofline.fp32: kernel 2's least time over its measured device time, in %, for
its float32 launches in the traced job (the C-dissect target's tower;
`trace.kernel2_roofline`)."""
from benchmark.trace import kernel2_roofline


def read(run):
    return kernel2_roofline(run, "kernel2.fp32", run.target_cfg, False)
