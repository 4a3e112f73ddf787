"""mfu.train: the least time of the untraced steps' training FLOPs (3x the forward of
the tower and the head, at the bf16 peak; `flops.train_step_seconds`) over those
steps' wall time, in %."""
from benchmark.flops import train_step_seconds


def read(run):
    if not run.step_seconds:
        return None
    least = train_step_seconds(run.target_cfg, run.ctx.traffic["batch_size"])
    return 100.0 * least * len(run.step_seconds) / sum(run.step_seconds)
