"""mfu.dissect: the least time of the untraced jobs' model FLOPs, each part at the peak
of the dtype its configuration states (`flops.dissect_job_seconds`), over those jobs'
wall time, in %."""
from benchmark.flops import dissect_job_seconds


def read(run):
    units = run.window.untraced()
    t = run.ctx.traffic
    least = dissect_job_seconds(run.target_cfg, run.dissector_cfg, t["images_per_job"],
                                run.n_concepts, t["top_k"], run.staged)
    return 100.0 * least * len(units) / sum(u.seconds for u in units)
