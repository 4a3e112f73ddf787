"""kernel1_roofline: kernel 1's least time (`flops.kernel1_bound` at the job's units,
concepts, top_k and images) over its measured device time in the traced job, in %."""
from benchmark.flops import kernel1_bound


def read(run):
    sl = run.trace
    if sl is None or not sl.launches.get("kernel1") or sl.classes.get("kernel1", 0.0) <= 0:
        return None
    t = run.ctx.traffic
    units = sum(run.widths)
    bound = kernel1_bound(units, run.n_concepts, t["top_k"], t["images_per_job"])
    least = sl.launches["kernel1"] * bound["seconds"]
    return {"value": 100.0 * least / sl.classes["kernel1"], "bound_by": bound["by"],
            "card": run.power}
