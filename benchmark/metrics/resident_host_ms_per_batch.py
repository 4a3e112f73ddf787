"""resident_host_ms_per_batch: the program's own per-batch host seconds of the resident
harvest (`run_dissection(timing=...)`: assemble_s + put_s + step_s), mean over the
batches of the untraced jobs, in ms. None on the staged path, which keeps none."""


def read(run):
    rows = [r for u in run.window.untraced() for r in u.out["timing"]]
    if not rows:
        return None
    return 1e3 * sum(r["assemble_s"] + r["put_s"] + r["step_s"] for r in rows) / len(rows)
