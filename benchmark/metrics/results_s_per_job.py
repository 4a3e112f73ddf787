"""results_s_per_job: seconds of the engine's results stage (each unit's top concepts
and top images, the CSV), from its `[results] ... in X s` log line, mean over the
untraced jobs. None where no job logs the stage (the resident path)."""
import re

_LINE = re.compile(r"^\[results\].* in ([0-9.]+)s$")


def read(run):
    secs = [float(m.group(1)) for u in run.window.untraced() for line in u.out["logs"]
            for m in [_LINE.match(line)] if m]
    return sum(secs) / len(secs) if secs else None
