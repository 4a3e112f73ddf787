"""stage_s_per_job.embed: seconds a job spends in the staged path's stage 2, the
dissector's probe embeddings: the spans `dissect.embed` less the `dissect.io` spans
inside them (`benchmark/spans.py`), mean over the untraced jobs. None where the stage
does not run (the resident path) or the program keeps no spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "embed")
