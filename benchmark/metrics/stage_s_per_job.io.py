"""stage_s_per_job.io: seconds a job spends in the staged path's cache I/O, every
save and load of activations and embeddings: the spans `dissect.io`, inside a stage or
not (`benchmark/spans.py`), mean over the untraced jobs. None where the stage does not
run (the resident path) or the program keeps no spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "io")
