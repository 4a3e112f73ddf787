"""stage_s_per_job.other: seconds a job spends outside its stages, the self time of
`dissect.job` (its length less the spans directly inside it; `benchmark/spans.py`),
mean over the untraced jobs. None where the program keeps no spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "other")
