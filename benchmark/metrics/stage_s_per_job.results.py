"""stage_s_per_job.results: seconds a job spends on its results, each unit's top
concepts and images on the host and the CSV: the spans `dissect.results`
(`benchmark/spans.py`), mean over the untraced jobs. None where the program keeps no
spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "results")
