"""stage_s_per_job.score: seconds a job spends scoring, soft-WPMI of every unit
against every concept and the top concepts and images on the device: the spans
`dissect.score` less the `dissect.io` spans inside them (`benchmark/spans.py`), mean
over the untraced jobs. None where the program keeps no spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "score")
