"""stage_s_per_job.text: seconds a job spends in the text tower, the concepts'
embeddings: the spans `dissect.text` less the `dissect.io` spans inside them
(`benchmark/spans.py`), mean over the untraced jobs. None where the program keeps no
spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "text")
