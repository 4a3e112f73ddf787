"""host_waits_per_img.dissect: the host's waits for the device (`*.wait` spans: its
reads from the device and synchronizations) of a job over the job's probe images
(`benchmark/spans.py`), mean over the untraced jobs. None where no job runs or the
program keeps no spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "waits", per_image=True)
