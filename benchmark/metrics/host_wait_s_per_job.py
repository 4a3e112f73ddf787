"""host_wait_s_per_job: seconds a job in which the host waits for the device: the
summed `*.wait` spans of the job (`benchmark/spans.py`), mean over the untraced jobs.
None where no job runs or the program keeps no spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "wait_s")
