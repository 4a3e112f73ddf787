"""stage_s_per_job.harvest: seconds a job spends in the harvest, the target's
activations over the probe (resident: the fused harvest and embed; staged: stage 1):
the spans `dissect.harvest` less the `dissect.io` spans inside them
(`benchmark/spans.py`), mean over the untraced jobs. None where the program keeps no
spans."""
from benchmark.spans import mean_per_job


def read(run):
    return mean_per_job(run, "harvest")
