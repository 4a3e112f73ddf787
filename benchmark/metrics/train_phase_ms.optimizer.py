"""train_phase_ms.optimizer: ms a training step spends in AdamW's step and the
scheduler's: the spans `train.optimizer` inside `train.step` (`benchmark/spans.py`),
mean over the untraced steps. On the host's clock: while the device runs behind the
host, the phase that reads a result back takes the wait. None where no step runs or
the program keeps no spans."""
from benchmark.spans import train_phase_ms


def read(run):
    return train_phase_ms(run, "optimizer")
