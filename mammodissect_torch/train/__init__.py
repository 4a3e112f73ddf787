"""Classifier fine-tuning (counterpart of `mammodissect/train/`): losses, the
learning-rate schedule, the single-device trainer, `.pth` checkpoints, the
CSV-driven dataset and the experiment loop behind `cli.finetune`."""
