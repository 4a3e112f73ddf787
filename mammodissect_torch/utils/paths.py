"""Output paths (counterpart of `mammodissect/utils/paths.py`, copied): the
reference's external `get_Paths`, used at
`Finetune/lumi_single_gpu_train_classifier.py:98` for
`(chk_pt_path, output_path, tb_logs_path)`."""
from __future__ import annotations

from pathlib import Path


def get_Paths(args):
    """(checkpoint_dir, output_dir, tensorboard_dir) under ``args.checkpoints`` /
    ``args.output_path`` / ``args.tensorboard_path``, each namespaced by dataset /
    arch / label as the reference's directory layout implies
    (`lumi_single_gpu_train_classifier.py:99-138` takes them as Paths); created."""
    root = Path(getattr(args, "checkpoints", "./checkpoints"))
    out_root = Path(getattr(args, "output_path", "./outputs"))
    tb_root = Path(getattr(args, "tensorboard_path", "./tb_logs"))

    dataset = getattr(args, "dataset", "dataset")
    arch = getattr(args, "arch", "arch")
    label = getattr(args, "label", "label")

    chk_pt_path = root / dataset / arch / label
    output_path = out_root / dataset / arch / label
    tb_logs_path = tb_root / dataset / arch / label
    for p in (chk_pt_path, output_path, tb_logs_path):
        p.mkdir(parents=True, exist_ok=True)
    return chk_pt_path, output_path, tb_logs_path
