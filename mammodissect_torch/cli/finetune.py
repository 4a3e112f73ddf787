"""Fine-tune CLI of the PyTorch port (counterpart of `mammodissect/cli/finetune.py`,
the reference's `Finetune/lumi_single_gpu_train_classifier.py` flag surface, `:14-79`).

  python -m mammodissect_torch.cli.finetune --csv-file data.csv --data-dir imgs/ \
    --dataset vindr --label Mass --arch upmc_breast_clip_det_b5_period_n_ft \
    --epochs 2 --batch-size 8 --weighted-BCE y

`--device` defaults to cuda and raises without a GPU; `--device cpu` runs on the CPU.
The best checkpoint is a `.pth` under --checkpoints that the dissect CLI takes as
`--target_model breastclip_classifier --finetuned_img_classifier_chkpt <path>`.

Several GPUs: one process each, started by torchrun (NCCL on the card; gloo with
`--device cpu`); every rank trains on its slice of each epoch, `--batch-size` rows a
rank, and the first rank writes the outputs:

  torchrun --nproc_per_node 2 -m mammodissect_torch.cli.finetune ... --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

# the reference's per-task BCE pos-weights (`lumi_single_gpu_train_classifier.py:156-184`)
DEFAULT_BCE_WEIGHTS = {
    ("rsna", "cancer"): {f"fold{i}": w for i, w in enumerate([46.48, 46.49, 46.45, 46.53])},
    ("vindr", "Mass"): {"fold0": 15.573306370070778},
    ("vindr", "Suspicious_Calcification"): {"fold0": 37.296728971962615},
    ("vindr", "Focal_Asymmetry"): {"fold0": 74.88405797101449},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mammo-CLIP classifier fine-tune (PyTorch, CUDA)")
    p.add_argument("--csv-file", "--csv_file", dest="csv_file", required=True)
    p.add_argument("--data-dir", "--data_dir", dest="data_dir", default="")
    p.add_argument("--image-col", dest="image_col", default="image_path")
    p.add_argument("--dataset", default="vindr", choices=["vindr", "rsna", "csaw"])
    p.add_argument("--label", default="cancer")
    p.add_argument("--arch", default="upmc_breast_clip_det_b5_period_n_ft")
    p.add_argument("--clip-chk-pt-path", dest="clip_chk_pt_path", default=None)
    p.add_argument("--checkpoints", default="./checkpoints")
    p.add_argument("--output-path", dest="output_path", default="./outputs")
    p.add_argument("--tensorboard-path", dest="tensorboard_path", default="./tb_logs")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", "--batch_size", dest="batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=5.0e-5)
    p.add_argument("--weight-decay", dest="weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup-epochs", dest="warmup_epochs", type=float, default=1)
    p.add_argument("--img-size", dest="img_size", type=int, nargs=2, default=[1520, 912])
    p.add_argument("--mean", type=float, default=0.3089279)
    p.add_argument("--std", type=float, default=0.25053555)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--n-folds", dest="n_folds", type=int, default=1)
    p.add_argument("--weighted-BCE", dest="weighted_BCE", default="n", choices=["y", "n"])
    p.add_argument("--balanced-dataloader", dest="balanced_dataloader", default="n",
                   choices=["y", "n"])
    p.add_argument("--sampler-weights", dest="sampler_weights", type=str, default="{}")
    p.add_argument("--data-frac", dest="data_frac", type=float, default=1.0)
    p.add_argument("--running-interactive", dest="running_interactive", action="store_true")
    p.add_argument("--inference-mode", dest="inference_mode", default="n",
                   choices=["n", "y", "load", "train_un_mammopretrained"])
    p.add_argument("--finetuned-ckpt-path", dest="finetuned_ckpt_path", default=None)
    p.add_argument("--resume-from", dest="resume_from", default=None,
                   help="checkpoint (.pth) to resume training from (weights, optimizer, epoch)")
    p.add_argument("--model-parallel", dest="model_parallel", type=int, default=1,
                   help="ranks of the mesh's model axis (needs torchrun's process group); "
                        "the classifier has no split parameter, so they share data slices")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="compute dtype; parameters and optimizer state stay float32")
    p.add_argument("--pad-mode", "--pad_mode", dest="pad_mode", default="static",
                   choices=["static", "same"],
                   help="conv padding: 'static' reproduces torch TF-SAME at the B5 "
                        "geometry; 'same' for toy geometries far from the traced chain")
    p.add_argument("--input-wire", "--input_wire", dest="input_wire", default="u8",
                   choices=["u8", "f32"],
                   help="host-to-device image wire: 'u8' ships post-transform uint8 "
                        "batches (4x fewer bytes; min-max + mean/std on the device); "
                        "'f32' ships host-normalized floats")
    p.add_argument("--bn-momentum", dest="bn_momentum", type=float, default=0.99,
                   help="lower (e.g. 0.9) for short runs so BN running stats converge")
    p.add_argument("--print-freq", dest="print_freq", type=int, default=50)
    p.add_argument("--log-freq", dest="log_freq", type=int, default=10)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    from mammodissect_torch.device import resolve_device
    from mammodissect_torch.parallel.mesh import is_master
    from mammodissect_torch.parallel.multihost import initialize
    from mammodissect_torch.train.experiments import FinetuneConfig, do_experiments

    args = build_parser().parse_args(argv)
    initialize(device=str(resolve_device(args.device)))  # torchrun's ranks, if any
    cfg = FinetuneConfig(
        csv_file=args.csv_file,
        data_dir=args.data_dir,
        image_col=args.image_col,
        dataset=args.dataset,
        label=args.label,
        arch=args.arch,
        clip_chk_pt_path=args.clip_chk_pt_path,
        checkpoints=args.checkpoints,
        output_path=args.output_path,
        tensorboard_path=args.tensorboard_path,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs,
        img_size=tuple(args.img_size),
        mean=args.mean,
        std=args.std,
        seed=args.seed,
        n_folds=args.n_folds,
        weighted_BCE=args.weighted_BCE,
        BCE_weights=DEFAULT_BCE_WEIGHTS.get((args.dataset, args.label), {}),
        balanced_dataloader=args.balanced_dataloader,
        sampler_weights={int(k): v for k, v in json.loads(args.sampler_weights).items()},
        data_frac=args.data_frac,
        running_interactive=args.running_interactive,
        inference_mode=args.inference_mode,
        finetuned_ckpt_path=args.finetuned_ckpt_path,
        resume_from=args.resume_from,
        model_parallel=args.model_parallel,
        dtype=args.dtype,
        pad_mode=args.pad_mode,
        input_wire=args.input_wire,
        bn_momentum=args.bn_momentum,
        print_freq=args.print_freq,
        log_freq=args.log_freq,
        wandb=args.wandb,
        device=args.device,
    )
    oof = do_experiments(cfg, log=print if is_master() else (lambda *_: None))
    if is_master():
        print(f"done: {len(oof)} out-of-fold predictions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
