"""Contrastive pretraining CLI of the PyTorch port (counterpart of
`mammodissect/cli/pretrain.py`: the same flags, plus `--device`).

  python -m mammodissect_torch.cli.pretrain --csv-file data.csv --root imgs/ \
    --epochs 1 --batch-size 4

`--device` defaults to cuda and raises without a GPU; `--device cpu` runs on the CPU.
Without `--prompts-json`, finding-labelled CSVs generate their reports from the
canonical prompt templates, read by path from the JAX package's data files
(`mammodissect/assets/dataset/prompts.json`). Writes `step_{n}.pth` / `final.pth`
under --checkpoints (the first rank) and prints the result as one JSON line.

Several GPUs: one process each, started by torchrun, which sets the ranks
(`parallel.multihost.initialize` reads them; NCCL on the card, gloo with
`--device cpu`). `--model-parallel N` splits BERT and the projection heads over N
ranks and needs that process group:

  torchrun --nproc_per_node 2 -m mammodissect_torch.cli.pretrain ... --model-parallel 2
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

PROMPTS_JSON = (Path(__file__).resolve().parents[2] / "mammodissect" / "assets" / "dataset"
                / "prompts.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mammo-CLIP contrastive pretraining (PyTorch, CUDA)")
    p.add_argument("--csv-file", dest="csv_file", required=True)
    p.add_argument("--root", default="")
    p.add_argument("--img-dir", dest="img_dir", default="")
    p.add_argument("--dataset", default="vindr", choices=["vindr", "upmc"])
    p.add_argument("--prompts-json", dest="prompts_json", default=None)
    p.add_argument("--vocab-file", dest="vocab_file", default=None)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5.0e-5)
    p.add_argument("--weight-decay", dest="weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup-steps", dest="warmup_steps", type=int, default=100)
    p.add_argument("--img-size", dest="img_size", type=int, nargs=2, default=[1520, 912])
    p.add_argument("--i2i-weight", dest="i2i_weight", type=float, default=1.0)
    p.add_argument("--t2t-weight", dest="t2t_weight", type=float, default=0.5)
    p.add_argument("--label-smoothing", dest="label_smoothing", type=float, default=0.0)
    p.add_argument("--model-parallel", dest="model_parallel", type=int, default=1)
    p.add_argument("--image-variant", dest="image_variant", default="efficientnet-b5")
    p.add_argument("--bert-layers", dest="bert_layers", type=int, default=12)
    p.add_argument("--checkpoints", default="./checkpoints_pretrain")
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    import pandas as pd

    from mammodissect_torch.data.imagetext import ImageTextDataset
    from mammodissect_torch.device import resolve_device
    from mammodissect_torch.parallel.mesh import is_master
    from mammodissect_torch.parallel.multihost import initialize
    from mammodissect_torch.train.pretrain import PretrainConfig, pretrain

    args = build_parser().parse_args(argv)
    initialize(device=str(resolve_device(args.device)))  # torchrun's ranks, if any
    # FINDING-labelled CSVs (vindr) generate text from the canonical prompt templates,
    # which the reference always supplies (`data_utils.py:119`)
    prompts_json = args.prompts_json or str(PROMPTS_JSON)
    with open(prompts_json) as f:
        prompt_json = json.load(f)
    cfg = PretrainConfig(
        csv_file=args.csv_file, root=args.root, img_dir=args.img_dir, dataset=args.dataset,
        prompts_json=prompts_json, vocab_file=args.vocab_file, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, img_size=tuple(args.img_size),
        i2i_weight=args.i2i_weight, t2t_weight=args.t2t_weight,
        label_smoothing=args.label_smoothing, model_parallel=args.model_parallel,
        image_variant=args.image_variant, bert_layers=args.bert_layers,
        checkpoints=args.checkpoints, seed=args.seed, device=args.device)
    df = pd.read_csv(cfg.csv_file)
    ds = ImageTextDataset(df, root=cfg.root, img_dir=cfg.img_dir, dataset=cfg.dataset,
                          size_hw=tuple(cfg.img_size), prompt_json=prompt_json, seed=cfg.seed)
    result = pretrain(cfg, ds, log=print if is_master() else (lambda *_: None))
    if is_master():
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
