"""Zero-shot evaluation CLI of the PyTorch port (counterpart of
`mammodissect/cli/zseval.py`; fills the reference's missing
`src/zero_shot_eval_clip.py`, `scripts/eval.sh:11`, `configs/zs_clip.yaml`).

Example:
  python -m mammodissect_torch.cli.zseval --d_probe csv:meta.csv \
    --probe_kwargs '{"root": "imgs/", "label_col": "Mass"}' \
    --clip_model breastclip --Breast_clip_chkpt ckpt.tar --tasks Mass

`--device` defaults to cuda and raises without a GPU; `--device cpu` runs on the CPU.
Dissectors: breastclip, the OpenAI CLIP ViTs (ViT-B/16, ...), random.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Mammo-CLIP zero-shot eval (PyTorch, CUDA)")
    p.add_argument("--clip_model", default="breastclip")
    p.add_argument("--d_probe", required=True)
    p.add_argument("--probe_kwargs", default="{}")
    p.add_argument("--dissector_kwargs", default="{}")
    p.add_argument("--Breast_clip_chkpt", default=None)
    p.add_argument("--tasks", default="Mass,Suspicious_Calcification",
                   help="comma-separated task names; each needs a label column in the "
                        "probe csv and an entry in the prompts json")
    p.add_argument("--prompts_json", default=None,
                   help="path to {task: {pos: [...], neg: [...]}} json; default "
                        "mirrors configs/zs_clip.yaml prompts")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--output", default=None, help="write results json here")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    from mammodissect_torch.data.probes import get_probe
    from mammodissect_torch.device import resolve_device, set_fp32_policy
    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.zs import zero_shot_eval

    args = build_parser().parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        set_fp32_policy()
    probe = get_probe(args.d_probe, **json.loads(args.probe_kwargs))
    dk = json.loads(args.dissector_kwargs)
    if args.Breast_clip_chkpt:
        dk.setdefault("ckpt_path", args.Breast_clip_chkpt)
    dk.setdefault("device", args.device)
    dissector = get_dissector(args.clip_model, **dk)

    prompts = None
    if args.prompts_json:
        with open(args.prompts_json) as f:
            prompts = json.load(f)

    labels = {}
    for t in args.tasks.split(","):
        # CSV probes expose per-task label columns directly; other probes fall back to
        # their single label stream
        if hasattr(probe, "df") and t in probe.df.columns:
            labels[t] = probe.df[t].to_numpy(dtype=np.float64)
        else:
            col = [probe.label(i) for i in range(len(probe))]
            if all(v is not None for v in col):
                labels[t] = np.asarray(col, dtype=np.float64)
    results = zero_shot_eval(dissector, probe, labels, prompts, args.batch_size)
    print(json.dumps(results, indent=2, default=float))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
