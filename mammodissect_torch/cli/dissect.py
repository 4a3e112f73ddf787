"""Dissection CLI of the PyTorch port (counterpart of `mammodissect/cli/dissect.py`,
the reference `describe_broad_neurons.py` flag surface).

The resident M-Mammo-CLIP dissection on the GPU:
  python -m mammodissect_torch.cli.dissect --target_model breastclip \
    --clip_model breastclip --target_layers blocks.0,blocks.1,...,blocks.38 --resident \
    --d_probe csv:probe.csv --result_dir results --activation_dir saved_activations

C-Mammo-CLIP Dissect of a fine-tuned classifier, staged through the disk cache:
  python -m mammodissect_torch.cli.dissect --target_model breastclip_classifier \
    --finetuned_img_classifier_chkpt model.pth --clip_model breastclip ...

G-dissect, CLIP's ViT layers dissected by CLIP (`run_og_clip.sh:8`; `--naming og`
and `--num_top_concepts 1` are the og and clip-neuron modes):
  python -m mammodissect_torch.cli.dissect --target_model ViT-B/16 --clip_model ViT-B/16 \
    --target_layers 'vision_model.encoder.layers[0],...' --d_probe folder:images/

`--device` defaults to cuda and raises without a GPU; `--device cpu` runs on the CPU.
Several GPUs: one process each, started by torchrun (NCCL; gloo with `--device
cpu`); each rank harvests its shard of the probe, every rank scores the gathered
rows, the first writes the CSV:

  torchrun --nproc_per_node 2 -m mammodissect_torch.cli.dissect --resident ...

`--wandb` logs the run's config and the reference driver's status events to an
offline wandb run (a no-op without wandb), `--debug_nans` raises at the first module
whose output holds a NaN or an Inf, `--profile DIR` writes a torch.profiler Chrome
trace to DIR/trace.json (the program's spans and the hand kernels' launches are
ranges in it) and prints the top operators, the device's idle share, and the run's
spans per name: their count, total seconds and self seconds (`utils.profiling`).
Targets: breastclip, breastclip_classifier, tiny_cnn, the CLIP ViTs (ViT-B/32, ViT-B/16,
ViT-L/14, clip, clip-cub, clip-bloodmnist) and ModifiedResNets (clip_rn50, clip_rn101,
clip_rn50x4); dissectors: breastclip, the CLIP ViTs, random.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mammodissect_torch.assets import concept_set_path
from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
from mammodissect_torch.parallel.mesh import is_master
from mammodissect_torch.parallel.multihost import initialize
from mammodissect_torch.train.loggers import WandbLogger
from mammodissect_torch.utils.profiling import (
    TRACE_FILE,
    enable_debug_nans,
    span_table,
    spans,
    trace,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mammo-CLIP Dissect (PyTorch, CUDA)")
    p.add_argument("--clip_model", type=str, default="random",
                   help="dissector: breastclip | ViT-B/16 etc. | random")
    p.add_argument("--target_model", type=str, default="tiny_cnn",
                   help="target model: breastclip | breastclip_classifier | tiny_cnn | "
                        "ViT-B/16 etc. | clip_rn50 etc.")
    p.add_argument("--target_layers", type=str, default="blocks.0",
                   help="comma-separated; reference spellings like "
                        "'image_encoder._blocks[17]' are accepted")
    p.add_argument("--d_probe", type=str, default="synthetic")
    p.add_argument("--concept_set", type=str, default=None,
                   help="path to a concepts txt; defaults to the canonical 762-concept set")
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--pool_mode", type=str, default="avg", choices=["avg", "max"])
    p.add_argument("--similarity_fn", type=str, default="soft_wpmi",
                   choices=["soft_wpmi", "wpmi", "rank_reorder", "cos_similarity",
                            "cos_similarity_cubed"])
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--num_top_concepts", type=int, default=10)
    p.add_argument("--num_top_images", type=int, default=5)
    p.add_argument("--activation_dir", type=str, default="saved_activations")
    p.add_argument("--result_dir", type=str, default="results")
    p.add_argument("--save_prefix", type=str, default="")
    p.add_argument("--Breast_clip_chkpt", type=str, default=None)
    p.add_argument("--finetuned_img_classifier_chkpt", type=str, default=None)
    p.add_argument("--num_class", type=int, default=1)
    p.add_argument("--probe_kwargs", type=str, default="{}",
                   help="JSON dict forwarded to the probe factory (csv_file, root, ...)")
    p.add_argument("--target_kwargs", type=str, default="{}",
                   help="JSON dict forwarded to the target-model factory")
    p.add_argument("--dissector_kwargs", type=str, default="{}",
                   help="JSON dict forwarded to the dissector factory (e.g. "
                        "{\"dtype\": \"bfloat16\", \"vocab_file\": \"vocab.txt\"})")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--resident", action="store_true",
                   help="device-resident fused M-dissect: accumulate + score on the "
                        "device; completed chunks spill to --activation_dir so an "
                        "interrupted run resumes")
    p.add_argument("--deadline_s", type=float, default=None,
                   help="wall-clock budget of a --resident run: stop the harvest at a "
                        "batch boundary, score what was harvested, resume next time")
    p.add_argument("--wire_pack", choices=("auto", "on", "off"), default="off",
                   help="host-to-device wire of the --resident harvest: 'on' sends each "
                        "row's nonzero span (mammograms are ~40-60%% black background), "
                        "'auto' does when a seeded sample of 16 probe images packs to "
                        "<= 0.85 of the raw bytes, 'off' (default; measured on the H100, "
                        "PERF.md) sends the plain uint8 batch; results are equal")
    p.add_argument("--naming", choices=("generated", "og"), default="generated",
                   help="'og' writes CSV/args files under describe_og_neurons.py's "
                        "hardcoded name matrix")
    p.add_argument("--wandb", action="store_true",
                   help="log the run's config and status events to wandb (offline mode), "
                        "the reference driver's status stream "
                        "(describe_broad_neurons.py:14,77,99,121,173)")
    p.add_argument("--wandb_name", type=str, default=None, help="wandb run name")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run to this directory "
                        f"({TRACE_FILE}) and print the top operators by device (or CPU) "
                        "time and the device's busy time and idle share over the run")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise at the first module whose output holds a NaN or an Inf, "
                        "naming it (jax_debug_nans' counterpart)")
    return p


def device_busy(trace_events) -> dict:
    """Device-busy time of a Chrome trace's events (kernels, copies and memsets on
    the device; overlapping spans count once), in seconds, and the span from the
    first device event's start to the last one's end."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in trace_events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "ts" in e)
    busy, end = 0.0, None
    for t0, t1 in spans:
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    first_to_last = (max(t1 for _, t1 in spans) - spans[0][0]) if spans else 0.0
    return {"busy_s": busy / 1e6, "first_to_last_s": first_to_last / 1e6}


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = DissectConfig(
        target_model=args.target_model,
        target_layers=args.target_layers.split(","),
        d_probe=args.d_probe,
        concept_set=args.concept_set or concept_set_path(),
        clip_model=args.clip_model,
        batch_size=args.batch_size,
        pool_mode=args.pool_mode,
        similarity_fn=args.similarity_fn,
        top_k=args.top_k,
        num_top_concepts=args.num_top_concepts,
        num_top_images=args.num_top_images,
        activation_dir=args.activation_dir,
        result_dir=args.result_dir,
        save_prefix=args.save_prefix,
        breast_clip_ckpt=args.Breast_clip_chkpt,
        finetuned_ckpt=args.finetuned_img_classifier_chkpt,
        num_class=args.num_class,
        probe_kwargs=json.loads(args.probe_kwargs),
        target_kwargs=json.loads(args.target_kwargs),
        dissector_kwargs=json.loads(args.dissector_kwargs),
        resident=args.resident,
        deadline_s=args.deadline_s,
        wire_pack=args.wire_pack,
        naming=args.naming,
        device=args.device,
    )
    if cfg.device.startswith("cuda"):
        from mammodissect_torch.device import resolve_device

        resolve_device(cfg.device)  # no GPU: raise before a process group starts
    initialize(device=cfg.device)  # torchrun's ranks, if any
    enable_debug_nans(args.debug_nans)
    try:
        # the reference driver's wandb status events (`describe_broad_neurons.py:77,99,121,
        # 173`); the per-layer events come from the engine's "[score] <layer>: ..." lines
        wb = WandbLogger(project="broader_clip-dissect", name=args.wandb_name, config=vars(args),
                         enabled=args.wandb)

        def log(msg):
            print(msg)
            s = str(msg)
            if s.startswith("[score] "):
                wb.log({"layer": s[len("[score] "):].split(":")[0], "similarity_calculated": True})
            elif s.startswith(("[harvest]", "[fused]", "[resident]")):
                wb.log({"status": "activations_saved"})

        if args.profile:
            on_gpu = cfg.device.startswith("cuda")
            with trace(args.profile) as prof:
                t0 = time.perf_counter()
                df, csv_path = run_dissection(cfg, log=log)
                wall = time.perf_counter() - t0
            sort_by = "self_device_time_total" if on_gpu else "self_cpu_time_total"
            print(prof.key_averages().table(sort_by=sort_by, row_limit=25))
            print(span_table(r for r in spans() if r.start_ns >= t0 * 1e9))
            if on_gpu:  # the device's idle share, from this run's own trace
                with open(os.path.join(args.profile, TRACE_FILE)) as f:
                    dev = device_busy(json.load(f).get("traceEvents", []))
                span = dev["first_to_last_s"]
                print(f"[profile] device busy {dev['busy_s']:.3f} s; run {wall:.3f} s wall "
                      f"(idle {1 - dev['busy_s'] / wall:.1%}); first to last device op "
                      f"{span:.3f} s (idle {1 - dev['busy_s'] / span if span else 0:.1%})")
        else:
            df, csv_path = run_dissection(cfg, log=log)
        wb.log({"status": "all_layers_processed"})
        wb.log({"status": "results_saved"})
        wb.finish()
    finally:
        enable_debug_nans(False)
    if is_master():
        print(f"Dissection done! {len(df)} units described. Results saved to {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
