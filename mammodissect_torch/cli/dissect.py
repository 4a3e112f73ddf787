"""Dissection CLI of the PyTorch port (counterpart of `mammodissect/cli/dissect.py`,
the reference `describe_broad_neurons.py` flag surface).

The resident M-Mammo-CLIP dissection on the GPU:
  python -m mammodissect_torch.cli.dissect --target_model breastclip \
    --clip_model breastclip --target_layers blocks.0,blocks.1,...,blocks.38 --resident \
    --d_probe csv:probe.csv --result_dir results --activation_dir saved_activations

`--device` defaults to cuda and raises without a GPU; `--device cpu` runs on the CPU.
Only the resident path and the plain uint8 wire (`--wire_pack off`) are ported.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

# the canonical 762-concept set, read in place as a data file
CONCEPT_SET = (Path(__file__).resolve().parents[2] / "mammodissect" / "assets" / "concepts"
               / "Specific_concepts_sorted.txt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mammo-CLIP Dissect (PyTorch, CUDA)")
    p.add_argument("--clip_model", type=str, default="breastclip",
                   help="dissector: breastclip (the only one ported so far)")
    p.add_argument("--target_model", type=str, default="breastclip",
                   help="target model: breastclip (the only one ported so far)")
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
    p.add_argument("--wire_pack", choices=("off",), default="off",
                   help="host-to-device wire of the --resident harvest: only the plain "
                        "uint8 batch ('off') is ported")
    p.add_argument("--naming", choices=("generated", "og"), default="generated",
                   help="'og' writes CSV/args files under describe_og_neurons.py's "
                        "hardcoded name matrix")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run to this file and "
                        "print the top operators by device (or CPU) time and the device's "
                        "busy time and idle share over the run")
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
        concept_set=args.concept_set or str(CONCEPT_SET),
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
    if args.profile:
        import torch.profiler as tp

        on_gpu = cfg.device.startswith("cuda")
        activities = [tp.ProfilerActivity.CPU] + ([tp.ProfilerActivity.CUDA] if on_gpu else [])
        with tp.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            df, csv_path = run_dissection(cfg, log=print)
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(args.profile)
        sort_by = "self_device_time_total" if on_gpu else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=sort_by, row_limit=25))
        if on_gpu:  # the device's idle share, from this run's own trace
            with open(args.profile) as f:
                dev = device_busy(json.load(f).get("traceEvents", []))
            span = dev["first_to_last_s"]
            print(f"[profile] device busy {dev['busy_s']:.3f} s; run {wall:.3f} s wall "
                  f"(idle {1 - dev['busy_s'] / wall:.1%}); first to last device op "
                  f"{span:.3f} s (idle {1 - dev['busy_s'] / span if span else 0:.1%})")
    else:
        df, csv_path = run_dissection(cfg, log=print)
    print(f"Dissection done! {len(df)} units described. Results saved to {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
