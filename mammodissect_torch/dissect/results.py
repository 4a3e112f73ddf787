"""Results CSV writer — byte-compatible schema with the reference so Plots/ post-
processing ports directly: columns {layer, unit, description, similarity, images} with
list-typed description/similarity/images cells (`describe_broad_neurons.py:79,122-172`),
plus an `*_args.txt` JSON dump of the config beside the CSV (`:171-172`)."""
from __future__ import annotations

import dataclasses
import datetime
import json
import os

import pandas as pd


def result_basename(cfg) -> str:
    """Descriptive CSV name: the reference picks from a hardcoded matrix keyed on
    checkpoint presence x d_probe (`describe_broad_neurons.py:128-170`); we generate the
    same shape of name systematically."""
    pretrained = "mammo_pretrained" if cfg.breast_clip_ckpt else "not_mammo_pretrained"
    finetuned = "finetuned_" if cfg.finetuned_ckpt else ""
    probe = cfg.d_probe.split(":")[0]
    return f"{probe}_{finetuned}{pretrained}_{_file_name(cfg.target_model)}_descriptions"


def _file_name(model_name: str) -> str:
    """A model name as a file-name part: CLIP's "ViT-B/16" -> "ViT-B16"."""
    return model_name.replace("/", "")


def og_result_basename(cfg) -> tuple:
    """describe_og_neurons.py's OWN hardcoded naming matrix, reproduced exactly
    (`concept_vit/describe_og_neurons.py:129-147`): (csv_stem, args_stem) keyed on
    Breast_clip_chkpt presence x finetuned-classifier presence x d_probe.

    The last case (no checkpoint, imagenet_subsets probe) ships with MISMATCHED
    stems in the reference — csv says `..._clip_descriptions`, args.txt says
    `..._breast_clip_descriptions_args` — reproduced faithfully so downstream
    Plots code keyed on the exact reference filenames works unchanged."""
    probe = cfg.d_probe.split(":")[0].lower()
    if cfg.breast_clip_ckpt:
        if cfg.finetuned_ckpt:
            stem = "clip_dissector_vindr_den_finetuned_breast_clip_classifier_descriptions"
        elif probe == "imagenet_subsets":
            stem = ("clip_dissector_imagenet_subsets_small_mammo_pretrained_"
                    "breast_clip_classifier_descriptions")
        else:  # the reference matrix only enumerates vindr here; it is the default
            stem = "clip_dissector_vindr_mammo_pretrained_breast_clip_classifier_descriptions"
        return stem, stem + "_args"
    if probe == "imagenet_subsets":
        return ("clip_dissector_clip_target_imagenet_subsets_small_not_mammo_"
                "pretrained_clip_descriptions",
                "clip_dissector_clip_target_imagenet_subsets_small_not_mammo_"
                "pretrained_breast_clip_descriptions_args")
    stem = "clip_dissector_vindr_not_mammo_pretrained_breast_clip_descriptions"
    return stem, stem + "_args"


# Documented divergences from the reference's scoring math, stamped into every run's
# args.txt so downstream consumers of the CSV see them without reading docs/PARITY.md.
_SIMILARITY_NOTES = {
    "rank_reorder": (
        "rank_reorder diverges from the reference (concept_vit/similarity.py:99-132) "
        "in two documented ways: (1) negative avg_clip is clamped to 1e-6 instead of "
        "producing NaN via (avg_clip)**0.5, so negative-mean concepts rank last "
        "rather than poisoning the row; (2) the random-permutation baseline uses a "
        "seeded PRNG (PRNGKey(0)) instead of torch's unseeded randperm, so scores "
        "are reproducible. Values are NOT numerically comparable to reference "
        "rank_reorder CSVs; rankings agree where the reference is finite."
    ),
}


def write_results(outputs: dict, cfg, write: bool = True):
    """The results frame, and its CSV and args.txt under a stamped directory of
    `cfg.result_dir`: (df, csv_path). `write` False (every rank but the first of a
    data-parallel run, which holds the same rows) writes nothing: (df, None)."""
    df = pd.DataFrame(outputs)
    if not write:
        return df, None
    stamp = datetime.datetime.now().strftime("%y_%m_%d_%H_%M")
    save_dir = os.path.join(cfg.result_dir, f"{_file_name(cfg.target_model)}_{stamp}")
    os.makedirs(save_dir, exist_ok=True)
    if getattr(cfg, "naming", "generated") == "og":
        base, args_base = og_result_basename(cfg)
    else:
        base = result_basename(cfg)
        args_base = base + "_args"
    csv_path = os.path.join(save_dir, base + ".csv")
    df.to_csv(csv_path, index=False)
    args = dataclasses.asdict(cfg)
    if cfg.similarity_fn in _SIMILARITY_NOTES:
        args["similarity_fn_divergence_note"] = _SIMILARITY_NOTES[cfg.similarity_fn]
    with open(os.path.join(save_dir, args_base + ".txt"), "w") as f:
        json.dump(args, f, indent=2, default=str)
    return df, csv_path
