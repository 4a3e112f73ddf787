"""The flagship M-dissect's full-width agreement between the port and the JAX package:
EfficientNet-B5 x 39 blocks (6992 units) x the canonical concept file x 128 probe
images at 1520x912, on a seeded random Mammo-CLIP checkpoint. Three references:

  noise_drawn       the `synthetic_u8` noise probe on the drawn weights (every tensor
                    from the seed's numpy generator)
  mammo_drawn       the `mammo_png` probe (mammogram-shaped images: a textured
                    half-ellipse breast on black, drawn from the seed, written as
                    PNGs, read by both packages' `csv:` probe) on the drawn weights
  mammo_calibrated  the `mammo_png` probe on the calibrated weights: the drawn ones
                    with the image tower's BatchNorm statistics taken from data
                    (`calibrate`, committed as `bn_stats_calibrated.npz`)
  mammo_calibrated_bf16
                    mammo_calibrated with the bf16 model
                    (`--dissector_kwargs '{"dtype": "bfloat16"}'`): the reference of
                    the flagship's bf16 tower

With the drawn statistics the tower's deep blocks and its embedding do not depend on
the image beyond float32 rounding, so every soft-WPMI score of the two drawn
references is 0 within a few ulps and their top concepts are near-ties (PERF.md).
The calibrated weights keep the image through all 39 blocks: the references the 0.99
top-1 bar is held on.

    python tests/_fullwidth_agreement.py weights [--weights drawn|calibrated] [--seed 0]
        writes build/fullwidth/mammo_clip_seed<seed>_<weights>.tar, prints its SHA-256
    python tests/_fullwidth_agreement.py calibrate
        computes the BatchNorm statistics of the calibrated weights on the CPU
    python tests/_fullwidth_agreement.py spread [--weights drawn|calibrated]
        prints how far the tower's activations and embedding depend on the image
    python tests/_fullwidth_agreement.py jax --ref REF
        runs the JAX package's dissect CLI for a reference on the CPU (about 18 min on
        8 cores, fp32 or bf16), after proving that every tensor of the `.tar` landed
        in the JAX variables, and writes the gzipped CSV and the reference's manifest
        entry to tests/assets/fullwidth/
    python tests/_fullwidth_agreement.py jax-spread --ref REF
        the same JAX run with every BatchNorm scale of the image tower one float32 ulp
        higher, compared with the committed CSV (nothing committed): the agreement
        the JAX program keeps with itself under a float32-level change
    python tests/_fullwidth_agreement.py compare A.csv[.gz] B.csv[.gz]
        prints the agreement of two dissection CSVs (`compare_csvs`)
    python tests/_fullwidth_agreement.py port-cpu --ref REF
        runs the port's dissect CLI with `--device cpu` on the same `.tar`, probe and
        arguments (about 6.5 min), and compares its CSV with the committed JAX CSV

The `.tar` and the PNGs are rebuilt from the seed and never committed. `chip_smoke.py`
phase 15 runs the port on the card with the manifest's arguments. Imports numpy and
torch only at top level: JAX and the port are imported inside the functions that use
them.
"""
from __future__ import annotations

import ast
import gzip
import hashlib
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
WORK = REPO / "build" / "fullwidth"
ASSETS = REPO / "tests" / "assets" / "fullwidth"
MANIFEST = ASSETS / "manifest.json"
BN_STATS = ASSETS / "bn_stats_calibrated.npz"
PROBES = ("synthetic_u8", "mammo_png")
WEIGHTS = ("drawn", "calibrated")
# each JAX reference: (probe, weights)
REFERENCES = {"noise_drawn": ("synthetic_u8", "drawn"),
              "mammo_drawn": ("mammo_png", "drawn"),
              "mammo_calibrated": ("mammo_png", "calibrated"),
              "mammo_calibrated_bf16": ("mammo_png", "calibrated")}
BF16_ARGS = ("--dissector_kwargs", '{"dtype": "bfloat16"}')
# the CLI arguments a reference adds to the agreement run's (fp32 without)
REFERENCE_ARGS = {"mammo_calibrated_bf16": BF16_ARGS}

SEED = 0
N_BLOCKS = 39
N_UNITS = 6992
N_IMAGES = 128
IMAGE_HW = (1520, 912)
BATCH = 8
TEMPERATURE = 0.07
CALIBRATION_N = 16     # mammo_png images whose batch statistics calibrate the BatchNorms


def jax_csv(ref: str) -> Path:
    """The committed JAX CSV of a reference."""
    return ASSETS / f"jax_b5_{ref}.csv.gz"


def probe_spec(probe: str, probe_dir: str = "<probe_dir>"):
    """(d_probe, probe_kwargs) of a probe; `probe_dir` holds mammo_png's PNGs and CSV."""
    if probe == "synthetic_u8":
        return probe, {"n": N_IMAGES, "h": IMAGE_HW[0], "w": IMAGE_HW[1], "seed": SEED}
    if probe == "mammo_png":
        return f"csv:{probe_dir}/probe.csv", {"root": probe_dir}
    raise ValueError(f"unknown probe {probe!r}; expected one of {PROBES}")


def dissect_args(probe: str, ckpt: str, result_dir: str, activation_dir: str,
                 probe_dir: str = "<probe_dir>") -> list:
    """The dissect CLI's arguments of the agreement run (the CLI's defaults for the
    rest: fp32, soft-WPMI, top_k 100, the canonical concept file, the toy vocab)."""
    d_probe, kwargs = probe_spec(probe, probe_dir)
    return ["--target_model", "breastclip", "--clip_model", "breastclip",
            "--Breast_clip_chkpt", ckpt, "--d_probe", d_probe,
            "--probe_kwargs", json.dumps(kwargs),
            "--target_layers", ",".join(f"blocks.{i}" for i in range(N_BLOCKS)),
            "--resident", "--batch_size", str(BATCH),
            "--result_dir", result_dir, "--activation_dir", activation_dir]


def reference_args(ref: str) -> list:
    """The dissect CLI's arguments of a reference, with placeholders for paths."""
    return [*dissect_args(REFERENCES[ref][0], "<tar>", "<result_dir>", "<activation_dir>"),
            *REFERENCE_ARGS.get(ref, ())]


def manifest_cli(ref: str) -> str:
    """The JAX CLI's command line of a reference, with placeholders for paths."""
    return "python -m mammodissect.cli.dissect " + " ".join(reference_args(ref))


# ------------------------------------------------------------------ the mammo_png probe
def mammo_images(n: int = N_IMAGES, seed: int = SEED, hw=IMAGE_HW):
    """Mammogram-shaped uint8 images [n, H, W] (`chip_smoke.mammo_pool`: a textured
    half-ellipse breast of random size and height on a random lateral edge, on black
    background), and the SHA-256 of their bytes."""
    from chip_smoke import mammo_pool

    out = mammo_pool(n, *hw, seed=seed)[..., 0]
    return out, hashlib.sha256(out.tobytes()).hexdigest()


def write_mammo_probe(probe_dir, seed: int = SEED) -> str:
    """The mammo_png probe's PNGs (lossless grayscale, 1520x912: both packages read
    them back byte for byte) and its `image_path` CSV under `probe_dir`; returns the
    images' SHA-256."""
    from PIL import Image

    probe_dir = Path(probe_dir)
    probe_dir.mkdir(parents=True, exist_ok=True)
    images, sha = mammo_images(seed=seed)
    names = []
    for i, img in enumerate(images):
        names.append(f"m{i:03d}.png")
        Image.fromarray(img).save(probe_dir / names[-1], compress_level=1)
    (probe_dir / "probe.csv").write_text("image_path\n" + "\n".join(names) + "\n")
    return sha


# ------------------------------------------------------------------ the weights
def _module_shapes():
    """(name, shape, dtype) of the port's BreastClipModule state dict: B5 with the
    '-detect' avg pooling, 12-layer BERT with the toy WordPiece vocab's row count,
    linear 512-d projections (built on the meta device: no values are drawn)."""
    from mammodissect_torch.models.breastclip import BreastClipModule
    from mammodissect_torch.models.tokenizers import WordPieceTokenizer

    with torch.device("meta"):
        module = BreastClipModule(vocab_size=len(WordPieceTokenizer.toy().vocab),
                                  temperature=TEMPERATURE)
    return [(k, tuple(v.shape), v.dtype) for k, v in module.state_dict().items()]


def draw_state_dict(seed: int = SEED, weights: str = "drawn"):
    """The seeded checkpoint in the port's names, and the SHA-256 of its tensors'
    bytes in sorted-name order. Every float tensor but `logit_scale` is drawn from
    `np.random.default_rng(seed)` in sorted-name order (numpy: the bits are the same
    under any torch build), with the port's `init_weights` scales: weights and
    embeddings N(0, 1/fan_in), BatchNorm and LayerNorm gammas 1 + N(0, 0.01), biases
    and running means N(0, 0.01), running variances U(0.5, 1.5). The integer
    `num_batches_tracked` buffers are zero and `logit_scale` is log(1/T).

    weights="calibrated" replaces the image tower's BatchNorm running statistics by
    the committed `BN_STATS` (`calibrate`): with the drawn statistics the tower's
    deep blocks and its embedding no longer depend on the image."""
    if weights not in WEIGHTS:
        raise ValueError(f"unknown weights {weights!r}; expected one of {WEIGHTS}")
    stats = dict(np.load(BN_STATS)) if weights == "calibrated" else {}
    rng = np.random.default_rng(seed)
    sd, digest = {}, hashlib.sha256()
    for name, shape, dtype in sorted(_module_shapes()):
        if dtype != torch.float32:
            arr = np.zeros(shape, dtype=np.int64)
        elif name == "logit_scale":
            arr = np.asarray(math.log(1.0 / TEMPERATURE), dtype=np.float32)
        elif name.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        elif len(shape) >= 2:
            arr = rng.standard_normal(shape, dtype=np.float32)
            arr *= np.float32(1.0 / math.sqrt(math.prod(shape[1:])))
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.1)
            if name.endswith(".weight"):
                arr += np.float32(1.0)
        if name in stats:
            arr = stats.pop(name)
            if arr.shape != shape or arr.dtype != np.float32:
                raise ValueError(f"{BN_STATS.name}: {name} is {arr.dtype} {arr.shape}")
        digest.update(arr.tobytes())
        sd[name] = torch.from_numpy(arr)
    if stats:
        raise ValueError(f"{BN_STATS.name} holds tensors the model lacks: {sorted(stats)[:5]}")
    return sd, digest.hexdigest()


def calibrate(seed: int = SEED) -> dict:
    """The image tower's BatchNorm running statistics that make its activations those
    of data: the drawn model's tower on the CPU in training mode (each BatchNorm
    normalizing by the batch's statistics and keeping them: momentum 1, no
    drop-connect) over the first CALIBRATION_N mammo_png images at 1520x912, in one
    batch; {state-dict name: float32 array}."""
    from mammodissect_torch.models.breastclip import BreastClipModule
    from mammodissect_torch.models.layers import BatchNorm2d
    from mammodissect_torch.models.tokenizers import WordPieceTokenizer
    from mammodissect_torch.ops.normalize import u8_minmax_meanstd

    sd, _ = draw_state_dict(seed, "drawn")
    module = BreastClipModule(vocab_size=len(WordPieceTokenizer.toy().vocab),
                              temperature=TEMPERATURE)
    module.load_state_dict(sd)
    tower = module.image_encoder
    tower.drop_connect_rate = 0.0
    for m in tower.modules():
        if isinstance(m, BatchNorm2d):
            m.momentum = 1.0
    images, _ = mammo_images(n=CALIBRATION_N, seed=seed)
    x = u8_minmax_meanstd(torch.from_numpy(images[..., None]), 0.3089279, 0.25053555)
    tower.train()
    with torch.no_grad():
        module.encode_image(x)
    return {k: v.numpy().copy() for k, v in module.state_dict().items()
            if k.startswith("image_encoder.") and k.endswith(("running_mean", "running_var"))}


def reference_layout(sd):
    """The port's names -> a reference Mammo-CLIP `.tar`'s: the text tower under
    `text_encoder.bert.` (the layout both packages' loaders read)."""
    return {("text_encoder.bert." + k[len("text_encoder."):] if k.startswith("text_encoder.")
             else k): v for k, v in sd.items()}


def write_weights(seed: int = SEED, path: Path | None = None, weights: str = "drawn"):
    """Write the seeded `.tar` ({"model": state_dict, "config": ...}); returns
    (path, sha256, port-named state dict)."""
    from mammodissect_torch.models.breastclip import default_model_config

    sd, sha = draw_state_dict(seed, weights)
    path = Path(path or WORK / f"mammo_clip_seed{seed}_{weights}.tar")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": reference_layout(sd), "config": {"model": default_model_config()}},
               path)
    return path, sha, sd


def weight_tensors(sd):
    """The float tensors of a port-named state dict (the weights a loader must place;
    the integer `num_batches_tracked` counters are not weights)."""
    return {k: v for k, v in sd.items() if v.is_floating_point()}


def assert_same_tensors(got, want, side: str) -> int:
    """Every float tensor of `want` equal in `got`, bit for bit in `got`'s dtype (a
    bf16 module stores the .tar's values rounded to bf16), with no key missing on
    either side; returns the number of values checked."""
    got, want = weight_tensors(got), weight_tensors(want)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise AssertionError(f"{side}: {len(missing)} tensors of the .tar not loaded "
                             f"{missing[:5]}, {len(extra)} not in the .tar {extra[:5]}")
    bad = [k for k in want if got[k].shape != want[k].shape
           or not torch.equal(got[k].cpu(), want[k].to(got[k].dtype))]
    if bad:
        raise AssertionError(f"{side}: {len(bad)} tensors differ from the .tar: {bad[:5]}")
    return sum(v.numel() for v in want.values())


# ------------------------------------------------------------------ comparison
def read_csv(path):
    """A dissection CSV (plain or gzipped) -> DataFrame with parsed list columns."""
    import pandas as pd

    df = pd.read_csv(path)
    for col in ("description", "similarity", "images"):
        df[col] = df[col].map(ast.literal_eval)
    return df


def compare_csvs(a, b) -> dict:
    """Agreement of two dissection CSVs of the same units: top-1 concept agreement per
    unit (overall, per layer, the minimum layer), the number of distinct top-1
    concepts in each CSV, top-5 concept overlap, the share of
    identical top-image lists, and for each unit whose top-1 differs, its top-1 vs
    top-2 similarity margin in each run beside the largest similarity difference of
    the shared concepts between the runs (a margin below that difference is a near
    tie, not a fault)."""
    da = a if not isinstance(a, (str, os.PathLike)) else read_csv(a)
    db = b if not isinstance(b, (str, os.PathLike)) else read_csv(b)
    da = da.set_index(["layer", "unit"]).sort_index()
    db = db.set_index(["layer", "unit"]).sort_index()
    if not da.index.equals(db.index):
        raise ValueError(f"the CSVs describe different units ({len(da)} vs {len(db)} rows)")
    top1 = np.array([x[0] == y[0] for x, y in zip(da["description"], db["description"])])
    top5 = np.array([len(set(x[:5]) & set(y[:5])) / 5.0
                     for x, y in zip(da["description"], db["description"])])
    images = np.array([list(x) == list(y) for x, y in zip(da["images"], db["images"])])
    sim_diff = 0.0
    for da_, sa, db_, sb in zip(da["description"], da["similarity"], db["description"],
                                db["similarity"]):
        sb_of = dict(zip(db_, sb))
        d = [abs(s - sb_of[c]) for c, s in zip(da_, sa) if c in sb_of]
        sim_diff = max(sim_diff, max(d, default=0.0))
    per_layer = {}
    layers = da.index.get_level_values("layer")
    for layer in sorted(set(layers), key=lambda s: int(s.split(".")[-1])):
        per_layer[layer] = float(top1[np.asarray(layers == layer)].mean())
    disagree = []
    for (layer, unit), ok, sa, sb in zip(da.index, top1, da["similarity"], db["similarity"]):
        if not ok:
            disagree.append({"layer": layer, "unit": int(unit),
                             "margin_a": float(sa[0] - sa[1]), "margin_b": float(sb[0] - sb[1])})
    worst = min(per_layer, key=per_layer.get)
    return {"units": int(len(da)), "top1": float(top1.mean()),
            "distinct_top1": [len({d[0] for d in da["description"]}),
                              len({d[0] for d in db["description"]})],
            "min_layer": worst, "min_layer_top1": per_layer[worst],
            "top5_overlap": float(top5.mean()), "images_identical": float(images.mean()),
            "max_similarity_diff": float(sim_diff),
            "disagreeing": len(disagree),
            "max_disagreeing_margin": max((max(d["margin_a"], d["margin_b"])
                                           for d in disagree), default=None),
            "per_layer": per_layer, "disagreements": disagree[:20]}


def summary(stats: dict) -> dict:
    """`compare_csvs`' figures without the per-layer table and the listed units."""
    return {k: v for k, v in stats.items() if k not in ("per_layer", "disagreements")}


# ------------------------------------------------------------------ subcommands
def cmd_weights(seed: int = SEED, weights: str = "drawn"):
    t0 = time.perf_counter()
    path, sha, sd = write_weights(seed, weights=weights)
    n = sum(v.numel() for v in sd.values())
    print(f"[weights] {path}: {len(sd)} tensors, {n} values, "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"[weights] {weights} sha256 {sha}")
    return path, sha, sd


def cmd_calibrate(seed: int = SEED):
    t0 = time.perf_counter()
    stats = calibrate(seed)
    ASSETS.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(BN_STATS, **stats)
    print(f"[calibrate] {len(stats)} tensors of BatchNorm statistics from {CALIBRATION_N} "
          f"mammo_png images in {time.perf_counter() - t0:.1f} s (CPU) -> {BN_STATS} "
          f"({BN_STATS.stat().st_size} B)")


def cmd_spread(weights: str, seed: int = SEED, n: int = 8):
    """How far the tower's response depends on the image: for blocks 0, 20 and 38 the
    mean over units of the pooled activation's std across `n` mammo_png images (not
    those the calibration saw) over its mean magnitude, and the least cosine between
    two images' embeddings, on the CPU at 1520x912."""
    from mammodissect_torch.dissect.dissectors import get_dissector

    sd, _ = draw_state_dict(seed, weights)
    d = get_dissector("breastclip", device="cpu", seed=seed)
    d.module.load_state_dict(sd)
    images, _ = mammo_images(n=CALIBRATION_N + n, seed=seed)
    capture, names, _ = d.capture_plan(["blocks.0", "blocks.20", "blocks.38"])
    with torch.inference_mode():
        acts, emb = d._encode_u8(torch.from_numpy(images[CALIBRATION_N:, ..., None]),
                                 capture, "avg", 0.3089279, 0.25053555)
    for name in names:
        a = acts[name].double()
        print(f"[spread] {weights} {name}: std across images / mean |activation| "
              f"{float(a.std(0).mean() / a.abs().mean()):.3g}")
    e = torch.nn.functional.normalize(emb.double(), dim=1)
    print(f"[spread] {weights} embedding: least cosine between two images "
          f"{float((e @ e.T).min()):.9f}")


def _newest_csv(result_dir: Path) -> Path:
    csvs = sorted(result_dir.rglob("*.csv"), key=lambda p: p.stat().st_mtime)
    if not csvs:
        raise FileNotFoundError(f"no CSV under {result_dir}")
    return csvs[-1]


def cmd_jax(ref: str, seed: int = SEED, spread: bool = False):
    """A JAX reference on the CPU: the CLI in this process, its `breastclip` factory
    wrapped to prove that the loaded variables hold every tensor of the `.tar` before
    the dissection runs. With `spread`, every BatchNorm scale of the image tower is
    then moved by one float32 ulp (up), the CSV goes under build/ and is compared with
    the committed one: how far the JAX program moves under a float32-level change."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mammodissect.models.breastclip  # noqa: F401  (registers the dissector)
    from mammodissect.cli import dissect as jax_cli
    from mammodissect.dissect.dissectors import DISSECTORS
    from mammodissect_torch.convert import breastclip_from_jax

    probe, weights = REFERENCES[ref]
    path, sha, sd = cmd_weights(seed, weights)
    out = WORK / ("jax_spread" if spread else "jax") / ref
    images_sha = write_mammo_probe(out / "probe", seed) if probe == "mammo_png" else None
    built = DISSECTORS.get("breastclip")

    def checked(**kw):
        d = built(**kw)
        got = breastclip_from_jax(jax.tree.map(np.array, d.variables))
        n = assert_same_tensors(got, sd, "JAX")
        print(f"[jax] every tensor of the .tar equal in the loaded JAX variables: "
              f"{len(weight_tensors(sd))} tensors, {n} values, no key missing on either side")
        if spread:
            d.variables = jax.tree_util.tree_map_with_path(
                lambda path, a: np.nextafter(a, np.float32(np.inf)).astype(np.float32)
                if path[-1].key == "scale" and "image_encoder" in str(path) else a,
                jax.tree.map(np.asarray, d.variables))
            d._jit_cache = {}
        return d

    DISSECTORS.register("breastclip", checked)
    t0 = time.perf_counter()
    jax_cli.main([*dissect_args(probe, str(path), str(out / "results"), str(out / "acts"),
                                str(out / "probe")), *REFERENCE_ARGS.get(ref, ())])
    if spread:
        print(f"[jax-spread] {ref}: {time.perf_counter() - t0:.1f} s (CPU)")
        print(json.dumps(summary(compare_csvs(_newest_csv(out / "results"), jax_csv(ref))),
                         indent=1))
        return
    write_reference(ref, _newest_csv(out / "results"), seed, sha,
                    time.perf_counter() - t0, images_sha)


def write_reference(ref: str, csv: Path, seed: int, sha: str, wall: float,
                    images_sha: str | None = None) -> None:
    """A reference's JAX CSV, gzipped, and its entry of the manifest, into
    tests/assets/fullwidth/."""
    import jax

    probe, weights = REFERENCES[ref]
    raw = Path(csv).read_bytes()
    ASSETS.mkdir(parents=True, exist_ok=True)
    with gzip.GzipFile(jax_csv(ref), "wb", mtime=0) as f:
        f.write(raw)
    manifest = json.loads(MANIFEST.read_text()) if MANIFEST.exists() else {}
    if manifest.get("seed", seed) != seed:
        raise SystemExit("the manifest holds the references of another seed")
    manifest.update(seed=seed, jax=jax.__version__, numpy=np.__version__)
    manifest.setdefault("weights_sha256", {})[weights] = sha
    if images_sha:
        manifest.setdefault("images_sha256", {})[probe] = images_sha
    entry = {"probe": probe, "weights": weights, "cli": manifest_cli(ref),
             "rows": raw.count(b"\n") - 1,
             "columns": raw.split(b"\n", 1)[0].decode().split(","),
             "csv": jax_csv(ref).name, "wall_s_cpu": round(wall, 1)}
    manifest.setdefault("references", {})[ref] = entry
    MANIFEST.write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"[jax] {ref}: {entry['rows']} rows in {wall:.1f} s (CPU) -> {jax_csv(ref)} "
          f"({jax_csv(ref).stat().st_size} B)")


def run_port(probe: str, device: str, out, path, sd, extra=(), log=print,
             probe_dir=None) -> Path:
    """The port's dissect CLI (`cli.dissect.main`) with a probe's agreement arguments
    (and `extra`) on `device`, writing under the directory `out` (a fresh one for each
    run: results and spilled chunks go there), mammo_png's PNGs read from `probe_dir`
    (default `out`/probe, written beforehand), its `breastclip` factory wrapped to
    prove that every tensor of the `.tar` landed; returns the CSV."""
    import mammodissect_torch.models.breastclip  # noqa: F401  (registers the dissector)
    from mammodissect_torch.cli import dissect as port_cli
    from mammodissect_torch.dissect.dissectors import DISSECTORS

    out = Path(out)
    built = DISSECTORS.get("breastclip")

    def checked(**kw):
        d = built(**kw)
        n = assert_same_tensors(d.module.state_dict(), sd, "port")
        log(f"[port] every tensor of the .tar equal in the port's module: {n} values")
        return d

    DISSECTORS.register("breastclip", checked)
    try:
        rc = port_cli.main([*dissect_args(probe, str(path), str(out / "results"),
                                          str(out / "acts"), str(probe_dir or out / "probe")),
                            "--device", device, *extra])
    finally:
        DISSECTORS.register("breastclip", built)
    if rc:
        raise RuntimeError(f"the port's dissect CLI returned {rc}")
    return _newest_csv(out / "results")


def cmd_port_cpu(ref: str, seed: int = SEED):
    manifest = json.loads(MANIFEST.read_text())
    probe, weights = REFERENCES[ref]
    path, sha, sd = cmd_weights(seed, weights)
    if sha != manifest["weights_sha256"][weights]:
        raise SystemExit(f"{weights} weights sha256 {sha} != the manifest's")
    out = WORK / "port_cpu" / ref
    if probe == "mammo_png":
        images_sha = write_mammo_probe(out / "probe", seed)
        if images_sha != manifest["images_sha256"][probe]:
            raise SystemExit(f"probe images sha256 {images_sha} != the manifest's")
    t0 = time.perf_counter()
    csv = run_port(probe, "cpu", out, path, sd, REFERENCE_ARGS.get(ref, ()))
    wall = time.perf_counter() - t0
    stats = compare_csvs(csv, jax_csv(ref))
    print(f"[port-cpu] {ref}: {wall:.1f} s (CPU)")
    print(json.dumps(stats, indent=1))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    cmd, rest = argv[0], argv[1:]
    opts = {"--seed": str(SEED), "--ref": "mammo_calibrated", "--weights": "drawn"}
    for flag in opts:
        if flag in rest:
            i = rest.index(flag)
            opts[flag] = rest[i + 1]
            del rest[i:i + 2]
    seed, ref = int(opts["--seed"]), opts["--ref"]
    if cmd == "weights":
        cmd_weights(seed, opts["--weights"])
    elif cmd == "calibrate":
        cmd_calibrate(seed)
    elif cmd == "spread":
        cmd_spread(opts["--weights"], seed)
    elif cmd == "jax":
        cmd_jax(ref, seed)
    elif cmd == "jax-spread":
        cmd_jax(ref, seed, spread=True)
    elif cmd == "compare":
        print(json.dumps(compare_csvs(rest[0], rest[1]), indent=1))
    elif cmd == "port-cpu":
        cmd_port_cpu(ref, seed)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
