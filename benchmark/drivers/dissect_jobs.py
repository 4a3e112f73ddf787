"""Driver of the `dissect_jobs` traffic: whole dissection jobs, one client, closed loop.

Set-up (what `setup_s` counts, from the process's start): the seeded image pool made
on the device and copied once to pinned host memory; the weights made on the device
and the image towers' BatchNorm statistics taken by the reference; the program's
dissector (and, in C-dissect, its target) built through its registries and loaded
with those weights; one warm-up job of `warmup_images` at the cell's batch, which
also builds the CUDA kernels on a checkout's first run.

The window: jobs back to back, each a `run_dissection` call over the pool in an
order of its own drawn from the seed, in a fresh activation directory under TMPDIR
(deleted after the job; both paths cache by key, and a reused directory would turn
the next job into a cache read). With --trace 1 the first job of the window runs
under the profiler.

After the window: the peak memory is read, the program's models are freed, and the
plain reference recomputes one job drawn from the seed (its activations of every
dissected block, the image and concept embeddings, the soft-WPMI scores) over the
same images and weights, against which that job's CSV is compared (`compare.py`)."""
from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, trace as tracing
from benchmark.core import bench_path, power_limit
from benchmark.images import JobProbe, mammo_pool, to_host
from benchmark.reference import bert, efficientnet, scoring
from benchmark.weights import (
    breastclip_spec,
    calibrate,
    classifier_spec,
    make_state_dict,
    subseed,
)
from benchmark.window import closed_loop


@dataclass
class Result:
    ctx: object
    target_cfg: dict
    dissector_cfg: dict
    staged: bool
    n_concepts: int
    widths: List[int]
    window: object = None
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    window_peak_bytes: int = 0
    trace: Optional[tracing.Slice] = None
    readings: Dict[str, float] = field(default_factory=dict)
    power: Optional[str] = None

    @property
    def attempted(self) -> int:
        """Jobs of the window."""
        return len(self.window.units)


def read_concepts(path: str) -> List[str]:
    with open(path) as f:
        return [w for w in f.read().split("\n") if w.strip()]


class Cell:
    """One dissection cell: the program's side and the reference's."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.staged = not self.traffic["resident"]
        self.dcfg = ctx.config_of(self.cfg["dissector"]) if "dissector" in self.cfg else self.cfg
        path = self.traffic["concepts"]
        self.concept_path = path if os.path.isabs(path) else bench_path(path)
        self.concepts = read_concepts(self.concept_path)
        self.vocab_path = bench_path(self.dcfg["vocab_file"])
        self.vocab = bert.read_vocab(self.vocab_path)
        blocks = efficientnet.block_table(self.cfg)[:self.cfg["dissected_blocks"]]
        self.layers = [f"blocks.{i}" for i in range(len(blocks))]
        self.widths = [b["cout"] for b in blocks]
        self.device = ctx.device
        self.tmp = tempfile.mkdtemp(prefix="mammodissect_bench_")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- set-up
    def setup(self):
        cfg, dcfg, t = self.cfg, self.dcfg, self.traffic
        seed, dev = self.ctx.seed, self.device
        pool = mammo_pool(t["images_per_job"], cfg["image_height"], cfg["image_width"],
                          subseed(seed, "images"), dev)
        calib = pool[:t["calibration_images"]]
        self.sd_dissector = make_state_dict(breastclip_spec(dcfg), dcfg,
                                            subseed(seed, "dissector"), dev)
        calibrate(self.sd_dissector, dcfg, calib)
        self.sd_target = None
        if self.staged:
            self.sd_target = make_state_dict(classifier_spec(cfg), cfg, subseed(seed, "target"), dev)
            calibrate(self.sd_target, cfg, calib)
        self.pool = to_host(pool)
        del pool, calib
        self.build_program()
        self.job(np.arange(t["warmup_images"]))

    def build_program(self):
        from mammodissect_torch.dissect.dissectors import get_dissector
        from mammodissect_torch.dissect.targets import get_target_model

        dcfg = self.dcfg
        self.dissector = get_dissector("breastclip", vocab_file=self.vocab_path, device=self.device,
                                       dtype=dcfg["dtype"], bert_layers=dcfg["num_hidden_layers"],
                                       seed=0)
        self.dissector.max_length = dcfg["max_length"]
        self.dissector.module.load_state_dict(self.sd_dissector, strict=True)
        self.target = None
        if self.staged:
            self.target = get_target_model("breastclip_classifier", device=self.device,
                                           arch=self.cfg["arch"], num_class=self.cfg["n_class"])
            self.target.model.load_state_dict(self.sd_target, strict=True)

    def order(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(subseed(self.ctx.seed, f"order{i}"))
        return rng.permutation(self.traffic["images_per_job"])

    # ---------------------------------------------------------------- one job
    def job(self, order: np.ndarray, traced: bool = False) -> dict:
        from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

        t = self.traffic
        work = tempfile.mkdtemp(prefix="job_", dir=self.tmp)
        probe = JobProbe(self.pool, order, self.cfg["norm_mean"], self.cfg["norm_std"])
        cfg = DissectConfig(
            target_model="breastclip_classifier" if self.staged else "breastclip",
            clip_model="breastclip", target_layers=list(self.layers),
            d_probe="benchmark_mammo", concept_set=self.concept_path,
            batch_size=t["batch_size"], similarity_fn=t["similarity_fn"], top_k=t["top_k"],
            num_top_concepts=t["num_top_concepts"], num_top_images=t["num_top_images"],
            resident=t["resident"], wire_pack=t["wire_pack"], device=self.device.type,
            activation_dir=os.path.join(work, "acts"), result_dir=os.path.join(work, "results"))
        logs, timing = [], []

        def call():
            return run_dissection(cfg, probe=probe, target=self.target, dissector=self.dissector,
                                  log=logs.append, timing=timing)

        try:
            if traced:
                (df, _), *sl = tracing.profile(call, self.sync)
            else:
                (df, _), sl = call(), None
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return {"df": df, "order": order, "logs": logs, "timing": timing, "trace": sl}

    def free_program(self):
        self.dissector = self.target = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- reference
    @torch.no_grad()
    def reference(self, order: np.ndarray, target_mode=None, dissector_mode=None, rows: int = 16):
        """(scores [U, C], activations [N, U]) as numpy, of the images in `order`, by the
        plain reference; `*_mode` lowers its products' precision (the control)."""
        cfg, dcfg, dev = self.cfg, self.dcfg, self.device
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            acts, embs = [], []
            sd_t = self.sd_target if self.staged else self.sd_dissector
            for i in range(0, len(order), rows):
                u8 = torch.from_numpy(self.pool[order[i:i + rows]]).to(dev)
                x = efficientnet.normalize_u8(u8, cfg["norm_mean"], cfg["norm_std"])
                feats, pooled = efficientnet.tower(sd_t, cfg, x, "image_encoder.", target_mode)
                acts.append(torch.cat(pooled[:cfg["dissected_blocks"]], dim=1).cpu())
                if self.staged:
                    x = efficientnet.normalize_u8(u8, dcfg["norm_mean"], dcfg["norm_std"])
                    feats, _ = efficientnet.tower(self.sd_dissector, dcfg, x, "image_encoder.",
                                                  dissector_mode)
                emb = efficientnet.linear(feats, self.sd_dissector["image_projection.projection.weight"],
                                          self.sd_dissector["image_projection.projection.bias"],
                                          dissector_mode)
                embs.append(efficientnet.l2n(emb))
            acts_t = torch.cat(acts).to(dev)
            text = bert.embed_concepts(self.sd_dissector, dcfg, self.concepts, self.vocab, dev,
                                       mode=dissector_mode)
            scores = scoring.soft_wpmi(torch.cat(embs), text, acts_t, self.widths,
                                       self.traffic["top_k"])
            return scores.cpu().numpy(), acts_t.cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def control_job(self, order: np.ndarray, traced: bool = False) -> dict:
        """The reference in the nearest precision below the configurations' (the target's
        float32 as TF32, the bf16 dissector as fp8) in the program's place."""
        lower = {"float32": "tf32", "bfloat16": "fp8"}
        scores, acts = self.reference(order, lower[self.cfg["dtype"]], lower[self.dcfg["dtype"]])
        t = self.traffic
        df = compare.csv_frame(scores, acts, self.concepts, self.layers, self.widths,
                               t["num_top_concepts"], t["num_top_images"])
        return {"df": df, "order": order, "logs": [], "timing": [], "trace": None}

    def check(self, job: dict) -> Dict[str, float]:
        scores, acts = self.reference(job["order"])
        t = self.traffic
        return compare.readings(job["df"], scores, acts, self.concepts, self.layers, self.widths,
                                t["num_top_concepts"], t["num_top_images"])


def run(ctx, hook=None) -> Result:
    """`hook(cell)`, when given, may replace `cell.job` before the window (the
    control and the planted faults of the tests and the control runs)."""
    cell = Cell(ctx)
    result = Result(ctx=ctx, target_cfg=cell.cfg, dissector_cfg=cell.dcfg, staged=cell.staged,
                    n_concepts=len(cell.concepts), widths=cell.widths)
    try:
        if ctx.device.type == "cuda":
            result.power = power_limit()
        cell.setup()
        if hook is not None:
            hook(cell)
        cell.sync()
        cuda = ctx.device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(ctx.device)
        result.setup_s = time.perf_counter() - ctx.t_start

        def unit(i, traced):
            out = cell.job(cell.order(i), traced)
            return ctx.traffic["images_per_job"], out

        result.window = closed_loop(unit, ctx.seconds, trace_units=1 if ctx.trace else 0)
        if cuda:
            result.window_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
        result.memory_peak_bytes = max(setup_peak, result.window_peak_bytes)
        traced = [u for u in result.window.units if u.traced]
        if traced:
            result.trace = tracing.classify(*traced[0].out.pop("trace"))
        cell.free_program()
        units = result.window.units
        pick = np.random.default_rng(subseed(ctx.seed, "check")).integers(len(units))
        result.readings = cell.check(units[pick].out)
        for u in units:
            u.out.pop("df", None)
    finally:
        shutil.rmtree(cell.tmp, ignore_errors=True)
    return result
