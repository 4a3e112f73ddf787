"""Driver of the `train_steps` traffic: fine-tuning steps, one client, closed loop.

Set-up (what `setup_s` counts): a pool of distinct seeded mammogram-shaped images
made on the device and copied once to pinned host memory, labels drawn from the seed
(`positive_share` positive); the classifier's float32 weights made on the device;
the program's model built by its fine-tuning entry (`train.experiments.build_model`),
loaded with those weights, its AdamW and schedule (`train.trainer.make_optimizer`)
and its `Trainer` on the uint8 wire. Then the first `checked_steps` steps through
`Trainer.train_batch` on batches whose rows all differ: they warm up every shape,
and they are the steps the reference follows (each loss, the first gradient as the
optimizer holds it, the weights after the last of them).

The window: `Trainer.train_batch` steps back to back on the pool's batches in turn,
each ending on its loss read back to the host. With --trace 1 the window's first
unit is `trace_steps` steps under the profiler.

After the window: the peak memory is read, the program is freed, and the plain
reference (`reference/train.py`) runs the checked steps from the same weights on
the same batches."""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import trace as tracing
from benchmark.core import power_limit
from benchmark.images import mammo_pool, to_host
from benchmark.reference import train as reference
from benchmark.weights import classifier_spec, make_state_dict, subseed
from benchmark.window import closed_loop

BETAS, EPS = (0.9, 0.999), 1e-8


@dataclass
class Result:
    ctx: object
    target_cfg: dict
    window: object = None
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    window_peak_bytes: int = 0
    trace: Optional[tracing.Slice] = None
    readings: Dict[str, float] = field(default_factory=dict)
    power: Optional[str] = None
    step_seconds: List[float] = field(default_factory=list)

    @property
    def attempted(self) -> int:
        """Steps of the window (a traced unit is `trace_steps` of them)."""
        return sum(u.work for u in self.window.units) // self.ctx.traffic["batch_size"]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def gaps(got: Dict[str, float], want: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap between two norms, against the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    keys = [k for k in want if keep is None or k in keep]
    median = float(np.median([want[k] for k in keys]))
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], median) for k in keys}


class Cell:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.traffic = ctx, ctx.config, ctx.traffic
        self.device = ctx.device
        self.spec = classifier_spec(self.cfg)
        self.leaves = [name + suffix if kind in ("bn", "bn_residual") else name
                       for name, _, kind in self.spec
                       for suffix in ((".weight", ".bias") if kind in ("bn", "bn_residual")
                                      else ("",))]
        t = self.traffic
        self.lr_at = reference.warmup_cosine(t["lr"], t["warmup_steps"], t["total_steps"])
        # the trainer's generator draws only the drop-connect masks; the reference
        # draws them again from a generator seeded alike
        self.drop_seed = subseed(ctx.seed, "trainer")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def batch(self, i: int):
        """Batch i of the pool's turns: rows all distinct within a turn."""
        b = self.traffic["batch_size"]
        n = len(self.pool) // b
        j = i % n
        return self.pool[j * b:(j + 1) * b], self.labels[j]

    def setup(self):
        cfg, t, dev, seed = self.cfg, self.traffic, self.device, self.ctx.seed
        pool = mammo_pool(t["pool_images"], cfg["image_height"], cfg["image_width"],
                          subseed(seed, "images"), dev)
        self.pool = to_host(pool)
        del pool
        rng = np.random.default_rng(subseed(seed, "labels"))
        self.labels = (rng.random((t["pool_images"] // t["batch_size"], t["batch_size"]))
                       < t["positive_share"]).astype(np.float32)
        self.sd = make_state_dict(self.spec, cfg, subseed(seed, "finetune"), dev)
        self.build_program()
        self.checked = self.first_steps()

    def build_program(self):
        from mammodissect_torch.train.experiments import FinetuneConfig, build_model
        from mammodissect_torch.train.trainer import Trainer, make_optimizer

        cfg, t = self.cfg, self.traffic
        fc = FinetuneConfig(arch=cfg["arch"], dtype=t["compute_dtype"], remat=t["remat"],
                            lr=t["lr"], weight_decay=t["weight_decay"], mean=cfg["norm_mean"],
                            std=cfg["norm_std"], device=self.device.type)
        model = build_model(fc)
        model.load_state_dict(self.sd, strict=True)
        optimizer, scheduler = make_optimizer(model, t["lr"], t["weight_decay"],
                                              t["warmup_steps"], t["total_steps"])
        self.trainer = Trainer(model.to(self.device), optimizer, scheduler, loss_kind="bce",
                               pos_weight=t["pos_weight"], seed=self.drop_seed,
                               input_wire="u8", norm_mean=cfg["norm_mean"],
                               norm_std=cfg["norm_std"], device=self.device)

    def step(self, i: int) -> float:
        return self.trainer.train_batch(*self.batch(i))

    def first_steps(self) -> dict:
        """The checked steps through the program: losses, the first gradient from
        AdamW's first moment after one update (m = (1 - beta1) g), the weights after
        the last."""
        model, opt = self.trainer.model, self.trainer.optimizer
        named = dict(model.named_parameters())
        losses = []
        for i in range(self.traffic["checked_steps"]):
            losses.append(self.step(i))
            if i == 0:
                first = {k: opt.state[p]["exp_avg"].detach() / (1 - BETAS[0])
                         for k, p in named.items() if p in opt.state}
                first = norms(first)
        after = norms({k: p.detach().float() - self.sd[k].float() for k, p in named.items()})
        return {"losses": losses, "first": first, "change": after}

    def reference_steps(self, mode=None) -> dict:
        dev = self.device
        batches = [(torch.from_numpy(np.ascontiguousarray(u8)).to(dev), torch.from_numpy(y).to(dev))
                   for u8, y in (self.batch(i) for i in range(self.traffic["checked_steps"]))]
        losses, first, after = reference.train(
            self.sd, self.leaves, self.cfg, batches, self.lr_at, self.traffic["weight_decay"],
            self.traffic["pos_weight"], self.drop_seed, BETAS, EPS, mode)
        return {"losses": losses, "first": norms(first),
                "change": norms({k: after[k] - self.sd[k].float() for k in self.leaves})}

    def control_steps(self) -> dict:
        """The reference in the nearest precision below the configured compute dtype
        (bf16 -> fp8 e4m3) in the program's place."""
        return self.reference_steps("fp8")

    def free_program(self):
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        got, want = self.checked, self.reference_steps()
        median = float(np.median(list(want["first"].values())))
        # leaves whose reference gradient is nought to rounding (the last BatchNorm
        # shift of each block, which a later training BatchNorm takes out) move under
        # Adam by round-off alone: a rule on the reference's gradient leaves them out
        moved = {k for k, g in want["first"].items() if g >= 1e-3 * median}
        grad = gaps(got["first"], want["first"], moved)
        change = gaps(got["change"], want["change"], moved)
        for name, per_leaf in (("grad", grad), ("change", change)):
            worst = sorted(per_leaf, key=per_leaf.get)[-3:]
            print(f"worst {name} leaves: " + ", ".join(f"{k} {per_leaf[k]:.4g}" for k in worst),
                  file=sys.stderr)
        print(f"leaves left out: {sorted(set(want['first']) - moved)}", file=sys.stderr)
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
                "grad_gap": max(grad.values()), "grad_gap_median": float(np.median(list(grad.values()))),
                "change_gap": max(change.values()),
                "change_gap_median": float(np.median(list(change.values())))}


def run(ctx, hook=None) -> Result:
    """`hook(cell)`, when given, runs after the program is built and before the checked
    steps: the control replaces `cell.first_steps`, a planted fault the program."""
    cell = Cell(ctx)
    result = Result(ctx=ctx, target_cfg=cell.cfg)
    cuda = ctx.device.type == "cuda"
    if cuda:
        result.power = power_limit()
    if hook is not None:
        build = cell.build_program

        def build_then_hook():
            build()
            hook(cell)

        cell.build_program = build_then_hook
    cell.setup()
    cell.sync()
    setup_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    result.setup_s = time.perf_counter() - ctx.t_start
    t = ctx.traffic
    first = t["checked_steps"]
    done = [first]

    def unit(i, traced):
        if traced:
            def steps():
                for j in range(t["trace_steps"]):
                    cell.step(done[0] + j)
            _, events, wall = tracing.profile(steps, cell.sync)
            done[0] += t["trace_steps"]
            return t["trace_steps"] * t["batch_size"], (events, wall)
        cell.step(done[0])
        done[0] += 1
        return t["batch_size"], None

    result.window = closed_loop(unit, ctx.seconds, trace_units=1 if ctx.trace else 0)
    if cuda:
        result.window_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    result.memory_peak_bytes = max(setup_peak, result.window_peak_bytes)
    traced = [u for u in result.window.units if u.traced]
    if traced:
        result.trace = tracing.classify(*traced[0].out)
    result.step_seconds = [u.seconds for u in result.window.units if not u.traced]
    cell.free_program()
    result.readings = cell.check()
    return result
