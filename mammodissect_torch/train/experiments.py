"""Fine-tune and eval experiments (counterpart of `mammodissect/train/experiments.py`):
the reference's `Classifiers/experiments.py` and `single_gpu_experiments.py` on one
device. `do_experiments` splits the folds, maps the label to its class count, runs
the train loop with validation each epoch, aggregates at patient level, keeps the
best-metric checkpoint (a `.pth` that the `breastclip_classifier` dissection target
loads), and serves the inference, loaded-inference and unpretrained modes.

Entry points run on CUDA unless `FinetuneConfig.device` names the CPU; without a GPU
they raise. Each epoch logs its seconds split into host work (loading and
augmenting the images, `iter_epoch`) and the trainer's steps (`train_batch`,
`eval_batch`, each ending in a device sync).

Under a process group (one process per GPU, `parallel.multihost.initialize`) the
loops are data-parallel, as the JAX package's multi-host loops: each rank takes its
contiguous slice of every epoch (`iter_epoch(host_index, host_count)`, `batch_size`
rows a rank), the trainer all-reduces the gradients, and the eval predictions are
gathered and trimmed (`gather_predictions`). `model_parallel` > 1 lays the ranks out
as a ("data", "model") mesh: the classifier has no tensor-parallel parameter, so
the model axis replicates the data slices (JAX's plan). Only the first rank writes
checkpoints, the out-of-fold CSV and the logs."""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist

from mammodissect_torch import metrics as M
from mammodissect_torch.configs import save_config
from mammodissect_torch.convert import load_image_encoder_checkpoint
from mammodissect_torch.device import resolve_device, resolve_dtype, set_fp32_policy
from mammodissect_torch.models.classifier import (
    BreastClipClassifierModule,
    arch_is_linear_probe,
    arch_variant,
    frozen_param_labels,
)
from mammodissect_torch.models.layers import init_weights
from mammodissect_torch.parallel.mesh import (
    data_group,
    is_master,
    make_mesh,
    require_process_group,
)
from mammodissect_torch.parallel.multihost import gather_predictions
from mammodissect_torch.train.checkpoints import load_checkpoint, load_for_eval, save_checkpoint
from mammodissect_torch.train.data import ClassifierDataset, class_balanced_weights, iter_epoch
from mammodissect_torch.train.loggers import MasterOnlyWriter, WandbLogger
from mammodissect_torch.train.trainer import Trainer, make_optimizer
from mammodissect_torch.utils.meters import AverageMeter, timeSince
from mammodissect_torch.utils.seed import seed_all


@dataclass
class FinetuneConfig:
    """The flag surface of `Finetune/lumi_single_gpu_train_classifier.py:14-79`, as the
    JAX package's, plus `device` (None: CUDA)."""

    csv_file: str = ""
    data_dir: str = ""
    image_col: str = "image_path"
    dataset: str = "vindr"  # vindr | rsna | csaw
    label: str = "cancer"  # density | birads | cancer_birads | cancer | Mass | ...
    arch: str = "upmc_breast_clip_det_b5_period_n_ft"
    clip_chk_pt_path: Optional[str] = None
    checkpoints: str = "./checkpoints"
    output_path: str = "./outputs"
    tensorboard_path: str = "./tb_logs"
    epochs: int = 30
    batch_size: int = 8
    lr: float = 5.0e-5
    weight_decay: float = 1e-4
    warmup_epochs: float = 1.0
    img_size: tuple = (1520, 912)
    mean: float = 0.3089279
    std: float = 0.25053555
    seed: int = 10
    n_folds: int = 1
    cur_fold: int = 0
    weighted_BCE: str = "n"
    BCE_weights: Dict[str, float] = field(default_factory=dict)
    balanced_dataloader: str = "n"
    sampler_weights: Dict[int, float] = field(default_factory=dict)
    data_frac: float = 1.0
    running_interactive: bool = False
    inference_mode: str = "n"  # n | y | load | train_un_mammopretrained
    finetuned_ckpt_path: Optional[str] = None
    model_parallel: int = 1
    dtype: str = "bfloat16"  # compute dtype; parameters and optimizer state stay float32
    input_wire: str = "u8"  # 'u8': uint8 batches normalized on the device; 'f32'
    bn_momentum: float = 0.99  # lower for short fine-tunes so running stats converge
    pad_mode: str = "static"  # the reference's static SAME; "same" for toy geometries
    remat: bool = False  # recompute each block in the backward: less activation memory
    resume_from: Optional[str] = None  # a checkpoint: restore weights, optimizer, epoch
    train_eval: bool = True  # also eval the train folds each epoch (`experiments.py:200-217`)
    print_freq: int = 50
    log_freq: int = 10
    wandb: bool = False
    model_base_name: str = "mammodissect_clf"
    VER: str = "1"
    device: Optional[str] = None  # None: cuda (raises without a GPU); "cpu" on request

    @property
    def n_class(self) -> int:
        # `experiments.py:122-129`
        return {"density": 4, "cancer_birads": 5, "birads": 3}.get(self.label.lower(), 1)

    @property
    def multiclass(self) -> bool:
        return self.n_class > 1


def split_folds(cfg: FinetuneConfig, df: pd.DataFrame):
    """Fold logic (`experiments.py:43-61`): RSNA by fold column, VinDr/CSAW by split column."""
    ds = cfg.dataset.lower()
    if ds == "rsna" and "fold" in df.columns:
        train_folds = df[df["fold"] != cfg.cur_fold].reset_index(drop=True)
        valid_folds = df[df["fold"] == cfg.cur_fold].reset_index(drop=True)
    elif "split" in df.columns:
        train_split = "training" if (df["split"] == "training").any() else "train"
        train_folds = df[df["split"] == train_split].reset_index(drop=True)
        valid_folds = df[df["split"] != train_split].reset_index(drop=True)
    else:
        cut = int(len(df) * 0.8)
        train_folds = df.iloc[:cut].reset_index(drop=True)
        valid_folds = df.iloc[cut:].reset_index(drop=True)
    if cfg.data_frac < 1.0:
        train_folds = train_folds.sample(frac=cfg.data_frac, random_state=1).reset_index(drop=True)
    if cfg.running_interactive:  # smoke mode (`experiments.py:110-114`)
        train_folds = train_folds.sample(min(1000, len(train_folds)),
                                         random_state=1).reset_index(drop=True)
        valid_folds = valid_folds.sample(min(1000, len(valid_folds)),
                                         random_state=1).reset_index(drop=True)
    return train_folds, valid_folds


def aggregate_patient_level(cfg: FinetuneConfig, folds: pd.DataFrame) -> pd.DataFrame:
    """Patient/laterality aggregation before the metrics (`experiments.py:208-217`)."""
    ds = cfg.dataset.lower()
    if ds == "rsna" and {"patient_id", "laterality"} <= set(folds.columns):
        return folds[["patient_id", "laterality", cfg.label, "prediction"]].groupby(
            ["patient_id", "laterality"]).mean().reset_index()
    if ds == "csaw" and "anon_filename" in folds.columns:
        return folds[["anon_filename", cfg.label, "prediction"]].groupby(
            ["anon_filename"]).mean().reset_index()
    return folds


class _Topology:
    """The run's ranks: a mesh when model_parallel > 1 (which needs a process group),
    the data group (None: one process), this rank's data index and the data size."""

    def __init__(self, cfg: FinetuneConfig):
        self.mesh = make_mesh(cfg.model_parallel) if cfg.model_parallel > 1 else None
        self.group = data_group(self.mesh)
        self.index = dist.get_rank(self.group) if self.group is not None else 0
        self.count = dist.get_world_size(self.group) if self.group is not None else 1

    def barrier(self):
        if dist.is_initialized():
            dist.barrier()


def build_model(cfg: FinetuneConfig) -> BreastClipClassifierModule:
    """The BreastClipClassifier of `cfg.arch` (`breast_clip_classifier.py:6-51`) with
    float32 master weights and `cfg.dtype` compute, random weights from `cfg.seed`,
    then the image encoder of the Mammo-CLIP checkpoint when given (strict=False)."""
    model = BreastClipClassifierModule(
        variant=arch_variant(cfg.arch), n_class=cfg.n_class,
        freeze_encoder=arch_is_linear_probe(cfg.arch), dtype=resolve_dtype(cfg.dtype),
        param_dtype=torch.float32, bn_momentum=cfg.bn_momentum, pad_mode=cfg.pad_mode,
        remat=cfg.remat)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.clip_chk_pt_path:
        load_image_encoder_checkpoint(cfg.clip_chk_pt_path, model.image_encoder)
    return model


def warmup_steps_of(cfg: FinetuneConfig, steps_per_epoch: int) -> int:
    """The reference's warmup-step rule (`experiments.py:144-150`): warmup_epochs 0.1
    means as many steps as epochs, 1 one epoch of steps, anything else 10 steps."""
    if cfg.warmup_epochs == 0.1:
        return cfg.epochs
    if cfg.warmup_epochs == 1:
        return steps_per_epoch
    return 10


def _make_trainer(cfg: FinetuneConfig, model, optimizer, scheduler, device, topo: _Topology,
                  pos_weight: Optional[float] = None) -> Trainer:
    return Trainer(model, optimizer, scheduler, loss_kind="ce" if cfg.multiclass else "bce",
                   pos_weight=pos_weight, seed=cfg.seed, input_wire=cfg.input_wire,
                   norm_mean=cfg.mean, norm_std=cfg.std, device=device, mesh=topo.mesh)


def _prepare(cfg: FinetuneConfig) -> torch.device:
    """The run's device (raises without a GPU unless cfg.device names the CPU), with
    TF32 off for float32 runs, as in every entry point of the port."""
    device = resolve_device(cfg.device)
    if device.type == "cuda":
        set_fp32_policy()
    return device


def _epoch_metrics(cfg: FinetuneConfig, folds: pd.DataFrame, predictions: np.ndarray) -> Dict:
    folds = folds.copy()
    folds["prediction"] = predictions[: len(folds)]
    agg = aggregate_patient_level(cfg, folds)
    out: Dict[str, float] = {}
    if cfg.multiclass:
        out["accuracy"] = float((agg[cfg.label] == agg["prediction"]).mean())
        out["f1"] = M.f1_macro(agg[cfg.label].values, agg["prediction"].values)
    else:
        out["auroc"] = M.auroc(agg[cfg.label].values, agg["prediction"].values)
        out["pr_auc"] = M.pr_auc(agg[cfg.label].values, agg["prediction"].values)
        out["pfbeta"] = M.pfbeta(agg[cfg.label].values, agg["prediction"].values)
    return out


def _mem_postfix(device: torch.device) -> str:
    """Device-memory log postfix (the reference's tqdm CUDA-Mem readout,
    `experiments.py:440-447`); empty off CUDA."""
    if device.type != "cuda":
        return ""
    used = torch.cuda.memory_allocated(device)
    total = torch.cuda.get_device_properties(device).total_memory
    return f" [mem {used / 1e9:.2f}/{total / 1e9:.1f} GB]"


class _Clock:
    """Seconds of host data work and of trainer steps, by kind."""

    def __init__(self):
        self.seconds = {"data": 0.0, "train_batch": 0.0, "eval_batch": 0.0}

    def batches(self, iterator):
        """`iterator`'s items, the time spent producing them counted as data."""
        it = iter(iterator)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self.seconds["data"] += time.perf_counter() - t0
            yield item

    def run(self, kind: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.seconds[kind] += time.perf_counter() - t0


def _run_eval(trainer: Trainer, dataset, batch_size: int, label_dtype, clock: _Clock,
              topo: _Topology):
    """Eval pass: (mean loss over this rank's real rows, predictions trimmed to the
    dataset); each rank scores its slice and the predictions are gathered."""
    losses = AverageMeter()
    preds = []
    for batch in clock.batches(iter_epoch(dataset, batch_size, shuffle=False,
                                          label_dtype=label_dtype, host_index=topo.index,
                                          host_count=topo.count)):
        loss, p = clock.run("eval_batch", trainer.eval_batch, batch.images, batch.labels,
                            batch.n_valid)
        losses.update(loss, batch.n_valid)
        preds.append(p[: batch.n_valid])
    local = np.concatenate(preds) if preds else np.zeros(0, np.float32)
    return losses.avg, gather_predictions(local, len(dataset), topo.group)


def checkpoint_path(cfg: FinetuneConfig) -> str:
    """The best-metric checkpoint of a fold (the reference's name, `.pth`)."""
    return os.path.join(
        cfg.checkpoints,
        f"{cfg.model_base_name}_seed_{cfg.seed}_fold{cfg.cur_fold}_best_{cfg.label}_ver{cfg.VER}.pth")


def train_loop(cfg: FinetuneConfig, train_folds: pd.DataFrame, valid_folds: pd.DataFrame,
               log=print) -> pd.DataFrame:
    """`experiments.py:97-310`: train with validation each epoch, keep the best
    checkpoint; returns the valid folds with the best epoch's predictions."""
    device = _prepare(cfg)
    topo = _Topology(cfg)
    seed_all(cfg.seed)
    model = build_model(cfg).to(device)

    label_dtype = np.int32 if cfg.multiclass else np.float32

    def mk_ds(df, train):
        return ClassifierDataset(df, image_col=cfg.image_col, label_col=cfg.label,
                                 root=cfg.data_dir, size_hw=tuple(cfg.img_size), mean=cfg.mean,
                                 std=cfg.std, train=train, seed=cfg.seed, wire=cfg.input_wire)

    train_ds, valid_ds = mk_ds(train_folds, True), mk_ds(valid_folds, False)
    # ceil: iter_epoch yields the padded tail batch, and an undercounted total would
    # park the cosine tail at the terminal lr; each rank steps through its slice
    shard_len = -(-len(train_ds) // topo.count)
    steps_per_epoch = max(-(-shard_len // cfg.batch_size), 1)
    warmup_steps = warmup_steps_of(cfg, steps_per_epoch)
    labels = frozen_param_labels(model, arch_is_linear_probe(cfg.arch))
    optimizer, scheduler = make_optimizer(model, cfg.lr, cfg.weight_decay, warmup_steps,
                                          steps_per_epoch * cfg.epochs, param_labels=labels)

    pos_weight = None
    if cfg.weighted_BCE == "y" and not cfg.multiclass:
        pos_weight = float(cfg.BCE_weights.get(f"fold{cfg.cur_fold}", 1.0))
    trainer = _make_trainer(cfg, model, optimizer, scheduler, device, topo, pos_weight)
    start_epoch = 0
    if cfg.resume_from:
        ckpt = load_checkpoint(cfg.resume_from)
        trainer.restore(ckpt)
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        log(f"[resume] restored step {trainer.step}, continuing at epoch {start_epoch}")

    tb = MasterOnlyWriter(os.path.join(cfg.tensorboard_path, f"fold{cfg.cur_fold}"))
    wb = WandbLogger("MammoCLIP_classifier_finetune", config=dataclasses.asdict(cfg),
                     enabled=cfg.wandb)
    master = is_master()
    balanced = None
    if cfg.balanced_dataloader == "y":
        balanced = class_balanced_weights(train_folds[cfg.label].values.astype(np.int64),
                                          cfg.sampler_weights or None)

    os.makedirs(cfg.checkpoints, exist_ok=True)
    ckpt_path = checkpoint_path(cfg)
    best_metric = -np.inf
    if start_epoch > 0 and os.path.exists(ckpt_path):
        # resuming into a directory that holds a best checkpoint: keep its metric as
        # the standing best, or the first epoch after the resume would overwrite a
        # better checkpoint with a worse one
        m = load_for_eval(ckpt_path)["metrics"]
        best_metric = float(m.get("accuracy", m.get("auroc", -np.inf)))
        log(f"[resume] standing best at {ckpt_path}: {best_metric:.4f}")
    start = time.time()
    step = trainer.step
    for epoch in range(start_epoch, cfg.epochs):
        clock = _Clock()
        losses = AverageMeter()
        for batch in clock.batches(iter_epoch(train_ds, cfg.batch_size, shuffle=True,
                                              seed=cfg.seed + epoch, balanced_weights=balanced,
                                              label_dtype=label_dtype, host_index=topo.index,
                                              host_count=topo.count)):
            loss = clock.run("train_batch", trainer.train_batch, batch.images, batch.labels,
                             batch.n_valid)
            losses.update(loss, batch.n_valid)
            step += 1
            if step % cfg.log_freq == 0:
                tb.add_scalar("train/iter_loss", loss, step)
            if step % cfg.print_freq == 0:
                log(f"epoch {epoch} step {step} loss {loss:.4f} "
                    f"{timeSince(start, (epoch + 1) / cfg.epochs)}{_mem_postfix(device)}")

        val_loss, predictions = _run_eval(trainer, valid_ds, cfg.batch_size, label_dtype, clock,
                                          topo)
        metrics = _epoch_metrics(cfg, valid_folds, predictions)
        tb.add_scalar("train/epoch", losses.avg, epoch + 1)
        tb.add_scalar("valid/iter_loss", val_loss, epoch + 1)
        for k, v in metrics.items():
            tb.add_scalar(f"valid/{cfg.label}/{k}", v, epoch + 1)
        train_metrics = {}
        if cfg.train_eval:
            # eval-mode pass over the train folds (the reference's train_eval_loader,
            # `experiments.py:200-217,229-230,256`)
            _, tr_predictions = _run_eval(trainer, mk_ds(train_folds, False), cfg.batch_size,
                                          label_dtype, clock, topo)
            train_metrics = {f"train_{k}": v for k, v in
                             _epoch_metrics(cfg, train_folds, tr_predictions).items()}
        wb.log({"epoch": epoch + 1, "train_loss": losses.avg, "valid_loss": val_loss,
                **metrics, **train_metrics})

        watch = metrics.get("accuracy", metrics.get("auroc", 0.0))
        if not np.isnan(watch) and watch > best_metric:
            best_metric = watch
            if master:
                save_checkpoint(ckpt_path, trainer, epoch, metrics, predictions)
            log(f"epoch {epoch + 1}: new best {watch:.4f} -> {ckpt_path}")
        log(f"epoch {epoch + 1}: train {losses.avg:.4f} valid {val_loss:.4f} "
            f"{metrics} {train_metrics}")
        s = clock.seconds
        log(f"[time] epoch {epoch + 1}: data {s['data']:.3f} s, train_batch "
            f"{s['train_batch']:.3f} s, eval_batch {s['eval_batch']:.3f} s")

    tb.close()
    wb.finish()
    topo.barrier()  # the first rank's best checkpoint is written before any rank reads it
    valid_folds = valid_folds.copy()
    if os.path.exists(ckpt_path):
        best = load_for_eval(ckpt_path)
        if best["predictions"] is not None:
            valid_folds["prediction"] = best["predictions"][: len(valid_folds)]
    return valid_folds


def inference_loop(cfg: FinetuneConfig, valid_folds: pd.DataFrame, log=print) -> pd.DataFrame:
    """Rebuild the classifier from the fine-tuned checkpoint and rerun validation
    (`single_gpu_experiments.py:296-372`)."""
    device = _prepare(cfg)
    topo = _Topology(cfg)
    model = build_model(cfg)
    if cfg.finetuned_ckpt_path:
        model.load_state_dict(load_for_eval(cfg.finetuned_ckpt_path)["model"])
    model.to(device)
    optimizer, scheduler = make_optimizer(model, cfg.lr, cfg.weight_decay, 1, 10)
    trainer = _make_trainer(cfg, model, optimizer, scheduler, device, topo)
    ds = ClassifierDataset(valid_folds, image_col=cfg.image_col, label_col=cfg.label,
                           root=cfg.data_dir, size_hw=tuple(cfg.img_size), mean=cfg.mean,
                           std=cfg.std, train=False, wire=cfg.input_wire)
    label_dtype = np.int32 if cfg.multiclass else np.float32
    _, predictions = _run_eval(trainer, ds, cfg.batch_size, label_dtype, _Clock(), topo)
    metrics = _epoch_metrics(cfg, valid_folds, predictions)
    log(f"[inference] {metrics}")
    out = valid_folds.copy()
    out["prediction"] = predictions[: len(out)]
    return out


def loaded_inference_loop(cfg: FinetuneConfig, valid_folds: pd.DataFrame, log=print):
    """Rescore the checkpoint's saved predictions and dump the false positives and
    negatives at the optimal ROC threshold (`single_gpu_experiments.py:593-616`,
    `experiments.py:677-715`)."""
    predictions = load_for_eval(cfg.finetuned_ckpt_path)["predictions"]
    out = valid_folds.copy()
    out["prediction"] = predictions[: len(out)]
    metrics = _epoch_metrics(cfg, valid_folds, predictions)
    if not cfg.multiclass:
        th = M.optimal_roc_threshold(out[cfg.label].values, out["prediction"].values)
        out["pred_binary"] = (out["prediction"] >= th).astype(int)
        fp = out[(out["pred_binary"] == 1) & (out[cfg.label] == 0)]
        fn = out[(out["pred_binary"] == 0) & (out[cfg.label] == 1)]
        metrics["optimal_threshold"] = th
    if not cfg.multiclass and is_master():
        os.makedirs(cfg.output_path, exist_ok=True)
        fp.to_csv(os.path.join(cfg.output_path, f"fold{cfg.cur_fold}_false_positives.csv"),
                  index=False)
        fn.to_csv(os.path.join(cfg.output_path, f"fold{cfg.cur_fold}_false_negatives.csv"),
                  index=False)
    log(f"[loaded_inference] {metrics}")
    return out, metrics


def do_experiments(cfg: FinetuneConfig, log=print) -> pd.DataFrame:
    """`do_experiments(args, device)` (`experiments.py:23-94`): every fold, then the
    out-of-fold predictions CSV and CV AUROC."""
    _prepare(cfg)  # refuse a missing GPU before writing anything
    if cfg.model_parallel > 1:
        require_process_group(f"model_parallel={cfg.model_parallel}")
    master = is_master()
    os.makedirs(cfg.output_path, exist_ok=True)
    # run metadata beside the outputs (`lumi_single_gpu_train_classifier.py:153`)
    if master:
        save_config(cfg, os.path.join(cfg.output_path, "run_config.json"))
    df = pd.read_csv(cfg.csv_file)
    oof = []
    for fold in range(max(cfg.n_folds, 1)):
        cfg = dataclasses.replace(cfg, cur_fold=fold)
        train_folds, valid_folds = split_folds(cfg, df)
        if cfg.inference_mode == "y":
            result = inference_loop(cfg, valid_folds, log=log)
        elif cfg.inference_mode == "load":
            result, _ = loaded_inference_loop(cfg, valid_folds, log=log)
        elif cfg.inference_mode == "train_un_mammopretrained":
            # random-init encoder baseline (`single_gpu_experiments.py:64,619-672`)
            result = train_loop(dataclasses.replace(cfg, clip_chk_pt_path=None), train_folds,
                                valid_folds, log=log)
        else:
            result = train_loop(cfg, train_folds, valid_folds, log=log)
        oof.append(result)
    oof_df = pd.concat(oof, ignore_index=True)
    # out-of-fold CV metric (`experiments.py:73-94`)
    if not cfg.multiclass and "prediction" in oof_df.columns:
        agg = aggregate_patient_level(cfg, oof_df)
        log(f"[cv] auroc={M.auroc(agg[cfg.label].values, agg['prediction'].values):.4f}")
        if master:
            oof_df.to_csv(os.path.join(cfg.output_path, "oof_predictions.csv"), index=False)
    return oof_df
