"""BreastClip contrastive pretraining loop (counterpart of
`mammodissect/train/pretrain.py`; the loss config {label_smoothing, i2i_weight 1.0,
t2t_weight 0.5} of `concept_vit/utils.py:443`).

bf16 compute over float32 master weights (`dtype`), AdamW with the per-step
warmup-cosine schedule, the dataset's wire (`f32`, or `u8` normalized on the
device). Checkpoints are `.pth` files (where JAX writes orbax directories) holding
the model, the optimizer, the scheduler and the step: `step_{n}.pth` every
`ckpt_freq_steps` and `final.pth` at the end. The model's state dict keeps the
reference's names, so `convert.load_breastclip_checkpoint` reads `final.pth` as a
Mammo-CLIP dissector (`get_dissector("breastclip", ckpt_path=...)`).

Under a process group (one process per GPU, `parallel.multihost.initialize`) the
ranks form a ("data", "model") mesh of `model_parallel` columns: BERT and the
projection heads are split over "model" (`apply_tensor_parallel`), the global
contrastive batch of `batch_size` rows over "data" (each data index materializes
its slice, `ImageTextDataset.batches(host_index, host_count)`). `model_parallel` > 1
needs the process group. Only the first rank writes checkpoints and logs; a
tensor-parallel checkpoint holds the gathered whole tensors, so `final.pth` loads
as the single-GPU dissector."""
from __future__ import annotations

import math
import os
import types
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from mammodissect_torch.device import resolve_device, resolve_dtype
from mammodissect_torch.models.breastclip import BreastClip, default_model_config
from mammodissect_torch.models.tokenizers import WordPieceTokenizer
from mammodissect_torch.parallel.mesh import data_group, is_master, make_mesh
from mammodissect_torch.parallel.sharding import (
    apply_tensor_parallel,
    full_optimizer_state,
    full_state_dict,
)
from mammodissect_torch.train.checkpoints import save_checkpoint
from mammodissect_torch.train.clip_trainer import batch_to_device, make_clip_train_step
from mammodissect_torch.train.loggers import MasterOnlyWriter
from mammodissect_torch.train.trainer import make_optimizer
from mammodissect_torch.utils.seed import seed_all


@dataclass
class PretrainConfig:
    csv_file: str = ""
    root: str = ""
    img_dir: str = ""
    dataset: str = "vindr"
    prompts_json: Optional[str] = None
    vocab_file: Optional[str] = None
    epochs: int = 10
    batch_size: int = 16
    lr: float = 5.0e-5
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    img_size: tuple = (1520, 912)
    text_max_length: int = 256
    label_smoothing: float = 0.0
    i2i_weight: float = 1.0
    t2t_weight: float = 0.5
    model_parallel: int = 1
    checkpoints: str = "./checkpoints_pretrain"
    tensorboard_path: str = "./tb_pretrain"
    seed: int = 10
    bert_layers: int = 12
    image_variant: str = "efficientnet-b5"
    dtype: str = "bfloat16"
    log_freq: int = 10
    ckpt_freq_steps: int = 500
    device: Optional[str] = None  # None: CUDA, which raises without a GPU


def build_clip(cfg: PretrainConfig, tokenizer, device: torch.device) -> BreastClip:
    """The canonical BreastClip with `cfg`'s image variant and BERT depth, random
    weights from `cfg.seed`, `cfg.dtype` compute over float32 weights."""
    model_config = default_model_config()
    model_config["image_encoder"]["variant"] = cfg.image_variant
    return BreastClip.create(model_config=model_config, tokenizer=tokenizer, seed=cfg.seed,
                             bert_layers=cfg.bert_layers, vocab_size=len(tokenizer.vocab),
                             dtype=resolve_dtype(cfg.dtype), param_dtype=torch.float32,
                             device=device)


def pretrain(cfg: PretrainConfig, dataset, log=print) -> Dict:
    """Contrastive pretraining over an ImageTextDataset: {"steps", "final_checkpoint",
    "last_loss"} (NaN when the dataset holds fewer rows than a batch: no step)."""
    device = resolve_device(cfg.device)
    mesh = None
    if cfg.model_parallel > 1 or torch.distributed.is_initialized():
        mesh = make_mesh(cfg.model_parallel)  # raises without a process group
    group = data_group(mesh)
    hi, hc = ((torch.distributed.get_rank(group), torch.distributed.get_world_size(group))
              if group is not None else (0, 1))
    seed_all(cfg.seed)
    tok = (WordPieceTokenizer(vocab_file=cfg.vocab_file) if cfg.vocab_file
           else WordPieceTokenizer.toy())
    model = build_clip(cfg, tok, device).module
    tensor_parallel = cfg.model_parallel > 1
    if tensor_parallel:
        apply_tensor_parallel(model, mesh)

    steps_per_epoch = max(len(dataset) // cfg.batch_size, 1)
    total_steps = steps_per_epoch * cfg.epochs
    optimizer, scheduler = make_optimizer(model, cfg.lr, cfg.weight_decay, cfg.warmup_steps,
                                          total_steps)
    step_fn = make_clip_train_step(
        model, optimizer, scheduler, label_smoothing=cfg.label_smoothing,
        i2i_weight=cfg.i2i_weight, t2t_weight=cfg.t2t_weight,
        # the dataset declares its wire: u8 datasets ship post-transform uint8 and
        # the step normalizes on the device with the dataset's own constants
        input_wire=getattr(dataset, "wire", "f32"), norm_mean=getattr(dataset, "mean", 0.0),
        norm_std=getattr(dataset, "std", 1.0),
        generator=torch.Generator(device=device).manual_seed(cfg.seed), mesh=mesh)

    tb = MasterOnlyWriter(cfg.tensorboard_path)
    os.makedirs(cfg.checkpoints, exist_ok=True)
    state = types.SimpleNamespace(model=model, optimizer=optimizer, scheduler=scheduler, step=0)

    def save(name, epoch):
        # a collective under tensor parallelism: every rank gathers, the first writes
        whole = ({"model_state": full_state_dict(model),
                  "optimizer_state": full_optimizer_state(optimizer, model)}
                 if tensor_parallel else {})
        path = os.path.join(cfg.checkpoints, name)
        return save_checkpoint(path, state, epoch, {}, **whole) if is_master() else path

    loss = torch.tensor(math.nan)  # len(dataset) < batch_size gives no batch (drop_last)
    for epoch in range(cfg.epochs):
        for batch in dataset.batches(tok, cfg.batch_size, max_length=cfg.text_max_length,
                                     seed=cfg.seed + epoch, host_index=hi, host_count=hc):
            loss = step_fn(batch_to_device(batch, device))
            state.step += 1
            if state.step % cfg.log_freq == 0:
                lv = float(loss)
                tb.add_scalar("pretrain/loss", lv, state.step)
                log(f"epoch {epoch} step {state.step}/{total_steps} loss {lv:.4f}")
            if state.step % cfg.ckpt_freq_steps == 0:
                save(f"step_{state.step}.pth", epoch)
    final = save("final.pth", cfg.epochs)
    tb.close()
    return {"steps": state.step, "final_checkpoint": final, "last_loss": float(loss)}
