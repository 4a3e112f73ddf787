"""BreastClip contrastive pretraining step (counterpart of
`mammodissect/train/clip_trainer.py`): the loss config {label_smoothing, i2i_weight
1.0, t2t_weight 0.5} of `concept_vit/utils.py:443`, one update.

`make_clip_train_step` returns step(batch) -> loss: the uint8 wire normalized on
the device (`ops.normalize.u8_minmax_meanstd`), the training forward
(`BreastClipModule.forward`: batch-statistics BatchNorm with flax's update rule,
drop-connect and dropout from the step's generator), `clip_contrastive_loss`, one
AdamW update (`train.trainer.make_optimizer`) and one step of its per-step
warmup-cosine `LambdaLR`.

Under a process group the step is data-parallel over the data axis of `mesh` (None:
every rank), as JAX's `jit_clip_train_step` over its mesh: each rank passes its
slice of the global contrastive batch, the model runs wrapped in
DistributedDataParallel (`broadcast_buffers` off: the synced BatchNorm keeps the
statistics equal), the loss gathers the embeddings over the data group, and the
returned loss is the global batch's. Tensor parallelism over the mesh's "model" axis
is a property of the model: `parallel.sharding.apply_tensor_parallel` splits it
before its optimizer is built."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mammodissect_torch.ops.normalize import u8_minmax_meanstd
from mammodissect_torch.parallel.collectives import pmean
from mammodissect_torch.parallel.mesh import data_group, data_parallel
from mammodissect_torch.train.losses import clip_contrastive_loss

IMAGE_KEYS = ("images", "image_views")
TEXT_KEYS = ("texts", "texts2")  # host-side strings of a collated batch


def batch_to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated host batch (`ImageTextDataset.batches`) as tensors on `device`:
    images through a pinned buffer with a non-blocking copy (on CUDA), token ids
    and masks as int64; the host-side texts are dropped."""
    out = {}
    for key, value in batch.items():
        if key in TEXT_KEYS:
            continue
        host = torch.from_numpy(np.ascontiguousarray(value))
        if key not in IMAGE_KEYS:
            host = host.long()
        if device.type == "cuda":
            host = host.pin_memory()
        out[key] = host.to(device, non_blocking=True)
    return out


def make_clip_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         scheduler=None, label_smoothing: float = 0.0,
                         i2i_weight: float = 1.0, t2t_weight: float = 0.5,
                         input_wire: str = "f32", norm_mean: float = 0.0,
                         norm_std: float = 1.0, generator: Optional[torch.Generator] = None,
                         mesh=None):
    """step(batch {name: tensor on the model's device}) -> the loss (a detached
    float32 scalar tensor), after one update of `model` (a BreastClipModule, put in
    training mode). input_wire "u8": "images" and "image_views" arrive as
    post-transform uint8 and are min-max + mean/std normalized on the device."""
    if input_wire not in ("f32", "u8"):
        raise ValueError(f"input_wire must be 'f32' or 'u8', got {input_wire!r}")
    group = data_group(mesh)
    net = model
    if group is not None:
        from torch.nn.parallel import DistributedDataParallel

        net = DistributedDataParallel(model, process_group=group, broadcast_buffers=False)

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        batch = dict(batch)
        for key in IMAGE_KEYS:
            if key in batch:
                batch[key] = (u8_minmax_meanstd(batch[key], norm_mean, norm_std)
                              if input_wire == "u8" else batch[key].float())
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with data_parallel(group):
            out = net(batch, generator=generator)
            loss = clip_contrastive_loss(
                out["image_embeddings"], out["text_embeddings"], out["logit_scale"],
                label_smoothing=label_smoothing,
                image_view_embeddings=out.get("image_view_embeddings"),
                text_embeddings2=out.get("text_embeddings2"),
                i2i_weight=i2i_weight, t2t_weight=t2t_weight, group=group)
            loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach() if group is None else pmean(loss.detach(), group)

    return step
