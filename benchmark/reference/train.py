"""Plain training steps of the Mammo-CLIP B5 classifier, the benchmark's reference for
fine-tuning: the tower in training mode (BatchNorm over the batch's moments, biased
variance, drop-connect at the configuration's rate with its masks drawn from a
generator seeded as the trainer's), global average pooling, the linear head, the weighted
binary cross-entropy of torch's BCEWithLogitsLoss(pos_weight) averaged over the
batch, the gradients by autograd, and AdamW (decoupled weight decay, bias-corrected
moments) at the learning rate of each update. float32 with TF32 off. Imports
nothing of the program."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.efficientnet import drop_masks, linear, normalize_u8, tower


def loss_of(params: Dict[str, torch.Tensor], cfg: dict, u8: torch.Tensor, labels: torch.Tensor,
            pos_weight: float, mode: Optional[str] = None, drops=None) -> torch.Tensor:
    x = normalize_u8(u8, cfg["norm_mean"], cfg["norm_std"])
    feats, _ = tower(params, cfg, x, "image_encoder.", mode, train=True, drops=drops)
    logits = linear(feats, params["classifier.fc.weight"], params["classifier.fc.bias"], mode)
    logits, y = logits.reshape(-1), labels.reshape(-1).float()
    return -(pos_weight * y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits)).mean()


def train(params: Dict[str, torch.Tensor], leaves: Sequence[str], cfg: dict,
          batches: List[Tuple[torch.Tensor, torch.Tensor]], lr_at: Callable[[int], float],
          weight_decay: float, pos_weight: float, drop_seed: int, betas=(0.9, 0.999),
          eps: float = 1e-8, mode: Optional[str] = None):
    """Steps over `batches` from `params` (float32 copies; `leaves` train, the rest are
    buffers), the drop-connect masks drawn from a generator on the batches' device
    seeded with `drop_seed`. Returns (losses, {leaf: gradient of the first step},
    {leaf: value after the last step})."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        p = {k: v.detach().float().clone() for k, v in params.items()}
        m = {k: torch.zeros_like(p[k]) for k in leaves}
        v = {k: torch.zeros_like(p[k]) for k in leaves}
        losses, first = [], None
        b1, b2 = betas
        gen = torch.Generator(device=batches[0][0].device).manual_seed(drop_seed)
        for t, (u8, y) in enumerate(batches):
            for k in leaves:
                p[k].requires_grad_(True)
            drops = drop_masks(cfg, u8.shape[0], gen, u8.device)
            loss = loss_of(p, cfg, u8, y, pos_weight, mode, drops)
            grads = torch.autograd.grad(loss, [p[k] for k in leaves])
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(leaves, grads)}
            lr = lr_at(t)
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    w = p[k].detach()
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = m[k] / (1 - b1 ** (t + 1))
                    v_hat = v[k] / (1 - b2 ** (t + 1))
                    p[k] = w * (1 - lr * weight_decay) - lr * m_hat / (v_hat.sqrt() + eps)
        return losses, first, {k: p[k].detach() for k in leaves}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """The learning rate of update t (from 0): linear from 0 to base_lr over
    warmup_steps, then a cosine to 0 over the rest (Mammo-CLIP's
    LinearWarmupCosineAnnealingLR, stepped once an update)."""
    decay = max(total_steps - warmup_steps, 1)

    def lr_at(t: int) -> float:
        if t < warmup_steps:
            return base_lr * t / warmup_steps
        return base_lr * 0.5 * (1 + math.cos(math.pi * min(t - warmup_steps, decay) / decay))

    return lr_at
