"""Shared NN building blocks (counterpart of `mammodissect/models/layers.py`).

- round_filters / round_repeats: EfficientNet width/depth rounding.
- squeeze_excite: the SE gate of an MBConv block. Its convs live on the block as
  `_se_reduce` / `_se_expand`, the reference's state-dict names.
- drop_connect_mask / drop_connect: per-sample stochastic depth on the residual
  branch, the keep mask drawn from an explicit torch.Generator.
- BatchNorm2d / LayerNorm: normalization computed in float32 whatever the
  activation dtype, with float32 parameters (flax's dtype policy in the JAX
  package; cuDNN's bf16 batch norm does the same internally). BatchNorm2d trains
  with flax's rule (batch statistics, biased variance, momentum on the old value).
- Inside `parallel.mesh.data_parallel(group)` a forward is one rank's part of a
  data-parallel step, as JAX's global-view step sees the global batch: training
  BatchNorm takes its moments over the group's global batch (`_SyncBatchNorm`),
  and the drop-connect and dropout masks are drawn on the global batch's shape
  from the step's generator and sliced by rank.
- Linear / Conv2d: compute in `compute_dtype`, by default their weight's dtype;
  the input, weight and bias are cast at use (flax's `dtype=` over `param_dtype=`:
  float32 master weights with bf16 compute in fine-tuning).
- attend: plain attention (scores scaled after q.k^T, softmax in float32), shared
  by the CLIP ViT blocks, the ModifiedResNet attention pool and the HF ViT encoder.
- GeM, LinearProjectionHead, MLPProjectionHead (its dropout, `dropout`, flax's rule
  with the mask from an explicit torch.Generator), LinearClassifier.
- init_weights: random weights from an explicit torch.Generator.
- same_pad_patches: flax's SAME padding before a patch conv (stride = kernel).
- HFDense: one Linear held as `dense`, HF's naming of the transformer towers'
  output layers.
- nchw_from_nhwc / l2_normalized: the NHWC numpy batch of a dissector or target
  interface as an NCHW tensor on the device, and embeddings back as L2-normalized
  numpy (the CLIP towers).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.ops.pooling import gem_pool
from mammodissect_torch.parallel.collectives import all_gather, psum
from mammodissect_torch.parallel.mesh import active_data_group, group_rank_and_size


def round_filters(filters: int, width_coefficient: float | None, depth_divisor: int = 8,
                  min_depth: int | None = None) -> int:
    """EfficientNet channel rounding (reference `efficient_net_custom_utils.py:83-110`)."""
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    min_depth = min_depth or depth_divisor
    new_filters = max(min_depth, int(filters + depth_divisor / 2) // depth_divisor * depth_divisor)
    if new_filters < 0.9 * filters:  # prevent >10% reduction
        new_filters += depth_divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float | None) -> int:
    """EfficientNet depth rounding (reference `efficient_net_custom_utils.py:112-127`)."""
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: LeCun-normal convs and dense layers
    (std 1/sqrt(fan_in)), zero biases, N(0, 1/hidden) embeddings, identity
    normalization statistics."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(m.embedding_dim))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


def _global_rand(shape, generator, device) -> torch.Tensor:
    """Uniform draws of `shape` from `generator`; in a data-parallel step, this rank's
    rows of the draws for the global batch (shape[0] rows on every rank)."""
    rank, size = group_rank_and_size(active_data_group())
    u = torch.rand((shape[0] * size, *shape[1:]), generator=generator, device=device)
    return u[rank * shape[0]:(rank + 1) * shape[0]]


def drop_connect_mask(batch: int, rate: float, device, generator: torch.Generator | None = None):
    """The keep mask [batch, 1, 1, 1] (bool) of one drop-connect: each sample kept with
    probability 1 - rate, drawn from `generator` (which lives on `device`)."""
    return _global_rand((batch, 1, 1, 1), generator, device) < 1.0 - rate


def drop_connect(x: torch.Tensor, rate: float, keep: torch.Tensor | None) -> torch.Tensor:
    """Stochastic depth (reference `efficient_net_custom_utils.py:129-150`): the kept
    samples rescaled by 1 / (1 - rate), the others zeroed. `keep` None (eval, or no
    mask drawn) is the identity."""
    if keep is None or rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype` (None: its weight's dtype, so a
    module moved with `.to()` follows); the input, weight and bias are cast at use."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.weight.dtype
        if dtype == self.weight.dtype:
            return super().forward(x.to(dtype))
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class Linear(nn.Linear):
    """nn.Linear that computes in `compute_dtype` (None: its weight's dtype); the
    input, weight and bias are cast at use."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class Embedding(nn.Embedding):
    """nn.Embedding whose lookups come out in `compute_dtype` (None: its weight's
    dtype), as flax's `nn.Embed(dtype=...)`: the rows are cast after the lookup,
    the same values as a lookup in the cast table."""

    compute_dtype: torch.dtype | None = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype or self.weight.dtype)


class _SyncBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the data group's global batch, in float32.

    Forward: each rank's count, mean and M2 over N, H, W (ranks may hold different
    counts) are all-gathered and combined (Chan et al.), so the moments are the
    global batch's. Backward: dx needs the global sums of dy and dy * x_hat, which
    are all-reduced; the weight and bias gradients stay local (the gradient
    all-reduce sums them). Returns (y in x's dtype, mean, biased variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        n_local = xf.numel() // xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        count = torch.full((1,), float(n_local), device=x.device)
        parts = all_gather(torch.cat([count, mean, var * n_local])[None], group)
        counts, means, m2s = parts[:, :1], parts[:, 1:1 + mean.numel()], parts[:, 1 + mean.numel():]
        n = counts.sum()
        mean = (counts * means).sum(0) / n
        var = (m2s.sum(0) + (counts * (means - mean) ** 2).sum(0)) / n
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean[:, None, None]) * (invstd * weight)[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n, ctx.group = float(n), group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad, _gm, _gv):
        x, weight, mean, invstd = ctx.saved_tensors
        g = grad.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        sums = torch.stack([g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))])
        dbias, dweight = sums[0].clone(), sums[1].clone()
        total = psum(sums, ctx.group) / ctx.n
        dx = (g - total[0][:, None, None] - xhat * total[1][:, None, None]) \
            * (weight * invstd)[:, None, None]
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW computed in float32 and returned in the input dtype, with
    float32 parameters and statistics. Momentum 0.01 is flax's 0.99; eps is passed by
    the caller (1e-3 in EfficientNet).

    Eval normalizes by the running statistics. Training normalizes by the batch mean
    and biased variance over N, H, W and updates the running statistics as flax does:
    ra = m * ra + (1 - m) * stat with m = 1 - momentum, the variance biased
    (`F.batch_norm(training=True)` would update it with the unbiased one, n/(n - 1)
    larger). `update_running` False skips the update: the recompute of a
    rematerialized block must not apply it twice. In a data-parallel step the batch
    statistics are the global batch's (`_SyncBatchNorm`)."""

    update_running: bool = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        group = active_data_group()
        if group is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps, group)
            if self.update_running:
                with torch.no_grad():
                    keep = 1.0 - self.momentum
                    self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
                    self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            return y
        # a bf16 input is normalized in float32 inside the kernel (float32 weight)
        # and saved for the backward in bf16
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if self.update_running:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
                self.running_var.mul_(keep).add_(var, alpha=self.momentum)
        return y.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in float32 (flax LayerNorm with f32 params)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, x_dtype: torch.dtype,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q.k^T / sqrt(dh) + mask) v over [B, heads, T, dh], with flax's
    promotion: a product in the dense dtype divided by a scale of `x_dtype`, the
    mask added in that dtype, the softmax in float32 cast back to `x_dtype`."""
    scores = (q @ k.transpose(-1, -2)).to(torch.promote_types(q.dtype, x_dtype))
    scores = scores / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(x_dtype)
    ctx_dtype = torch.promote_types(probs.dtype, v.dtype)
    return probs.to(ctx_dtype) @ v.to(ctx_dtype)


def squeeze_excite(x: torch.Tensor, se_reduce: nn.Module, se_expand: nn.Module) -> torch.Tensor:
    """SE gate over NCHW (reference `efficientnet_custom.py:84-96`): global average ->
    1x1 reduce -> SiLU -> 1x1 expand -> sigmoid gate."""
    s = x.mean(dim=(2, 3), keepdim=True)
    s = se_expand(F.silu(se_reduce(s)))
    return x * torch.sigmoid(s)


class GeM(nn.Module):
    """Generalized-mean pooling with a learnable exponent p (reference
    `model/modules/image_encoder.py:55-97`, p init 3.0, eps 1e-6), in float32."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.tensor(p_init, dtype=torch.float32))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gem_pool(x.float(), self.p, self.eps)


class LinearProjectionHead(nn.Module):
    """Single linear projection (reference `model/modules/projection.py:20-28`);
    `generator` is accepted for the MLP head's signature (no dropout here)."""

    def __init__(self, in_dim: int, embedding_dim: int):
        super().__init__()
        self.projection = Linear(in_dim, embedding_dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.projection(x)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's Dropout: in training each element kept with probability 1 - rate (the
    mask drawn from `generator`, on x's device) and rescaled by 1 / (1 - rate);
    the identity in eval or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = _global_rand(x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class MLPProjectionHead(nn.Module):
    """linear -> GELU -> linear -> dropout -> residual -> LayerNorm
    (reference `model/modules/projection.py:4-19`); the dropout mask of a training
    forward comes from `generator`."""

    def __init__(self, in_dim: int, embedding_dim: int, dropout: float = 0.1):
        super().__init__()
        self.projection = Linear(in_dim, embedding_dim)
        self.fc = Linear(embedding_dim, embedding_dim)
        self.rate = dropout
        self.layer_norm = LayerNorm(embedding_dim, eps=1e-6)  # flax's default eps

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        projected = self.projection(x)
        h = dropout(self.fc(F.gelu(projected)), self.rate, self.training, generator)
        return self.layer_norm(h + projected)


class LinearClassifier(nn.Module):
    """Single linear head (reference `model/modules/image_classifier.py:4-10`); the
    reference's state-dict names `fc.{weight,bias}`."""

    def __init__(self, in_dim: int, n_class: int):
        super().__init__()
        self.fc = Linear(in_dim, n_class)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


def same_pad_patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NCHW x padded as flax's SAME pads a conv whose stride is its kernel: to a
    multiple of `patch`, the extra row or column at the bottom and right."""
    pad_h, pad_w = (-x.shape[2]) % patch, (-x.shape[3]) % patch
    if pad_h or pad_w:
        x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    return x


class HFDense(nn.Module):
    """One Linear held as `dense` (HF's `attention.output`, `intermediate`, `output`)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = Linear(d_in, d_out)


def nchw_from_nhwc(images, device) -> torch.Tensor:
    """NHWC images (numpy) -> an NCHW float32 tensor on `device`."""
    return torch.as_tensor(np.asarray(images, np.float32)).to(device).permute(0, 3, 1, 2)


def l2_normalized(emb: torch.Tensor) -> np.ndarray:
    """Rows divided by their L2 norm (at least 1e-12), float32 numpy."""
    emb = emb.float()
    return (emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True).clamp(min=1e-12)).cpu().numpy()
