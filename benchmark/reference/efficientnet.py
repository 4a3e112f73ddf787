"""Plain EfficientNet (B family) in PyTorch: the benchmark's reference image tower.

Written from the published description (Tan and Le, arXiv:1905.11946) and the
lukemelas `EfficientNet-PyTorch` layout that Mammo-CLIP loads: a 3x3/s2 stem,
MBConv blocks (1x1 expand, k x k depthwise, squeeze-excite, 1x1 project, skip when
stride 1 and widths match), a 1x1 head, TF's BatchNorm eps 1e-3 and SiLU. Padding
is lukemelas' static TF-SAME: each conv's padding is worked out once for the
configuration's `resolution` (456 for B5), carried down the network as
ceil(size / stride), and applied to whatever size the input has.

Weights come as a state dict in the lukemelas names (`_conv_stem.weight`,
`_blocks.i._expand_conv.weight`, ...). Everything computes in float32 with TF32 off,
NCHW in channels_last memory. `mode` lowers the precision of every convolution's
inputs for the control run: "tf32" rounds both operands to TF32, "fp8" to float8
e4m3 with a scale per tensor (`precision.py`). This module imports nothing of the
program under test."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import lower


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """EfficientNet's channel rounding: to a multiple of 8, never 10% below."""
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_table(cfg: dict) -> List[dict]:
    """The flat block list: for each stage of `base_blocks` ([repeats, kernel, stride,
    expand, in, out]) the width- and depth-scaled blocks, the repeats at stride 1
    with input = output. Each entry: k, stride, expand, cin, cexp, cout, se (the
    squeezed width), residual."""
    width, depth = cfg["width_coefficient"], cfg["depth_coefficient"]
    out = []
    for repeats, k, stride, expand, cin, cout in cfg["base_blocks"]:
        cin, cout = round_filters(cin, width), round_filters(cout, width)
        for r in range(round_repeats(repeats, depth)):
            c_in = cin if r == 0 else cout
            s = stride if r == 0 else 1
            out.append({"k": k, "stride": s, "expand": expand, "cin": c_in,
                        "cexp": c_in * expand, "cout": cout,
                        "se": max(1, int(c_in * cfg["se_ratio"])),
                        "residual": s == 1 and c_in == cout})
    return out


def stem_width(cfg: dict) -> int:
    return round_filters(cfg["stem_filters"], cfg["width_coefficient"])


def head_width(cfg: dict) -> int:
    return round_filters(cfg["head_filters"], cfg["width_coefficient"])


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME padding of one dim at `size`: (before, after), the odd pixel after."""
    out = -(-size // s)
    p = max((out - 1) * s + k - size, 0)
    return p // 2, p - p // 2


def paddings(cfg: dict, hw: Sequence[int]):
    """(stem padding, [per block depthwise padding], [per block output (H, W)]) of an
    input of size `hw`: each padding from the static chain at `resolution`, the
    output sizes from the actual input. A padding is ((top, bottom), (left, right))."""
    traced = cfg["resolution"]
    actual = list(hw)

    def step(k, s):
        nonlocal traced
        pad = _same_pad(traced, k, s)
        for i in range(2):
            actual[i] = (actual[i] + sum(pad) - k) // s + 1
        traced = -(-traced // s)
        return (pad, pad)

    stem = step(3, 2)
    pads, sizes = [], []
    for b in block_table(cfg):
        pads.append(step(b["k"], b["stride"]))
        sizes.append(tuple(actual))
    return stem, pads, sizes


def normalize_u8(u8: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """[B, H, W, C] uint8 -> float32: each image min-max scaled to [0, 1] (a constant
    image to 0), then (x - mean) / std (Mammo-CLIP's `dataset_concepts.py`)."""
    x = u8.float() / 255.0
    flat = x.reshape(x.shape[0], -1)
    lo = flat.min(dim=1).values.reshape(-1, 1, 1, 1)
    hi = flat.max(dim=1).values.reshape(-1, 1, 1, 1)
    span = hi - lo
    x = torch.where(span > 0, (x - lo) / torch.where(span > 0, span, 1.0), 0.0)
    return (x - mean) / std


def _conv(x, w, stride=1, groups=1, pad=None, bias=None, mode=None):
    if pad is not None:
        (t, b), (l, r) = pad
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
    return F.conv2d(lower(x, mode), lower(w.float(), mode), bias, stride, 0, 1, groups)


class _BatchNorm:
    """Inference BatchNorm from running statistics; in training, from the batch's own
    mean and biased variance; while calibrating, from those too, which it then
    stores as the running statistics."""

    def __init__(self, sd: Dict[str, torch.Tensor], eps: float, calibrate: bool,
                 train: bool = False):
        self.sd, self.eps, self.calibrate, self.train = sd, eps, calibrate, train

    def __call__(self, x: torch.Tensor, name: str) -> torch.Tensor:
        sd = self.sd
        if self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        else:
            if self.calibrate:
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                sd[f"{name}.running_mean"].copy_(mean)
                sd[f"{name}.running_var"].copy_(var)
            mean, var = sd[f"{name}.running_mean"].float(), sd[f"{name}.running_var"].float()
        scale = sd[f"{name}.weight"].float() / torch.sqrt(var + self.eps)
        shift = sd[f"{name}.bias"].float() - mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


def drop_masks(cfg: dict, batch: int, generator: torch.Generator, device) -> List[Optional[tuple]]:
    """One training forward's drop-connect (stochastic depth, as EfficientNet-PyTorch
    does it): block i of n, where it is residual, at the rate drop_connect_rate * i / n,
    keeps a sample where a uniform draw from `generator` is under 1 - rate, one draw
    [batch, 1, 1, 1] a block in block order. Each block's (rate, keep) or None."""
    table = block_table(cfg)
    out: List[Optional[tuple]] = []
    for i, b in enumerate(table):
        rate = cfg["drop_connect_rate"] * i / len(table)
        if b["residual"] and rate > 0.0:
            u = torch.rand((batch, 1, 1, 1), generator=generator, device=device)
            out.append((rate, u < 1.0 - rate))
        else:
            out.append(None)
    return out


def tower(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, prefix: str = "",
          mode: Optional[str] = None, calibrate: bool = False, train: bool = False,
          drops: Optional[List[Optional[tuple]]] = None):
    """The tower on normalized images x [B, H, W, C] (C = 1 is copied to the
    configured input channels). Returns (features pooled over H x W [B, head],
    [each block's output pooled over H x W, B x C_i]). `calibrate` sets every
    BatchNorm's running statistics in `sd` to this batch's moments as it passes;
    `train` normalizes by the batch's moments and recomputes each block in the
    backward (`torch.utils.checkpoint`), so that a float32 backward at full size
    fits the card; `drops` is each block's drop-connect (`drop_masks`)."""
    p = prefix
    bn = _BatchNorm({k[len(p):]: v for k, v in sd.items() if k.startswith(p)},
                    cfg["bn_eps"], calibrate, train)
    w = bn.sd
    stem_pad, pads, _ = paddings(cfg, x.shape[1:3])
    x = x.permute(0, 3, 1, 2).float()
    if x.shape[1] == 1 and cfg["image_in_channels"] > 1:
        x = x.expand(-1, cfg["image_in_channels"], -1, -1)
    x = x.contiguous(memory_format=torch.channels_last)
    x = F.silu(bn(_conv(x, w["_conv_stem.weight"], 2, pad=stem_pad, mode=mode), "_bn0"))
    pooled = []
    for i, (b, pad) in enumerate(zip(block_table(cfg), pads)):
        drop = drops[i] if drops else None
        if train:
            x = checkpoint(_block, w, bn, b, pad, i, x, mode, drop, use_reentrant=False)
        else:
            x = _block(w, bn, b, pad, i, x, mode, drop)
        pooled.append(x.mean(dim=(2, 3)))
    x = F.silu(bn(_conv(x, w["_conv_head.weight"], mode=mode), "_bn1"))
    return x.mean(dim=(2, 3)), pooled


def _block(w, bn, b, pad, i, x, mode, drop=None):
    """One MBConv block; `drop` its drop-connect (rate, keep) or None."""
    q = f"_blocks.{i}."
    inp = x
    if b["expand"] != 1:
        x = F.silu(bn(_conv(x, w[q + "_expand_conv.weight"], mode=mode), q + "_bn0"))
    x = _conv(x, w[q + "_depthwise_conv.weight"], b["stride"], groups=b["cexp"], pad=pad,
              mode=mode)
    x = F.silu(bn(x, q + "_bn1"))
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.silu(_conv(s, w[q + "_se_reduce.weight"], bias=w[q + "_se_reduce.bias"].float(),
                     mode=mode))
    s = _conv(s, w[q + "_se_expand.weight"], bias=w[q + "_se_expand.bias"].float(), mode=mode)
    x = x * torch.sigmoid(s)
    x = bn(_conv(x, w[q + "_project_conv.weight"], mode=mode), q + "_bn2")
    if b["residual"]:
        if drop is not None:
            rate, keep = drop
            x = torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
        x = x + inp
    return x


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           mode: Optional[str] = None) -> torch.Tensor:
    return F.linear(lower(x.float(), mode), lower(weight.float(), mode),
                    None if bias is None else bias.float())


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
