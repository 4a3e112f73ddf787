"""EfficientNet (B0-B7) in PyTorch: the Mammo-CLIP image tower family
(counterpart of `mammodissect/models/efficientnet.py`).

- Parameter names are the reference's lukemelas layout (`_conv_stem`, `_bn0`,
  `_blocks.i._expand_conv`, ..., `_conv_head`, `_bn1`), so a Mammo-CLIP state
  dict loads with `load_state_dict`.
- The public input is NHWC, as in the JAX package; inside, the tower runs NCHW
  tensors in channels_last memory (an NHWC buffer), which is what cuDNN prefers
  and what the MBConv kernel reads directly.
- Padding replays the reference's static TF-SAME chain traced at the variant's
  canonical resolution (456 for B5) with `F.pad` before each conv; at 1520x912
  that chain differs from true SAME by one pixel at some strided convs, as in
  the reference (`_paddings`).
- Every stride-1 MBConv block with an expansion runs its front half (1x1 expand
  -> BN -> SiLU -> depthwise -> BN -> SiLU) through `ops.cuda_mbconv.fused_expand_dw`,
  the CUDA kernel on the GPU; strided and expand-1 blocks use `F.conv2d`.
- `capture` pools the named blocks' outputs in float32 as the forward passes them.
- Eval only: training-mode BatchNorm, FusedMBConv (V2), the space-to-depth stem
  and true-SAME padding are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    GeM,
    drop_connect,
    round_filters,
    round_repeats,
    squeeze_excite,
)
from mammodissect_torch.ops.cuda_mbconv import fold_bn, fused_expand_dw
from mammodissect_torch.ops.pooling import pool_activation


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    num_repeat: int
    kernel_size: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: float
    id_skip: bool = True


# B0 block args, the decoded reference BlockDecoder strings
# ('r1_k3_s11_e1_i32_o16_se0.25', ..., `efficient_net_custom_utils.py:500-520`).
BASE_BLOCK_ARGS: Tuple[BlockArgs, ...] = (
    BlockArgs(1, 3, 1, 1, 32, 16, 0.25),
    BlockArgs(2, 3, 2, 6, 16, 24, 0.25),
    BlockArgs(2, 5, 2, 6, 24, 40, 0.25),
    BlockArgs(3, 3, 2, 6, 40, 80, 0.25),
    BlockArgs(3, 5, 1, 6, 80, 112, 0.25),
    BlockArgs(4, 5, 2, 6, 112, 192, 0.25),
    BlockArgs(1, 3, 1, 6, 192, 320, 0.25),
)

# (width_coefficient, depth_coefficient, resolution, dropout_rate) per variant
# (reference `efficient_net_custom_utils.py:457-478`).
EFFICIENTNET_PARAMS: Dict[str, Tuple[float, float, int, float]] = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    # 7-block test variant (one block per stage, minimal widths)
    "efficientnet-test": (0.35, 0.1, 64, 0.2),
}

Pad2d = Tuple[Tuple[int, int], Tuple[int, int]]  # ((top, bottom), (left, right))
BN_EPS = 1e-3  # TF's BatchNorm eps, as the reference's EfficientNet


def _pad1d(i: int, k: int, s: int) -> int:
    """TF-SAME total padding of one spatial dim: max((ceil(i/s)-1)*s + k - i, 0)."""
    o = -(-i // s)
    return max((o - 1) * s + k - i, 0)


def expand_block_args(width_coefficient: float, depth_coefficient: float) -> Tuple[BlockArgs, ...]:
    """Flat per-variant block list: width-rounded filters, depth-rounded repeats; a
    stage's repeated blocks get stride 1 and input = output (`efficientnet_custom.py:181-198`).
    For B5 these are the 39 dissection targets."""
    out = []
    for ba in BASE_BLOCK_ARGS:
        in_f = round_filters(ba.input_filters, width_coefficient)
        out_f = round_filters(ba.output_filters, width_coefficient)
        repeats = round_repeats(ba.num_repeat, depth_coefficient)
        out.append(dataclasses.replace(ba, input_filters=in_f, output_filters=out_f, num_repeat=1))
        for _ in range(repeats - 1):
            out.append(dataclasses.replace(ba, input_filters=out_f, output_filters=out_f,
                                           stride=1, num_repeat=1))
    return tuple(out)


def _pad(x: torch.Tensor, pad: Pad2d) -> torch.Tensor:
    (t, b), (l, r) = pad
    return F.pad(x, (l, r, t, b)) if (t or b or l or r) else x


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck: expand (1x1) -> depthwise (kxk) -> SE -> project
    (1x1), skip + drop-connect when stride 1 and channels match
    (`efficientnet_custom.py:36-140`)."""

    def __init__(self, args: BlockArgs):
        super().__init__()
        self.args = args
        c_in = args.input_filters
        c_exp = c_in * args.expand_ratio
        k = args.kernel_size

        def bn(c):
            return BatchNorm2d(c, eps=BN_EPS, momentum=0.01)

        if args.expand_ratio != 1:
            self._expand_conv = Conv2d(c_in, c_exp, 1, bias=False)
            self._bn0 = bn(c_exp)
        self._depthwise_conv = Conv2d(c_exp, c_exp, k, stride=args.stride, groups=c_exp,
                                      bias=False)
        self._bn1 = bn(c_exp)
        self.has_se = bool(args.se_ratio) and 0 < args.se_ratio <= 1
        if self.has_se:
            n_sq = max(1, int(c_in * args.se_ratio))
            self._se_reduce = Conv2d(c_exp, n_sq, 1)
            self._se_expand = Conv2d(n_sq, c_exp, 1)
        self._project_conv = Conv2d(c_exp, args.output_filters, 1, bias=False)
        self._bn2 = bn(args.output_filters)
        # the fused front half covers what the Pallas kernel covered: stride 1 with
        # an expansion (strided and expand-1 blocks stay on F.conv2d)
        self.fused_front = args.stride == 1 and args.expand_ratio != 1

    def _front_sources(self):
        return (self._expand_conv.weight, self._depthwise_conv.weight,
                *(getattr(bn, name) for bn in (self._bn0, self._bn1)
                  for name in ("weight", "bias", "running_mean", "running_var")))

    def _front_weights(self):
        """(w_exp [Cin, Cexp], s1, b1, w_dw [k, k, Cexp], s2, b2) in the kernel's
        layout: contiguous weights, BatchNorms folded to float32 scale/bias."""
        c_exp, c_in = self._expand_conv.weight.shape[:2]
        k = self.args.kernel_size
        s1, b1 = fold_bn(self._bn0.weight, self._bn0.bias, self._bn0.running_mean,
                         self._bn0.running_var, self._bn0.eps)
        s2, b2 = fold_bn(self._bn1.weight, self._bn1.bias, self._bn1.running_mean,
                         self._bn1.running_var, self._bn1.eps)
        w_exp = self._expand_conv.weight.reshape(c_exp, c_in).t().contiguous()
        w_dw = self._depthwise_conv.weight.reshape(c_exp, k, k).permute(1, 2, 0).contiguous()
        return w_exp, s1, b1, w_dw, s2, b2

    def _front_weights_cached(self):
        """`_front_weights`, prepared once and reused while no source tensor changes.

        The cache holds a detached alias of each source tensor with its version
        counter at preparation (bumped by every in-place write, `load_state_dict`
        included), and both BN eps. The aliases keep the old storage alive, so a
        source whose storage was replaced (`param.data = ...`, `.to()`,
        `load_state_dict(assign=True)`) can never match an old address, and new
        weights are never served stale; the old storage is released at the next
        preparation. Writes through `.data` bypass the version counter and are not
        seen, as for autograd. Only inference caches (eval mode, grad off, as on the
        main path): elsewhere the weights keep their autograd history."""
        if self.training or torch.is_grad_enabled():
            return self._front_weights()
        sources = self._front_sources()
        cached = self.__dict__.get("_front_cache")
        fresh = cached is not None and cached[0] == (self._bn0.eps, self._bn1.eps) and all(
            t.data_ptr() == held.data_ptr() and t._version == version and t.shape == held.shape
            for t, (held, version) in zip(sources, cached[1]))
        if not fresh:
            with torch.inference_mode(False), torch.no_grad():
                cached = ((self._bn0.eps, self._bn1.eps),
                          tuple((t.detach(), t._version) for t in sources), self._front_weights())
            self.__dict__["_front_cache"] = cached
        return cached[2]

    def _front_fused(self, x: torch.Tensor) -> torch.Tensor:
        """expand -> BN0 -> SiLU -> depthwise -> BN1 -> SiLU through `fused_expand_dw`
        on the NHWC view of x (free for channels_last x); returns NCHW channels_last."""
        w_exp, s1, b1, w_dw, s2, b2 = self._front_weights_cached()
        x_nhwc = x.to(w_exp.dtype).permute(0, 2, 3, 1)
        return fused_expand_dw(x_nhwc, w_exp, s1, b1, w_dw, s2, b2).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, padding: Pad2d, drop_rate: float = 0.0) -> torch.Tensor:
        ba = self.args
        inp = x
        if self.fused_front:
            p = (ba.kernel_size - 1) // 2
            if padding != ((p, p), (p, p)):
                raise ValueError(f"stride-1 depthwise padding {padding} is not SAME")
            x = self._front_fused(x)
        else:
            if ba.expand_ratio != 1:
                x = F.silu(self._bn0(self._expand_conv(x)))
            x = F.silu(self._bn1(self._depthwise_conv(_pad(x, padding))))
        if self.has_se:
            x = squeeze_excite(x, self._se_reduce, self._se_expand)
        x = self._bn2(self._project_conv(x))
        if ba.id_skip and ba.stride == 1 and ba.input_filters == ba.output_filters:
            x = drop_connect(x, drop_rate, self.training) + inp
        return x


class EfficientNet(nn.Module):
    """EfficientNet backbone with dissection capture.

    forward(x [B, H, W, C] NHWC, capture=(i, ...), pool_mode) ->
        (features [B, head_dim, H', W'] NCHW, {"blocks.i": pooled [B, C_i] float32})

    head_dim is round_filters(1280): 2048 for B5. `dtype` is the compute dtype of
    the convolutions (bfloat16 on the main path); BatchNorm stays float32."""

    def __init__(self, variant: str = "efficientnet-b5", in_channels: int = 1,
                 drop_connect_rate: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant = variant
        self.in_channels = in_channels
        self.drop_connect_rate = drop_connect_rate
        width, depth, _, _ = EFFICIENTNET_PARAMS[variant]
        self.block_args = expand_block_args(width, depth)
        stem = round_filters(32, width)
        self.out_dim = round_filters(1280, width)
        self._conv_stem = Conv2d(in_channels, stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm2d(stem, eps=BN_EPS, momentum=0.01)
        self._blocks = nn.ModuleList(MBConvBlock(ba) for ba in self.block_args)
        last = self.block_args[-1].output_filters
        self._conv_head = Conv2d(last, self.out_dim, 1, bias=False)
        self._bn1 = BatchNorm2d(self.out_dim, eps=BN_EPS, momentum=0.01)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    def _paddings(self, input_hw) -> Tuple[Pad2d, Tuple[Pad2d, ...]]:
        """(stem padding, per-block depthwise padding) of the reference's static chain.

        Replays the construction-time size chain (`efficientnet_custom.py:166-198`:
        image_size -> ceil(size/stride) after the stem and each strided block). Only
        the stem and strided convs can differ from true SAME (stride-1 SAME padding
        does not depend on the size). A conv whose traced padding would collapse a
        dim of the actual input to zero takes true SAME for that dim instead, a
        regime where the reference itself fails, so tiny test geometries still run."""
        res = EFFICIENTNET_PARAMS[self.variant][2]  # the canonical resolution it was traced at
        size = (res, res)
        actual = tuple(input_hw)

        def pick(traced, act, k, s):
            pads, new_act = [], []
            for idx in range(2):
                p = _pad1d(traced[idx], k, s)
                out = (act[idx] + p - k) // s + 1
                if out < 1:
                    p = _pad1d(act[idx], k, s)
                    out = (act[idx] + p - k) // s + 1
                new_act.append(out)
                pads.append((p // 2, p - p // 2))
            return tuple(pads), tuple(new_act)

        stem_pad, actual = pick(size, actual, 3, 2)
        size = (-(-size[0] // 2), -(-size[1] // 2))
        pads = []
        for ba in self.block_args:
            p, actual = pick(size, actual, ba.kernel_size, ba.stride)
            pads.append(p)
            if ba.stride > 1:
                size = (-(-size[0] // ba.stride), -(-size[1] // ba.stride))
        return stem_pad, tuple(pads)

    def forward(self, x: torch.Tensor, capture: Sequence[int] = (), pool_mode: str = "avg"):
        stem_pad, block_pads = self._paddings((int(x.shape[1]), int(x.shape[2])))
        x = x.permute(0, 3, 1, 2)  # NHWC buffer viewed as NCHW channels_last
        # grayscale -> in_channels copies (the reference feeds PIL-RGB copies of the
        # grayscale probes; mean/std normalization commutes with the copy)
        if x.shape[1] == 1 and self.in_channels > 1:
            x = x.expand(-1, self.in_channels, -1, -1)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.silu(self._bn0(self._conv_stem(_pad(x, stem_pad))))
        captured: Dict[str, torch.Tensor] = {}
        n_blocks = len(self._blocks)
        for i, block in enumerate(self._blocks):
            x = block(x, block_pads[i], self.drop_connect_rate * i / n_blocks)
            if i in capture:
                captured[f"blocks.{i}"] = pool_activation(x.float(), pool_mode)
        x = F.silu(self._bn1(self._conv_head(x)))
        return x, captured


class EfficientNetMammo(EfficientNet):
    """Backbone + spatial pooling: BreastClip's image tower.

    pooling="avg" is the canonical 'tf_efficientnet_b5_ns-detect' tower (the
    reference's vendored EfficientNet with AdaptiveAvgPool2d + flatten); "gem" the
    timm-backed EfficientNet_Mammo with GeM(p=3). Pooling runs in float32."""

    def __init__(self, variant: str = "efficientnet-b5", in_channels: int = 3,
                 pooling: str = "avg", dtype: torch.dtype = torch.float32):
        super().__init__(variant=variant, in_channels=in_channels, dtype=dtype)
        if pooling not in ("avg", "gem"):
            raise ValueError(f"pooling must be 'avg' or 'gem', got {pooling!r}")
        self.pooling = pooling
        if pooling == "gem":
            self.pool = GeM()

    def forward(self, x: torch.Tensor, capture: Sequence[int] = (), pool_mode: str = "avg"):
        features, captured = super().forward(x, capture=capture, pool_mode=pool_mode)
        if self.pooling == "gem":
            return self.pool(features), captured
        return features.float().mean(dim=(2, 3)), captured
