"""EfficientNet (B0-B7, V2-S) in PyTorch: the Mammo-CLIP image tower family
(counterpart of `mammodissect/models/efficientnet.py`).

- Parameter names are the reference's lukemelas layout (`_conv_stem`, `_bn0`,
  `_blocks.i._expand_conv`, ..., `_conv_head`, `_bn1`), so a Mammo-CLIP state
  dict loads with `load_state_dict`.
- The public input is NHWC, as in the JAX package; inside, the tower runs NCHW
  tensors in channels_last memory (an NHWC buffer), which is what cuDNN prefers
  and what the MBConv kernel reads directly.
- Padding (`F.pad` before each conv): `pad_mode="static"` (default) replays the
  reference's static TF-SAME chain traced at the variant's canonical resolution
  (456 for B5); at 1520x912 that chain differs from true SAME by one pixel at
  some strided convs, as in the reference (`_paddings`). `pad_mode="same"` is true
  TF-SAME computed from the actual input size (toy geometries far from the chain).
  EfficientNetV2-S (`efficientnetv2-s`: 40 blocks, the first 10 FusedMBConv, a
  24-channel stem and a 1280-channel head) always takes true SAME, as in JAX.
- In eval, every stride-1 MBConv block with an expansion runs its front half (1x1
  expand -> BN -> SiLU -> depthwise -> BN -> SiLU) through
  `ops.cuda_mbconv.fused_expand_dw`, the CUDA kernel on the GPU, which takes each
  BatchNorm as flax's (mean, mul, bias) and returns, beside the front half's output,
  its sum over H x W before the last rounding: the SE's squeeze, so the SE reads no
  copy of the expanded tensor. Strided and expand-1 blocks use `F.conv2d`; their
  BatchNorms in bf16 inference compute what kernel 2's do (`_conv_bn_act`). At
  every conv -> BatchNorm site outside kernel 2 (the stem, those blocks' convs, every
  project conv, the head) the BatchNorm, its rounding and the SiLU that follows run in
  bf16 inference on the GPU as one pass over the conv's float32 sums, which also
  writes the SiLU's float32 product where the SE sums it:
  `ops.cuda_bn_epilogue.bn_epilogue`, kernel 3. A
  FusedMBConv block (V2) has no depthwise conv:
  its k x k expand (or single conv), BN, SiLU, 1x1 project and BN run on
  `F.conv2d`, and its parameters take the lukemelas pattern (`_expand_conv`,
  `_bn0`, `_project_conv`, `_bn2`).
- The stem is the plain 3x3/s2 conv, also for a config that sets
  `image_encoder.s2d_stem`: JAX's space-to-depth stem (`StemConv(s2d=True)`)
  computes the same function, and on the H100 it is slower than the plain conv.
- Training (fine-tuning): every block takes the unfused path on `F.conv2d` with
  autograd, chosen on purpose: the fused front normalizes by the BatchNorms' running
  statistics, and training normalizes by batch statistics (BatchNorm2d's flax
  rule). Drop-connect masks come from the `generator` passed to `forward`, drawn
  before each block; `remat` recomputes each block in the backward
  (`torch.utils.checkpoint`) from the same mask, and the recompute leaves the
  running statistics alone.
- `dtype` is the compute dtype of the convolutions; `param_dtype` (default: the
  same) the dtype they are stored in. Fine-tuning keeps float32 master weights
  and computes in bf16; eval then folds the fused front's weights to bf16 too, so
  kernel 2 runs its bf16 instantiation.
- `capture` pools the named blocks' outputs in float32 as the forward passes them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mammodissect_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    GeM,
    SqueezeExcite,
    drop_connect,
    drop_connect_mask,
    round_filters,
    round_repeats,
    silu,
)
from mammodissect_torch.ops.activations import xla_bf16
from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue
from mammodissect_torch.ops.cuda_mbconv import bn_terms, fused_expand_dw
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
    fused: bool = False  # EfficientNetV2 FusedMBConv


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

# EfficientNetV2-S stages: (num_repeat, kernel, stride, expand, in, out, se_ratio, fused)
V2_S_BLOCK_ARGS: Tuple[Tuple, ...] = (
    (2, 3, 1, 1, 24, 24, 0.0, True),
    (4, 3, 2, 4, 24, 48, 0.0, True),
    (4, 3, 2, 4, 48, 64, 0.0, True),
    (6, 3, 2, 4, 64, 128, 0.25, False),
    (9, 3, 1, 6, 128, 160, 0.25, False),
    (15, 3, 2, 6, 160, 256, 0.25, False),
)

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


def v2_block_args() -> Tuple[BlockArgs, ...]:
    """The flat EfficientNetV2-S block list (no width/depth scaling): 40 blocks, the
    first 10 FusedMBConv; a stage's repeated blocks get stride 1 and input = output."""
    out = []
    for (r, k, s, e, i, o, se, fused) in V2_S_BLOCK_ARGS:
        out.append(BlockArgs(1, k, s, e, i, o, se, fused=fused))
        out.extend(BlockArgs(1, k, 1, e, o, o, se, fused=fused) for _ in range(r - 1))
    return tuple(out)


def _pad(x: torch.Tensor, pad: Pad2d) -> torch.Tensor:
    (t, b), (l, r) = pad
    return F.pad(x, (l, r, t, b)) if (t or b or l or r) else x


def _xla_rounding(conv: Conv2d, bn: BatchNorm2d) -> bool:
    """Whether conv -> BN runs as XLA compiles the JAX package's bf16 program: bf16
    compute in inference. Training keeps cuDNN's bf16 convolutions, rounded: their
    float32 outputs would double the activations saved for the backward."""
    return (conv.compute_dtype or conv.weight.dtype) == torch.bfloat16 \
        and not bn.training and not torch.is_grad_enabled()


def _conv_bn_act(conv: Conv2d, bn: BatchNorm2d, x: torch.Tensor, act: Optional[str] = None,
                 squeeze: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """conv -> BatchNorm -> `act` (None, "silu", or "silu_f32": the SiLU's last product
    unrounded in float32 at bf16 in inference, else the SiLU), and with `squeeze` the
    SE's squeeze (the SiLU's product summed over H x W unrounded) where the
    BatchNorm's output takes the bf16 program's roundings (`xla_bf16`). Returns (out,
    the squeeze or None).

    At bf16 in inference (`_xla_rounding`), as XLA's CPU backend compiles the JAX
    package's program: the BatchNorm promotes its input to float32, which absorbs
    the rounding of the convolution's float32 sums (XLA's excess precision), so the
    sums enter it unrounded; it computes (x - mean) * mul + bias with one FMA
    (`batch_norm_fma`, kernel 2's BatchNorm); its result is rounded to bf16, and the
    SiLU is XLA's rounded chain. `bn_epilogue` computes that in one pass (kernel 3)
    over sums on the GPU, and as the ATen chain on the CPU."""
    if _xla_rounding(conv, bn):
        terms = _cached(bn, "_terms_cache", bn.eps,
                        (bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        lambda: bn_terms(bn.weight, bn.bias, bn.running_mean,
                                         bn.running_var, bn.eps))
        return bn_epilogue(conv(x, sum_f32=True), *terms, act=act, squeeze=squeeze)
    y = bn(conv(x))
    s = silu(y, rounded=False).sum(dim=(2, 3)) if squeeze and xla_bf16(y) else None
    return (y if act is None else silu(y)), s


def _conv_bn(conv: Conv2d, bn: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """conv -> BatchNorm (`_conv_bn_act` without an activation)."""
    return _conv_bn_act(conv, bn, x)[0]


def _cached(owner: nn.Module, slot: str, key, sources, make):
    """`make()`, prepared once and kept in `owner.__dict__[slot]`, reused while `key`
    and every source tensor stay the same. Callers cache only in inference (eval
    mode, grad off, as on the main path): elsewhere the results keep their autograd
    history.

    The cache holds a detached alias of each source tensor with its version
    counter at preparation (bumped by every in-place write, `load_state_dict`
    included). The aliases keep the old storage alive, so a source whose storage was
    replaced (`param.data = ...`, `.to()`, `load_state_dict(assign=True)`) can never
    match an old address, and new weights are never served stale; the old storage is
    released at the next preparation. Writes through `.data` bypass the version
    counter and are not seen, as for autograd."""
    cached = owner.__dict__.get(slot)
    fresh = cached is not None and cached[0] == key and all(
        t.data_ptr() == held.data_ptr() and t._version == version and t.shape == held.shape
        for t, (held, version) in zip(sources, cached[1]))
    if not fresh:
        with torch.inference_mode(False), torch.no_grad():
            cached = (key, tuple((t.detach(), t._version) for t in sources), make())
        owner.__dict__[slot] = cached
    return cached[2]


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck: expand (1x1) -> depthwise (kxk) -> SE -> project
    (1x1), skip + drop-connect when stride 1 and channels match
    (`efficientnet_custom.py:36-140`). `bn_momentum` is flax's (0.99)."""

    def __init__(self, args: BlockArgs, bn_momentum: float = 0.99):
        super().__init__()
        self.args = args
        c_in = args.input_filters
        c_exp = c_in * args.expand_ratio
        k = args.kernel_size

        def bn(c):
            return BatchNorm2d(c, eps=BN_EPS, momentum=1.0 - bn_momentum)

        if args.expand_ratio != 1:
            self._expand_conv = Conv2d(c_in, c_exp, 1, bias=False)
            self._bn0 = bn(c_exp)
        self._depthwise_conv = Conv2d(c_exp, c_exp, k, stride=args.stride, groups=c_exp,
                                      bias=False)
        self._bn1 = bn(c_exp)
        self.has_se = bool(args.se_ratio) and 0 < args.se_ratio <= 1
        if self.has_se:
            se = SqueezeExcite(c_exp, max(1, int(c_in * args.se_ratio)))
            # its convs are registered here, under the reference's keys
            # (`_blocks.i._se_reduce`), and the gate is held outside the module tree
            self._se_reduce, self._se_expand = se._se_reduce, se._se_expand
            object.__setattr__(self, "_se", se)
        self._project_conv = Conv2d(c_exp, args.output_filters, 1, bias=False)
        self._bn2 = bn(args.output_filters)
        # the fused front half covers what the Pallas kernel covered: stride 1 with
        # an expansion (strided and expand-1 blocks stay on F.conv2d)
        self.fused_front = args.stride == 1 and args.expand_ratio != 1
        self.residual = (args.id_skip and args.stride == 1
                         and args.input_filters == args.output_filters)

    def _front_sources(self):
        return (self._expand_conv.weight, self._depthwise_conv.weight,
                *(getattr(bn, name) for bn in (self._bn0, self._bn1)
                  for name in ("weight", "bias", "running_mean", "running_var")))

    def _front_dtype(self) -> torch.dtype:
        """The front half's compute dtype: the expand conv's."""
        return self._expand_conv.compute_dtype or self._expand_conv.weight.dtype

    def _front_weights(self):
        """(w_exp [Cin, Cexp], BN0's mean, mul, bias, w_dw [k, k, Cexp], BN1's mean,
        mul, bias) in the kernel's layout: contiguous weights in the compute dtype,
        each BatchNorm as flax's float32 terms (`bn_terms`)."""
        c_exp, c_in = self._expand_conv.weight.shape[:2]
        k = self.args.kernel_size
        dtype = self._front_dtype()
        bn0, bn1 = (bn_terms(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
                    for bn in (self._bn0, self._bn1))
        w_exp = self._expand_conv.weight.reshape(c_exp, c_in).t().to(dtype).contiguous()
        w_dw = (self._depthwise_conv.weight.reshape(c_exp, k, k).permute(1, 2, 0)
                .to(dtype).contiguous())
        return w_exp, *bn0, w_dw, *bn1

    def _front_weights_cached(self):
        """`_front_weights`, prepared once and reused while no source tensor, BN eps
        or the compute dtype changes (`_cached`). Only inference caches."""
        if self.training or torch.is_grad_enabled():
            return self._front_weights()
        return _cached(self, "_front_cache", (self._bn0.eps, self._bn1.eps, self._front_dtype()),
                       self._front_sources(), self._front_weights)

    def _front_fused(self, x: torch.Tensor):
        """expand -> BN0 -> SiLU -> depthwise -> BN1 -> SiLU through `fused_expand_dw`
        on the NHWC view of x (free for channels_last x); returns (the output, NCHW
        channels_last; its squeeze [B, Cexp] float32, the SE's sum)."""
        weights = self._front_weights_cached()
        x_nhwc = x.to(weights[0].dtype).permute(0, 2, 3, 1)
        out, squeeze = fused_expand_dw(x_nhwc, *weights)
        return out.permute(0, 3, 1, 2), squeeze

    def forward(self, x: torch.Tensor, padding: Pad2d, drop_rate: float = 0.0,
                keep: Optional[torch.Tensor] = None, capture: bool = False):
        """`keep`: the drop-connect keep mask [B, 1, 1, 1] of a training forward,
        drawn by the caller (None keeps every sample). In training the front half is
        unfused: the fused one normalizes by the BatchNorms' running statistics, and
        training by batch statistics. The fused front hands its squeeze to the SE.
        With `capture`, returns (output, the float32 tensor a capture pools:
        `_residual`)."""
        ba = self.args
        inp = x
        squeeze = None
        if self.fused_front and not self.training:
            p = (ba.kernel_size - 1) // 2
            if padding != ((p, p), (p, p)):
                raise ValueError(f"stride-1 depthwise padding {padding} is not SAME")
            x, squeeze = self._front_fused(x)
        else:
            if ba.expand_ratio != 1:
                x = _conv_bn_act(self._expand_conv, self._bn0, x, "silu")[0]
            x = _pad(x, padding)  # an unpadded expansion is freed before the convolution
            x, squeeze = _conv_bn_act(self._depthwise_conv, self._bn1, x, "silu",
                                      squeeze=self.has_se)
        if self.has_se:
            x = self._se(x, squeeze)
        x = _conv_bn(self._project_conv, self._bn2, x)
        return _residual(self, x, inp, drop_rate, keep, capture)


class FusedMBConvBlock(nn.Module):
    """Fused-MBConv (EfficientNetV2, `mammodissect/models/efficientnet.py:151-188`):
    with an expansion, a k x k strided expand conv -> BN -> SiLU -> 1x1 project ->
    BN; without, one k x k conv -> BN -> SiLU. Skip + drop-connect when stride 1 and
    channels match; no SE. No depthwise conv, so nothing here is kernel 2's."""

    fused_front = False

    def __init__(self, args: BlockArgs, bn_momentum: float = 0.99):
        super().__init__()
        self.args = args
        c_in, c_out, k = args.input_filters, args.output_filters, args.kernel_size
        c_exp = c_in * args.expand_ratio

        def bn(c):
            return BatchNorm2d(c, eps=BN_EPS, momentum=1.0 - bn_momentum)

        if args.expand_ratio != 1:
            self._expand_conv = Conv2d(c_in, c_exp, k, stride=args.stride, bias=False)
            self._bn0 = bn(c_exp)
            self._project_conv = Conv2d(c_exp, c_out, 1, bias=False)
        else:
            self._project_conv = Conv2d(c_in, c_out, k, stride=args.stride, bias=False)
        self._bn2 = bn(c_out)
        self.residual = args.id_skip and args.stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor, padding: Pad2d, drop_rate: float = 0.0,
                keep: Optional[torch.Tensor] = None, capture: bool = False):
        """`padding` is the k x k conv's; `keep` and `capture` as in
        `MBConvBlock.forward`."""
        inp = x
        if self.args.expand_ratio != 1:
            x = _conv_bn_act(self._expand_conv, self._bn0, _pad(x, padding), "silu")[0]
            x = _conv_bn(self._project_conv, self._bn2, x)
        else:
            x = _conv_bn_act(self._project_conv, self._bn2, _pad(x, padding), "silu")[0]
        return _residual(self, x, inp, drop_rate, keep, capture)


def _residual(block, x, inp, drop_rate, keep, capture):
    """A block's skip connection (when it has one) and, with `capture`, the float32
    tensor its capture pools: at bf16 in inference the residual sum unrounded, as
    XLA computes it for the JAX package's capture (its float32 cast absorbs the
    sum's rounding), else the output."""
    if not block.residual:
        return (x, x.float()) if capture else x
    branch = drop_connect(x, drop_rate, keep)
    out = branch + inp
    if not capture:
        return out
    if xla_bf16(out) and not block.training:
        return out, branch.float() + inp.float()
    return out, out.float()


@contextlib.contextmanager
def _running_stats_frozen(module: nn.Module):
    """No BatchNorm2d of `module` updates its running statistics inside: the
    recompute of a rematerialized block."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_running = False
    try:
        yield
    finally:
        for m in norms:
            m.update_running = True


class EfficientNet(nn.Module):
    """EfficientNet backbone with dissection capture.

    forward(x [B, H, W, C] NHWC, capture=(i, ...), pool_mode) ->
        (features [B, head_dim, H', W'] NCHW, {"blocks.i": pooled [B, C_i] float32})

    head_dim is round_filters(1280): 2048 for B5, 1280 for V2-S. `dtype` is the
    compute dtype of the convolutions (bfloat16 on the main path), `param_dtype` the
    dtype they are stored in (default: `dtype`); BatchNorm stays float32.
    `bn_momentum` is flax's (0.99), `pad_mode` "static" or "same" (`_paddings`; V2
    takes "same" whatever is asked), `remat` recomputes each block in the backward
    of a training forward."""

    def __init__(self, variant: str = "efficientnet-b5", in_channels: int = 1,
                 drop_connect_rate: float = 0.2, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, bn_momentum: float = 0.99,
                 pad_mode: str = "static", remat: bool = False):
        super().__init__()
        if pad_mode not in ("static", "same"):
            raise ValueError(f"pad_mode must be 'static' or 'same', got {pad_mode!r}")
        self.variant = variant
        self.in_channels = in_channels
        self.drop_connect_rate = drop_connect_rate
        self.is_v2 = variant.startswith("efficientnetv2")
        self.pad_mode = "same" if self.is_v2 else pad_mode  # V2 is always true SAME
        self.remat = remat
        if self.is_v2:
            self.block_args = v2_block_args()
            stem, self.out_dim = 24, 1280
        else:
            width, depth, _, _ = EFFICIENTNET_PARAMS[variant]
            self.block_args = expand_block_args(width, depth)
            stem, self.out_dim = round_filters(32, width), round_filters(1280, width)
        bn_torch_momentum = 1.0 - bn_momentum
        self._conv_stem = Conv2d(in_channels, stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm2d(stem, eps=BN_EPS, momentum=bn_torch_momentum)
        self._blocks = nn.ModuleList((FusedMBConvBlock if ba.fused else MBConvBlock)(ba, bn_momentum)
                                     for ba in self.block_args)
        last = self.block_args[-1].output_filters
        self._conv_head = Conv2d(last, self.out_dim, 1, bias=False)
        self._bn1 = BatchNorm2d(self.out_dim, eps=BN_EPS, momentum=bn_torch_momentum)
        param_dtype = dtype if param_dtype is None else param_dtype
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.to(param_dtype)
                if param_dtype != dtype:
                    m.compute_dtype = dtype

    def _paddings(self, input_hw) -> Tuple[Pad2d, Tuple[Pad2d, ...]]:
        """(stem padding, per-block depthwise padding).

        "same": true TF-SAME of each conv at the actual input size (total
        max((ceil(i/s) - 1) * s + k - i, 0), the odd pixel at the bottom/right).
        "static": replays the construction-time size chain (`efficientnet_custom.py:166-198`:
        image_size -> ceil(size/stride) after the stem and each strided block). Only
        the stem and strided convs can differ from true SAME (stride-1 SAME padding
        does not depend on the size). A conv whose traced padding would collapse a
        dim of the actual input to zero takes true SAME for that dim instead, a
        regime where the reference itself fails, so tiny test geometries still run."""
        same = self.pad_mode == "same"
        res = 0 if same else EFFICIENTNET_PARAMS[self.variant][2]  # the traced resolution
        size = (res, res)
        actual = tuple(input_hw)

        def pick(traced, act, k, s):
            pads, new_act = [], []
            for idx in range(2):
                p = _pad1d(act[idx] if same else traced[idx], k, s)
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

    def forward(self, x: torch.Tensor, capture: Sequence[int] = (), pool_mode: str = "avg",
                generator: Optional[torch.Generator] = None, head_f32: bool = False):
        """`generator` draws the drop-connect masks of a training forward (on x's
        device; None: torch's default generator). `head_f32`: at bf16 in inference
        the features come out as the head SiLU's last product unrounded, in float32
        (what XLA's program pools when the JAX package casts the features to
        float32 for pooling)."""
        stem_pad, block_pads = self._paddings((int(x.shape[1]), int(x.shape[2])))
        x = x.permute(0, 3, 1, 2)  # NHWC buffer viewed as NCHW channels_last
        # grayscale -> in_channels copies (the reference feeds PIL-RGB copies of the
        # grayscale probes; mean/std normalization commutes with the copy)
        if x.shape[1] == 1 and self.in_channels > 1:
            x = x.expand(-1, self.in_channels, -1, -1)
        x = x.contiguous(memory_format=torch.channels_last)
        x = _conv_bn_act(self._conv_stem, self._bn0, _pad(x, stem_pad), "silu")[0]
        captured: Dict[str, torch.Tensor] = {}
        n_blocks = len(self._blocks)
        remat = self.remat and torch.is_grad_enabled()
        for i, block in enumerate(self._blocks):
            rate = self.drop_connect_rate * i / n_blocks
            keep = None
            if self.training and block.residual and rate > 0.0:
                # drawn here, outside the checkpointed call: a recompute draws nothing
                # and sees the same mask (checkpoint restores only the default RNGs)
                keep = drop_connect_mask(x.shape[0], rate, x.device, generator)
            if remat:
                x = checkpoint(block, x, block_pads[i], rate, keep, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=lambda b=block: (contextlib.nullcontext(),
                                                           _running_stats_frozen(b)))
                if i in capture:
                    captured[f"blocks.{i}"] = pool_activation(x.float(), pool_mode)
            elif i in capture:
                x, pooled = block(x, block_pads[i], rate, keep, capture=True)
                captured[f"blocks.{i}"] = pool_activation(pooled, pool_mode)
            else:
                x = block(x, block_pads[i], rate, keep)
        x, _ = _conv_bn_act(self._conv_head, self._bn1, x, "silu_f32" if head_f32 else "silu")
        return x, captured


class EfficientNetMammo(EfficientNet):
    """Backbone + spatial pooling: BreastClip's image tower.

    pooling="avg" is the canonical 'tf_efficientnet_b5_ns-detect' tower (the
    reference's vendored EfficientNet with AdaptiveAvgPool2d + flatten); "gem" the
    timm-backed EfficientNet_Mammo with GeM(p=3). Pooling runs in float32."""

    def __init__(self, variant: str = "efficientnet-b5", in_channels: int = 3,
                 pooling: str = "avg", dtype: torch.dtype = torch.float32, **kw):
        super().__init__(variant=variant, in_channels=in_channels, dtype=dtype, **kw)
        if pooling not in ("avg", "gem"):
            raise ValueError(f"pooling must be 'avg' or 'gem', got {pooling!r}")
        self.pooling = pooling
        if pooling == "gem":
            self.pool = GeM()

    def forward(self, x: torch.Tensor, capture: Sequence[int] = (), pool_mode: str = "avg",
                generator: Optional[torch.Generator] = None):
        features, captured = super().forward(x, capture=capture, pool_mode=pool_mode,
                                             generator=generator, head_f32=True)
        if self.pooling == "gem":
            return self.pool(features), captured
        return features.float().mean(dim=(2, 3)), captured
