"""Kernel 3 of the PyTorch port, the bf16 tower's BatchNorm epilogue
(`mammodissect_torch/ops/cuda_bn_epilogue.py`), on the CPU: which conv -> BatchNorm
sites of the towers route to it, with the kernel stubbed, and the wrapper on CPU
tensors. Its plain version is the ATen chain that the bf16 parity tests
(`test_torch_bf16.py`, `test_torch_tower.py`, `test_torch_efficientnet_v2.py`) hold to
the JAX package; the kernel against it, bit for bit, runs in `test_torch_gpu.py`."""
import pytest
import torch

from mammodissect_torch.models import efficientnet
from mammodissect_torch.models.efficientnet import (
    EfficientNet,
    EfficientNetMammo,
    FusedMBConvBlock,
    expand_block_args,
)
from mammodissect_torch.ops import cuda_bn_epilogue
from mammodissect_torch.ops.cuda_bn_epilogue import bn_epilogue, bn_epilogue_plain


@pytest.fixture
def launches(monkeypatch):
    """Kernel 3 stubbed on the CPU: CPU tensors count as the kernel's device, and each
    launch is recorded as (act, squeeze) and computed by the plain version."""
    calls = []

    def launch(v, mean, mul, bias, act, squeeze):
        calls.append((act, squeeze))
        return bn_epilogue_plain(v, mean, mul, bias, act, squeeze)

    monkeypatch.setattr(cuda_bn_epilogue, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(cuda_bn_epilogue, "_launch", launch)
    return calls


def _sites(block_args):
    """(epilogue launches, those with a squeeze) of one bf16 inference forward: the
    stem, each block's convs outside kernel 2 (a stride-1 expanded MBConv block leaves
    only its project; another MBConv block its expand, its depthwise, with the SE's
    squeeze, and its project; a FusedMBConv block its one or two convs) and the head."""
    n, squeezes = 2, 0
    for ba in block_args:
        if ba.fused:
            n += 1 + (ba.expand_ratio != 1)
        elif ba.stride == 1 and ba.expand_ratio != 1:
            n += 1
        else:
            n += 2 + (ba.expand_ratio != 1)
            squeezes += bool(ba.se_ratio)
    return n, squeezes


def test_b5_has_52_epilogue_sites_7_with_a_squeeze():
    """B5's 39 blocks: 1 stem, 3 expand-1 depthwise, 4 strided expands and depthwise,
    39 projects, 1 head; the squeeze at the 7 unfused blocks' depthwise."""
    assert _sites(expand_block_args(1.6, 2.2)) == (52, 7)


@pytest.mark.parametrize("variant,hw", [("efficientnet-test", (32, 24)),
                                        ("efficientnetv2-s", (16, 16))])
def test_bf16_inference_routes_every_site_to_the_epilogue(launches, variant, hw):
    """The 7-block test tower (18 sites, 5 with a squeeze) and EfficientNetV2-S (54,
    2), each forward as BreastClip's tower (the head's product in float32)."""
    tower = EfficientNetMammo(variant, in_channels=1, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        tower(torch.randn(2, *hw, 1), capture=range(len(tower._blocks)))
    n, squeezes = _sites(tower.block_args)
    assert len(launches) == n and sum(sq for _, sq in launches) == squeezes
    assert launches[0] == ("silu", False) and launches[-1] == ("silu_f32", False)
    projects = len(tower.block_args) - sum(isinstance(b, FusedMBConvBlock)
                                           and b.args.expand_ratio == 1 for b in tower._blocks)
    assert sum(act is None for act, _ in launches) == projects


@pytest.mark.parametrize("case", ["training", "grad on", "fp32"])
def test_training_grad_and_fp32_bypass_the_epilogue(launches, case):
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    tower = EfficientNet("efficientnet-test", in_channels=1, dtype=dtype,
                         param_dtype=torch.float32)
    tower.train(case == "training")
    with torch.set_grad_enabled(case != "fp32"):
        tower(torch.randn(2, 32, 24, 1))
    assert launches == []


@pytest.mark.parametrize("memory_format", [torch.channels_last, torch.contiguous_format])
def test_sums_in_either_memory_format_route_to_the_epilogue(launches, memory_format):
    """The sums of a 1x1 conv keep its input's memory format; the kernel takes both
    (it copies other sums to channels_last), so the routing does not look at it."""
    tower = EfficientNet("efficientnet-test", in_channels=1, dtype=torch.bfloat16).eval()
    block = tower._blocks[1]
    x = torch.randn(2, block._expand_conv.in_channels, 12, 10, dtype=torch.bfloat16)
    with torch.no_grad():
        out, _ = efficientnet._conv_bn_act(block._expand_conv, block._bn0,
                                           x.contiguous(memory_format=memory_format), "silu")
    assert len(launches) == 1 and out.dtype == torch.bfloat16


@pytest.mark.parametrize("act,squeeze", [(None, False), ("silu", False), ("silu", True),
                                         ("silu_f32", False)])
def test_wrapper_on_cpu_is_plain_and_launches_nothing(act, squeeze):
    v = torch.randn(2, 12, 5, 7).contiguous(memory_format=torch.channels_last)
    terms = torch.randn(12), torch.rand(12) + 0.5, torch.randn(12)
    before = bn_epilogue.launches, bn_epilogue.squeeze_launches
    out, sq = bn_epilogue(v, *terms, act=act, squeeze=squeeze)
    want, want_sq = bn_epilogue_plain(v, *terms, act=act, squeeze=squeeze)
    assert (bn_epilogue.launches, bn_epilogue.squeeze_launches) == before
    assert torch.equal(out, want) and out.dtype == (torch.float32 if act == "silu_f32"
                                                    else torch.bfloat16)
    assert (sq is None) == (not squeeze) and (sq is None or torch.equal(sq, want_sq))


def test_wrapper_refuses_a_device_it_has_no_path_for():
    v = torch.randn(1, 4, 2, 2, device="meta")
    terms = (torch.zeros(4, device="meta"),) * 3
    with pytest.raises(ValueError, match="unsupported device"):
        bn_epilogue(v, *terms, act="silu")


def test_wrapper_refuses_an_act_it_does_not_compute():
    v = torch.randn(1, 4, 2, 2)
    terms = torch.zeros(4), torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="act must be"):
        bn_epilogue(v, *terms, act="gelu")
    with pytest.raises(ValueError, match="squeeze"):
        bn_epilogue(v, *terms, act=None, squeeze=True)
