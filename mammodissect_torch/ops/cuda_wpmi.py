"""Soft-WPMI gather + log-reduce: the CUDA kernel `csrc/wpmi_gather_logsum.cu` and
its plain PyTorch version.

    pde[u, c] = sum_k log(1 + p[k] * (clip_sm[inds[u, k], c] - 1) + eps)

Counterpart of the TPU kernel `mammodissect/ops/pallas_wpmi.py::soft_wpmi_gather_logsum`.
`soft_wpmi_gather_logsum` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors, and only then; the plain version is also the kernel's
oracle on the card. `soft_wpmi_gather_logsum.launches` counts kernel launches; under
a profiler each launch is a range `kernel1` (`utils.profiling.kernel_range`).
"""
from __future__ import annotations

import ctypes

import torch

from mammodissect_torch.ops import kernels
from mammodissect_torch.utils.profiling import kernel_range

_MAX_UNIT_TILES = 65535  # gridDim.y of the kernel's gather design
_UNITS_PER_TILE = 4      # its U_TILE


def soft_wpmi_gather_logsum_plain(clip_sm: torch.Tensor, inds: torch.Tensor,
                                  p_in: torch.Tensor, min_prob: float = 1e-7,
                                  unit_batch: int = 128) -> torch.Tensor:
    """clip_sm [N, C] f32, inds [U, k] int, p_in [k] f32 -> [U, C] f32: a torch gather,
    the same log term and a sum over k, `unit_batch` units at a time (the JAX
    path's lax.map batch) so the [units, k, C] gather stays bounded."""
    inds = inds.long()
    out = torch.empty((inds.shape[0], clip_sm.shape[1]), dtype=torch.float32,
                      device=clip_sm.device)
    p = p_in.float()[:, None]
    for u0 in range(0, inds.shape[0], unit_batch):
        rows = clip_sm[inds[u0:u0 + unit_batch]]  # [ub, k, C]
        out[u0:u0 + unit_batch] = torch.sum(torch.log(1.0 + p * (rows - 1.0) + min_prob), dim=1)
    return out


def _check(clip_sm: torch.Tensor, inds: torch.Tensor, p_in: torch.Tensor) -> None:
    """Raise on what the kernel does not take (no host sync; the kernel itself checks
    that the indices lie in [0, N))."""
    _, k = inds.shape
    if clip_sm.dtype != torch.float32 or p_in.dtype != torch.float32:
        raise TypeError("soft_wpmi_gather_logsum: clip_sm and p_in must be float32")
    if inds.dtype != torch.int32:
        raise TypeError("soft_wpmi_gather_logsum: inds must be int32")
    if p_in.shape != (k,):
        raise ValueError(f"soft_wpmi_gather_logsum: p_in {tuple(p_in.shape)} != ({k},)")
    if not (clip_sm.device == inds.device == p_in.device):
        raise ValueError("soft_wpmi_gather_logsum: all inputs must be on one device")
    if -(-inds.shape[0] // _UNITS_PER_TILE) > _MAX_UNIT_TILES:
        raise ValueError(f"soft_wpmi_gather_logsum: {inds.shape[0]} units exceed one launch")
    if clip_sm.shape[0] == 0 and inds.numel():  # no row 0 to read in a bad index's place
        raise IndexError("soft_wpmi_gather_logsum: indices into an empty clip_sm")


def _entry():
    """The library's C entry point, its argument types set once."""
    fn = kernels.load("wpmi_gather_logsum").wpmi_gather_logsum
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(clip_sm: torch.Tensor, inds: torch.Tensor, p_in: torch.Tensor,
            min_prob: float):
    """The kernel on inputs that passed `_check`, with no host sync. Returns (pde,
    bad): bad is one int32 on the device, 1 when an index lay outside [0, N) (the
    kernel then read row 0 in its place)."""
    n, c = clip_sm.shape
    u, k = inds.shape
    clip_sm, inds, p_in = clip_sm.contiguous(), inds.contiguous(), p_in.contiguous()
    out = torch.empty((u, c), dtype=torch.float32, device=clip_sm.device)
    bad = torch.empty((1,), dtype=torch.int32, device=clip_sm.device)
    fn = _entry()
    with torch.cuda.device(clip_sm.device):
        stream = torch.cuda.current_stream().cuda_stream
        with kernel_range("kernel1"):
            rc = fn(clip_sm.data_ptr(), inds.data_ptr(), p_in.data_ptr(), out.data_ptr(),
                    bad.data_ptr(), n, c, u, k, float(min_prob), stream)
    kernels.check(rc, "wpmi_gather_logsum")
    soft_wpmi_gather_logsum.launches += 1
    return out, bad


def soft_wpmi_gather_logsum(clip_sm: torch.Tensor, inds: torch.Tensor, p_in: torch.Tensor,
                            min_prob: float = 1e-7) -> torch.Tensor:
    """clip_sm [N, C] f32 (softmaxed), inds [U, k], p_in [k] f32 -> pde [U, C] f32.

    CUDA tensors go through the kernel (int32 indices; a launch error raises, and so
    does an index outside [0, N), at the one host sync of the call), CPU tensors
    through `soft_wpmi_gather_logsum_plain`."""
    if clip_sm.device.type == "cpu":
        return soft_wpmi_gather_logsum_plain(clip_sm, inds, p_in, min_prob)
    if clip_sm.device.type != "cuda":
        raise ValueError(f"soft_wpmi_gather_logsum: unsupported device {clip_sm.device}")
    inds = inds.to(torch.int32)
    _check(clip_sm, inds, p_in)
    out, bad = _launch(clip_sm, inds, p_in, min_prob)
    if bad.item():
        raise IndexError(f"soft_wpmi_gather_logsum: indices outside [0, {clip_sm.shape[0]})")
    return out


soft_wpmi_gather_logsum.launches = 0
