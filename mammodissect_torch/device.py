"""Device and dtype resolution and the float32 precision policy of the entry points."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (the default) and no GPU is present: an entry
    point never carries on quietly on the CPU; `device="cpu"` is the only way
    there."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mammodissect_torch runs on a CUDA GPU by default, and none is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype, its name ("bfloat16") or None (float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return resolved


def set_fp32_policy() -> None:
    """Turn TF32 off for float32 matmuls and convolutions.

    Scoring is true float32 (the JAX package uses Precision.HIGHEST for
    clip_feats and the cosine scores), and cuDNN runs float32 convolutions in
    TF32 by default, which keeps only about three decimal digits. The port's own
    MBConv kernel keeps to the policy on the tensor cores: its float32 expand is
    3xTF32 (each operand split into two tf32 parts, three products summed in
    float32), about as accurate as float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
