"""PyTorch/CUDA port of mammodissect for NVIDIA Hopper (H100).

The package mirrors the layout of the JAX package `mammodissect/` so that each
counterpart is easy to find, and uses PyTorch idiom inside: `nn.Module`s, plain
tensor functions, an explicit `device` and explicit `torch.Generator`s. The two
hand-written TPU kernels of the JAX package are hand-written CUDA kernels here
(`csrc/`, built for sm_90a on first use by `ops/kernels.py`).

Entry points (`cli.dissect`, `cli.finetune`, `cli.zseval`,
`dissect.engine.run_dissection`, the dissector and target factories) run on the GPU unless the caller asks for the CPU (`device="cpu"` /
`--device cpu`); without a GPU they raise instead of falling back.

This package imports torch and never jax, flax or anything of `mammodissect`.
"""

__version__ = "0.1.0"
