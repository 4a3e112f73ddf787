"""Synthetic mammogram-shaped uint8 images from a seed, made on the device.

Each image: a half-ellipse "breast" against one lateral edge (which edge, its
centre and radii drawn per image), filled with texture (uniform grey levels 40-255
under a smooth random brightness field of a few low-frequency waves), on an exactly
black background, as the mammogram-shaped probes of the repo's chip runs. Every image
of a pool is distinct. Drawn in chunks by one `torch.Generator` on the device, then
copied once into pinned host memory, from which the probe hands images to the
program."""
from __future__ import annotations

import math

import numpy as np
import torch


@torch.no_grad()
def mammo_pool(n: int, h: int, w: int, seed: int, device, chunk: int = 32) -> torch.Tensor:
    """[n, h, w, 1] uint8 on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, h, w, 1), dtype=torch.uint8, device=device)
    yy = ((torch.arange(h, device=device) + 0.5) / h)[None, :, None]
    xx = ((torch.arange(w, device=device) + 0.5) / w)[None, None, :]
    for s in range(0, n, chunk):
        m = min(chunk, n - s)

        def u(lo, hi, *shape):
            return lo + (hi - lo) * torch.rand((m, *shape), generator=gen, device=device)

        cy, ry, rx = u(0.35, 0.65, 1, 1), u(0.45, 0.58, 1, 1), u(0.55, 0.75, 1, 1)
        left = torch.rand((m, 1, 1), generator=gen, device=device) < 0.5
        dx = torch.where(left, xx, 1.0 - xx)
        mask = ((yy - cy) / ry) ** 2 + (dx / rx) ** 2 <= 1.0
        field = torch.zeros((m, h, w), device=device)
        for _ in range(3):
            fy, fx, ph = u(0.5, 4.0, 1, 1), u(0.5, 4.0, 1, 1), u(0.0, 2 * math.pi, 1, 1)
            field += torch.cos(2 * math.pi * (fy * yy + fx * xx) + ph)
        bright = 0.55 + 0.45 * torch.tanh(field / 2)
        tex = 40.0 + 215.0 * bright * torch.rand((m, h, w), generator=gen, device=device)
        out[s:s + m, :, :, 0] = torch.where(mask, tex.clamp(40, 255), 0.0).to(torch.uint8)
    return out


def to_host(pool: torch.Tensor) -> np.ndarray:
    """The pool in pinned host memory (plain host memory off CUDA), as numpy."""
    host = torch.empty(pool.shape, dtype=pool.dtype, pin_memory=pool.is_cuda)
    host.copy_(pool)
    return host.numpy()


class JobProbe:
    """One job's probe: image i is pool image order[i], in the uint8 interface of the
    port's probes (`image_u8`, `image_shape`, the normalization's `mean` and `std`)."""

    def __init__(self, pool: np.ndarray, order: np.ndarray, mean: float, std: float):
        self.pool, self.order = pool, order
        self.mean, self.std = mean, std
        self.image_shape = tuple(pool.shape[1:])

    def __len__(self):
        return len(self.order)

    def image_u8(self, i):
        return self.pool[self.order[i]]
