"""Host-side batches of a fixed size (a copy of `mammodissect/data/loader.py`).

`iter_batches` pads the last batch to `batch_size` with zeros and reports `n_valid`,
so every batch has one shape. Order is preserved: the CSV's `images` column indexes
D_probe by position (`describe_broad_neurons.py:102,110`). This is the float32
batch path of the staged harvest, for probes without `image_u8`."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class HostBatch:
    images: np.ndarray  # [batch_size, H, W, C] float32 (padded)
    n_valid: int
    start: int  # global index of the first row
    labels: Optional[np.ndarray] = None


def iter_batches(probe, batch_size: int, with_labels: bool = False) -> Iterator[HostBatch]:
    n = len(probe)
    h, w, c = probe.image_shape
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        imgs = np.zeros((batch_size, h, w, c), dtype=np.float32)
        labels = np.zeros((batch_size,), dtype=np.int64) if with_labels else None
        for j, i in enumerate(range(start, stop)):
            imgs[j] = probe.image(i)
            if with_labels:
                lab = probe.label(i)
                labels[j] = -1 if lab is None else int(lab)
        yield HostBatch(images=imgs, n_valid=stop - start, start=start, labels=labels)
