"""Classifier fine-tune dataset and sampling (a copy of `mammodissect/train/data.py`,
single process).

The reference's `MammoDataset` (`Datasets/dataset_concepts.py:168-227`: grayscale
load, albumentations, min-max + mean/std) and `get_dataloader_RSNA`'s samplers
(`Datasets/dataset_utils.py:121-251`: shuffled or WeightedRandom balanced). With the
same seed every batch holds the same bytes as the JAX loader's. `iter_epoch` is
synchronous and single-threaded, as there."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import pandas as pd

from mammodissect_torch.data import transforms as T
from mammodissect_torch.data.loader import HostBatch


@dataclass
class ClassifierDataset:
    """CSV-driven image + label dataset with the mammogram normalization contract.
    wire "f32": host-normalized float batches (4 B/px); "u8": post-transform uint8
    batches (1 B/px), normalized on the device by the trainer."""

    df: pd.DataFrame
    image_col: str = "image_path"
    label_col: str = "cancer"
    root: str = ""
    size_hw: tuple = (1520, 912)
    mean: float = T.VINDR_MEAN
    std: float = T.VINDR_STD
    train: bool = False
    seed: int = 0
    wire: str = "f32"

    def __post_init__(self):
        if self.wire not in ("f32", "u8"):
            raise ValueError(f"wire must be 'f32' or 'u8', got {self.wire!r}")
        self._rng = np.random.default_rng(self.seed)
        self.image_shape = (self.size_hw[0], self.size_hw[1], 1)

    def __len__(self):
        return len(self.df)

    def image(self, i: int) -> np.ndarray:
        path = os.path.join(self.root, str(self.df.iloc[i][self.image_col]))
        return T.load_for_wire(path, self.size_hw, self.mean, self.std,
                               self.train, self.wire, self._rng)

    def label(self, i: int):
        return self.df.iloc[i][self.label_col]


def resample_balanced(df: pd.DataFrame, label_col: str, ratio: float = 1.0,
                      seed: int = 0) -> pd.DataFrame:
    """Per-class resampled DataFrame: the minority class whole, the others downsampled
    to `ratio` x its size (the CSAW balanced loader, `Datasets/dataset_concepts.py:16-166`)."""
    rng = np.random.default_rng(seed)
    labels = df[label_col].astype(int)
    counts = labels.value_counts()
    minority = counts.idxmin()
    n_keep = int(counts.min() * ratio)
    parts = []
    for cls, grp in df.groupby(label_col, sort=False):
        if int(cls) == int(minority) or len(grp) <= n_keep:
            parts.append(grp)
        else:
            parts.append(grp.iloc[rng.permutation(len(grp))[:n_keep]])
    out = pd.concat(parts)
    return out.iloc[rng.permutation(len(out))].reset_index(drop=True)


def class_balanced_weights(labels: np.ndarray, sampler_weights: Optional[dict] = None):
    """Per-sample weights: an explicit class -> weight map
    (`lumi_single_gpu_train_classifier.py:186-192`) or inverse class frequency."""
    labels = np.asarray(labels).astype(np.int64)
    if sampler_weights:
        return np.asarray([float(sampler_weights[int(l)]) for l in labels])
    counts = np.bincount(labels)
    return 1.0 / np.maximum(counts[labels], 1)


def iter_epoch(dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
               balanced_weights: Optional[np.ndarray] = None, drop_last: bool = False,
               label_dtype=np.float32, host_index: int = 0,
               host_count: int = 1) -> Iterator[HostBatch]:
    """One epoch of fixed-size batches. With `balanced_weights`, len(dataset) indices
    drawn with replacement in proportion to them (WeightedRandomSampler,
    `dataset_utils.py:202-234`). The tail batch is wrap-padded with real rows (not
    zeros, which would enter BatchNorm's batch statistics as fake negatives) and
    reports its `n_valid`; with `drop_last` a short tail is dropped instead.
    `host_index`/`host_count` give each process its contiguous, equally long,
    wrap-padded slice of the same seeded order (DistributedSampler,
    `dataset_utils.py:236-251`)."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    if balanced_weights is not None:
        order = rng.choice(n, size=n, replace=True, p=balanced_weights / balanced_weights.sum())
    elif shuffle:
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    if host_count > 1:
        shard_len = -(-n // host_count)
        order = np.resize(order, host_count * shard_len)
        order = order[host_index * shard_len:(host_index + 1) * shard_len]
        n = shard_len
    h, w, c = dataset.image_shape
    img_dtype = np.uint8 if getattr(dataset, "wire", "f32") == "u8" else np.float32
    for start in range(0, n, batch_size):
        idx = order[start: start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        n_valid = len(idx)
        if n_valid < batch_size:
            idx = np.resize(idx, batch_size)
        imgs = np.zeros((batch_size, h, w, c), img_dtype)
        labels = np.zeros((batch_size,), label_dtype)
        for j, i in enumerate(idx):
            imgs[j] = dataset.image(int(i))
            labels[j] = dataset.label(int(i))
        yield HostBatch(images=imgs, n_valid=n_valid, start=start, labels=labels)
