"""Probe datasets, the D_probe side of dissection (`mammodissect/data/probes.py`,
copied, without the `cifar100` probes, which need a torchvision download).

Every probe has a static `image_shape` (H, W, C), `len()` and `image(i)` -> HWC
float32; the resident path reads `image_u8(i)` -> HWC uint8 and normalizes on the
device with the probe's `mean` / `std`.

Probe specs (`get_probe`):
  synthetic       deterministic random float probe
  synthetic_u8    uint8 probe with the mammography normalization constants
  folder:<path>   directory of images
  txt:<file>      `path label` list file
  csv:<file>      CSV with an image-path column, 1520x912 grayscale by default
  combined:<a>+<b>  concatenation
  vindr, csaw, csaw_all_splits, embed_png, embed_marker_84, embed_marker_only,
  embed_implant, embed_non_implant, embed_non_implant_100
                  the reference's named mammography probes: CSV probes over the
                  metadata CSV given as csv_file= (images under root=); `csaw`
                  keeps the rows of one `split` (default "training"), the EMBED
                  subsets select rows by their `Marker` / `Implant_type` columns
                  (`concept_vit/data_utils.py:169-251`)
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from mammodissect_torch.data import transforms as T

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


class Probe:
    """Uniform probe interface: len() + image(i) -> HWC float32 (+ optional label(i))."""

    image_shape: tuple  # (H, W, C), the same for the whole probe

    def __len__(self) -> int:
        raise NotImplementedError

    def image(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def label(self, i: int):
        return None


class HostShardedProbe(Probe):
    """This rank's contiguous shard of a probe, the DistributedSampler of each rank
    (`Datasets/dataset_utils.py:236-251`), JAX's contract: every shard holds
    ceil(n / count) images, the last one repeating the probe's final image (wrap
    padding), and callers trim the gathered result to the true total
    (`parallel.multihost.gather_predictions`). `index`/`count` default to this
    process's rank and the world size."""

    def __init__(self, probe: Probe, index: Optional[int] = None, count: Optional[int] = None):
        import torch.distributed as dist

        up = dist.is_initialized()
        self.base = probe
        self.index = (dist.get_rank() if up else 0) if index is None else index
        self.count = (dist.get_world_size() if up else 1) if count is None else count
        self.per_host = -(-len(probe) // self.count)
        self.image_shape = probe.image_shape
        for attr in ("mean", "std"):
            if hasattr(probe, attr):
                setattr(self, attr, getattr(probe, attr))
        if hasattr(probe, "image_spans"):
            # an instance attribute: hasattr(shard, "image_spans") mirrors the base
            # probe (the packed wire's detection), the index remapped as elsewhere
            self.image_spans = lambda i: probe.image_spans(self._base_index(i))

    def __len__(self):
        return self.per_host

    def _base_index(self, i: int) -> int:
        return min(self.index * self.per_host + i, len(self.base) - 1)

    def image(self, i):
        return self.base.image(self._base_index(i))

    def label(self, i):
        return self.base.label(self._base_index(i))

    def image_u8(self, i):
        return self.base.image_u8(self._base_index(i))


@dataclass
class ArrayProbe(Probe):
    """In-memory probe (synthetic data, tests, benchmarks)."""

    images: np.ndarray  # [N, H, W, C] float32 or uint8
    labels: Optional[np.ndarray] = None

    mean: float = 0.0
    std: float = 1.0

    def __post_init__(self):
        self.image_shape = tuple(self.images.shape[1:])

    def __len__(self):
        return len(self.images)

    def image(self, i):
        img = self.images[i]
        if img.dtype == np.uint8:
            # normalized view consistent with the device-side normalization
            x = img.astype(np.float32) / 255.0
            lo, hi = x.min(), x.max()
            x = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
            return (x - self.mean) / self.std
        return img

    def image_u8(self, i):
        if self.images.dtype == np.uint8:
            return self.images[i]
        raise AttributeError("ArrayProbe holds float images; the uint8 path is unavailable")

    def label(self, i):
        return None if self.labels is None else self.labels[i]


class FolderProbe(Probe):
    """Recursively globbed image directory, sorted paths (class label = parent dir
    name, like torchvision's ImageFolder)."""

    def __init__(self, root: str, preprocess: Callable[[np.ndarray], np.ndarray],
                 image_shape: tuple, grayscale: bool = False):
        self.root = root
        self.preprocess = preprocess
        self.image_shape = image_shape
        self.grayscale = grayscale
        paths: List[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTS):
                    paths.append(os.path.join(dirpath, f))
        if not paths:
            raise FileNotFoundError(f"no images under {root!r}")
        self.paths = paths
        classes = sorted({os.path.basename(os.path.dirname(p)) for p in paths})
        self._class_ids = {c: i for i, c in enumerate(classes)}

    def __len__(self):
        return len(self.paths)

    def image(self, i):
        return self.preprocess(T.load_image(self.paths[i], self.grayscale))

    def label(self, i):
        return self._class_ids[os.path.basename(os.path.dirname(self.paths[i]))]


class TxtListProbe(Probe):
    """`path label`-per-line list file (reference `CustomImageDatasetFromTxt`,
    `data/Imagenet_custom_dataloader.py:5-37`), paths relative to `root`."""

    def __init__(self, list_file: str, root: str = "", preprocess=None,
                 image_shape: tuple = (224, 224, 3), grayscale: bool = False):
        self.image_shape = tuple(image_shape)
        if preprocess is None:
            preprocess = (T.imagenet_preprocess if self.image_shape == (224, 224, 3)
                          else _default_folder_preprocess(self.image_shape))
        self.preprocess = preprocess
        self.grayscale = grayscale
        self.entries: List[tuple] = []
        with open(list_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                path = os.path.join(root, parts[0]) if root else parts[0]
                lab = int(parts[1]) if len(parts) > 1 else -1
                self.entries.append((path, lab))

    def __len__(self):
        return len(self.entries)

    def image(self, i):
        return self.preprocess(T.load_image(self.entries[i][0], self.grayscale))

    def label(self, i):
        return self.entries[i][1]


class CsvProbe(Probe):
    """CSV-driven mammography probe (vindr / csaw / embed families): an image-path
    column plus optional label columns; 1520x912 grayscale min-max mean/std
    (`concept_vit/data_utils.py:114-158`)."""

    def __init__(self, csv_file: Optional[str] = None, image_col: str = "image_path",
                 root: str = "", label_col: Optional[str] = None,
                 split_col: Optional[str] = None, split: Optional[str] = None,
                 size_hw: tuple = T.VINDR_SIZE, mean: float = T.VINDR_MEAN,
                 std: float = T.VINDR_STD, filters: Optional[dict] = None, df=None):
        import pandas as pd

        if df is None:
            if csv_file is None:
                raise TypeError("CsvProbe needs csv_file= or df=")
            df = pd.read_csv(csv_file)
        else:
            df = df.reset_index(drop=True)
        for col, val in (filters or {}).items():
            df = df[df[col] == val].reset_index(drop=True)
        if split_col and split is not None and split_col in df.columns:
            df = df[df[split_col] == split].reset_index(drop=True)
        self.df = df
        self.image_col = image_col
        self.label_col = label_col
        self.root = root
        self.size_hw = size_hw
        self.mean, self.std = mean, std
        self.image_shape = (size_hw[0], size_hw[1], 1)

    def __len__(self):
        return len(self.df)

    def _path(self, i):
        return os.path.join(self.root, str(self.df.iloc[i][self.image_col]))

    def image(self, i):
        arr = T.load_image(self._path(i), grayscale=True)
        return T.gray_resize_normalize(arr, self.size_hw, self.mean, self.std)

    def image_u8(self, i):
        """Resized uint8 image for the device-side normalization."""
        return T.load_image_u8_resized(self._path(i), self.size_hw)

    def label(self, i):
        return None if self.label_col is None else self.df.iloc[i][self.label_col]


class ConcatProbe(Probe):
    """Sequential concatenation (reference `combined` probe, `data_utils.py:159-167`).
    All members must share image_shape."""

    def __init__(self, probes: Sequence[Probe]):
        shapes = {p.image_shape for p in probes}
        if len(shapes) != 1:
            raise ValueError(f"combined probes must share image_shape, got {shapes}")
        self.probes = list(probes)
        self.image_shape = probes[0].image_shape
        self._offsets = np.cumsum([0] + [len(p) for p in probes])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, i):
        j = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self.probes[j], i - int(self._offsets[j])

    def image(self, i):
        p, k = self._locate(i)
        return p.image(k)

    def label(self, i):
        p, k = self._locate(i)
        return p.label(k)


def synthetic_probe(n: int = 64, h: int = 64, w: int = 64, c: int = 1, seed: int = 0) -> ArrayProbe:
    """Deterministic random float probe (tests)."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(n, h, w, c)).astype(np.float32)
    labels = rng.integers(0, 10, size=n)
    return ArrayProbe(imgs, labels)


def get_probe(spec: str, **kw) -> Probe:
    """Resolve a probe spec string (reference `get_data`, `data_utils.py:102-311`)."""
    if spec.startswith("combined:"):
        return ConcatProbe([get_probe(p, **kw) for p in spec[len("combined:"):].split("+")])
    if spec == "synthetic":
        return synthetic_probe(**{k: v for k, v in kw.items() if k in ("n", "h", "w", "c", "seed")})
    if spec == "synthetic_u8":
        rng = np.random.default_rng(kw.get("seed", 0))
        n, h = kw.get("n", 64), kw.get("h", 64)
        w, c = kw.get("w", 64), kw.get("c", 1)
        return ArrayProbe(
            rng.integers(0, 256, size=(n, h, w, c), dtype=np.uint8),
            rng.integers(0, 10, size=n),
            mean=kw.get("mean", 0.3089279), std=kw.get("std", 0.25053555),
        )
    if spec.startswith("folder:"):
        shape = tuple(kw.get("image_shape") or (224, 224, 3))
        grayscale = bool(kw.get("grayscale", shape[-1] == 1))
        preprocess = kw.get("preprocess") or _default_folder_preprocess(shape)
        return FolderProbe(spec[len("folder:"):], preprocess, shape, grayscale=grayscale)
    if spec.startswith("txt:"):
        return TxtListProbe(spec[len("txt:"):], root=kw.get("root", ""),
                            preprocess=kw.get("preprocess"),
                            image_shape=kw.get("image_shape", (224, 224, 3)))
    if spec.startswith("csv:"):
        return CsvProbe(spec[len("csv:"):], **{k: v for k, v in kw.items() if k in (
            "image_col", "root", "label_col", "split_col", "split", "size_hw", "mean",
            "std", "filters")})
    if spec in NAMED_PROBES:
        csv_file = kw.get("csv_file")
        if not csv_file:
            raise ValueError(
                f"probe {spec!r} needs csv_file=<metadata csv> (and root=) in this environment")
        split_kw = ({"split_col": "split", "split": kw.get("split", "training")}
                    if spec == "csaw" else {})
        return CsvProbe(csv_file, root=kw.get("root", ""),
                        image_col=kw.get("image_col", "image_path"),
                        filters=kw.get("filters", NAMED_PROBES[spec]), **split_kw)
    raise KeyError(f"unknown probe spec {spec!r} (known: {', '.join(PROBES)})")


# the reference's named probes -> the metadata filter of each; the 100-image EMBED
# variant is the same dataset pointed at a 100-row CSV (`data_utils.py:240-251`)
NAMED_PROBES = {
    "vindr": None, "csaw": None, "csaw_all_splits": None, "embed_png": None,
    "embed_marker_84": {"Marker": 1},
    "embed_marker_only": {"Marker": 1},
    "embed_implant": {"Implant_type": 1},
    "embed_non_implant": {"Implant_type": 0},
    "embed_non_implant_100": {"Implant_type": 0},
}
PROBES = ("synthetic", "synthetic_u8", "folder:<path>", "txt:<file>", "csv:<file>",
          "combined:<a>+<b>", *NAMED_PROBES)


def _default_folder_preprocess(shape: tuple):
    """Resize to `shape` (+ grayscale min-max mean/std for 1-channel targets,
    ImageNet normalization for RGB)."""
    h, w, c = shape
    if c == 1:
        return lambda arr: T.minmax_meanstd(
            T.resize(arr if arr.shape[-1] == 1 else arr.mean(axis=-1, keepdims=True), (h, w)),
            T.VINDR_MEAN, T.VINDR_STD,
        ).astype(np.float32)
    return lambda arr: (
        (T.resize(np.repeat(arr, 3, axis=-1) if arr.shape[-1] == 1 else arr, (h, w))
         - T.IMAGENET_MEAN) / T.IMAGENET_STD
    ).astype(np.float32)
