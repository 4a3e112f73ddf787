"""Host-side image preprocessing in numpy (the part of `mammodissect/data/transforms.py`
the probes need, copied).

- min-max normalize then mean/std (`Datasets/dataset_concepts.py:212-215`)
- VinDr resize 1520x912, mean 0.3089279 / std 0.25053555 (`concept_vit/data_utils.py:120-122`)
All float outputs are HWC float32. The resize is PIL's bilinear (the JAX package
prefers its native cv2-style resize for float images when that is built)."""
from __future__ import annotations

import numpy as np
from PIL import Image

VINDR_MEAN = 0.3089279
VINDR_STD = 0.25053555
VINDR_SIZE = (1520, 912)  # (H, W)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image(path: str, grayscale: bool) -> np.ndarray:
    """Read an image file to HWC float32 in [0, 1]."""
    with Image.open(path) as im:
        im = im.convert("L" if grayscale else "RGB")
        arr = np.asarray(im, dtype=np.float32) / 255.0
    if grayscale:
        arr = arr[..., None]
    return arr


def load_image_u8_resized(path: str, size_hw: tuple[int, int]) -> np.ndarray:
    """Read + resize a grayscale image staying in uint8 (the reference resizes the
    uint8 image before float conversion). Output [H, W, 1] uint8: the wire format
    of the device-side normalization."""
    h, w = size_hw
    with Image.open(path) as im:
        im = im.convert("L")
        if im.size != (w, h):
            im = im.resize((w, h), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.uint8)
    return arr[..., None]


def resize(arr: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC float array via PIL."""
    h, w = size_hw
    if arr.shape[:2] == (h, w):
        return arr
    chans = [np.asarray(Image.fromarray(arr[..., c]).resize((w, h), Image.BILINEAR),
                        dtype=np.float32) for c in range(arr.shape[2])]
    return np.stack(chans, axis=-1)


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return arr[top: top + size, left: left + size]


def imagenet_preprocess(arr: np.ndarray, size: int = 224) -> np.ndarray:
    """torchvision-style eval pipeline: resize the short side to 256, center crop,
    ImageNet normalization (`concept_vit/data_utils.py:106-113`)."""
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    h, w = arr.shape[:2]
    scale = 256 / min(h, w)
    arr = resize(arr, (round(h * scale), round(w * scale)))
    arr = center_crop(arr, size)
    return ((arr - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def minmax_meanstd(arr: np.ndarray, mean: float, std: float) -> np.ndarray:
    """Scale to [0, 1] by min-max, then standardize; a constant image maps to 0."""
    lo, hi = float(arr.min()), float(arr.max())
    arr = (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)
    return (arr - mean) / std


def gray_resize_normalize(arr: np.ndarray, size_hw: tuple[int, int], mean: float,
                          std: float) -> np.ndarray:
    """Grayscale resize + min-max + mean/std."""
    if arr.shape[-1] != 1:
        arr = arr.mean(axis=-1, keepdims=True)
    return minmax_meanstd(resize(arr, size_hw), mean, std).astype(np.float32)
