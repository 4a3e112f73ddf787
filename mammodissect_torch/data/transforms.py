"""Host-side image preprocessing in numpy (a copy of `mammodissect/data/transforms.py`).

- min-max normalize then mean/std (`Datasets/dataset_concepts.py:212-215`)
- VinDr resize 1520x912, mean 0.3089279 / std 0.25053555 (`concept_vit/data_utils.py:120-122`)
- CLIP eval preprocessing: 224 bicubic resize, center crop, CLIP normalization
  (`concept_vit/clip/clip.py:79-86`)
- the box-aware detection augmentation of the concept-detection dataset
- the train-time augmentation (flips, one affine warp, elastic deformation) and the
  (train x wire) load matrix of the fine-tune loader, `load_for_wire`: the same
  bytes as the JAX package's for the same seed on the uint8 wire and in training
All float outputs are HWC float32. `gray_resize_normalize`, the float eval path
(`CsvProbe.image`, the fine-tune loader's f32 eval wire), resizes with the native
cv2-style bilinear of `native/` (no antialiasing), as the JAX package does, and
with PIL only where the native library cannot be built (no g++); every other
resize, and the uint8 paths, use PIL's bilinear (bicubic in `clip_preprocess`), as
in the JAX package."""
from __future__ import annotations

import numpy as np
from PIL import Image

from mammodissect_torch import native

VINDR_MEAN = 0.3089279
VINDR_STD = 0.25053555
VINDR_SIZE = (1520, 912)  # (H, W)

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
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


def resize(arr: np.ndarray, size_hw: tuple[int, int], method: str = "bilinear") -> np.ndarray:
    """Resize of an HWC float array via PIL: bilinear for the mammography pipeline,
    bicubic (`method="bicubic"`) for CLIP's."""
    h, w = size_hw
    if arr.shape[:2] == (h, w):
        return arr
    resample = Image.BICUBIC if method == "bicubic" else Image.BILINEAR
    chans = [np.asarray(Image.fromarray(arr[..., c]).resize((w, h), resample),
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
                          std: float, prefer_native: bool = True) -> np.ndarray:
    """Grayscale resize + min-max + mean/std: the native cv2-style resize when the
    library builds (and `prefer_native`), else PIL's bilinear."""
    if arr.shape[-1] != 1:
        arr = arr.mean(axis=-1, keepdims=True)
    if prefer_native and native.available():
        return native.resize_normalize(arr, size_hw, mean, std)
    return minmax_meanstd(resize(arr, size_hw), mean, std).astype(np.float32)


def vindr_preprocess(arr: np.ndarray, size_hw: tuple[int, int] = VINDR_SIZE) -> np.ndarray:
    """The VinDr probe pipeline: grayscale, bilinear resize to 1520x912, min-max and
    mean/std."""
    if arr.shape[-1] != 1:
        arr = arr.mean(axis=-1, keepdims=True)
    arr = resize(arr, size_hw)
    return minmax_meanstd(arr, VINDR_MEAN, VINDR_STD).astype(np.float32)


def clip_preprocess(arr: np.ndarray, size: int = 224) -> np.ndarray:
    """OpenAI CLIP's eval pipeline (`concept_vit/clip/clip.py:79-86`): bicubic resize
    of the short side to `size`, center crop, CLIP normalization."""
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    h, w = arr.shape[:2]
    scale = size / min(h, w)
    arr = resize(arr, (round(h * scale), round(w * scale)), method="bicubic")
    arr = center_crop(arr, size)
    return ((arr - CLIP_MEAN) / CLIP_STD).astype(np.float32)


def to_u8(arr: np.ndarray) -> np.ndarray:
    """Quantize a [0, 1] float image to uint8: the reference's albumentations
    transforms are uint8 in and out, so every image is uint8 until the final
    normalize (`Datasets/dataset_concepts.py:206-215`)."""
    return np.rint(np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


# ------------------------------------------------------------------ train-time augment
def affine_matrix(angle_deg: float, tx: float, ty: float, scale: float,
                  shear_x_deg: float, cx: float, cy: float) -> np.ndarray:
    """Forward 3x3 affine (input (x, y, 1) -> output): rotate, shear and scale about
    the image center, then translate: the components of the reference's
    albumentations `Affine(rotate, translate_percent, scale, shear)`
    (`data/data_utils.py:35-41`, `Datasets/dataset_utils.py:46`)."""
    a = np.deg2rad(angle_deg)
    sh = np.deg2rad(shear_x_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    shear = np.array([[1.0, -np.tan(sh), 0], [0, 1.0, 0], [0, 0, 1.0]])
    sc = np.diag([scale, scale, 1.0])
    to_c = np.array([[1.0, 0, -cx], [0, 1.0, -cy], [0, 0, 1.0]])
    from_c = np.array([[1.0, 0, cx + tx], [0, 1.0, cy + ty], [0, 0, 1.0]])
    return from_c @ rot @ shear @ sc @ to_c


def apply_affine(arr: np.ndarray, fwd: np.ndarray) -> np.ndarray:
    """Warp HWC float32 by a forward affine matrix in one bilinear resampling pass
    (PIL takes the inverse map: output (x, y) -> input coordinates)."""
    inv = np.linalg.inv(fwd)
    data = (inv[0, 0], inv[0, 1], inv[0, 2], inv[1, 0], inv[1, 1], inv[1, 2])
    h, w = arr.shape[:2]
    chans = []
    for c in range(arr.shape[2]):
        im = Image.fromarray(arr[..., c])
        im = im.transform((w, h), Image.AFFINE, data, resample=Image.BILINEAR)
        chans.append(np.asarray(im, dtype=np.float32))
    return np.stack(chans, axis=-1)


def elastic_deform(arr: np.ndarray, rng: np.random.Generator,
                   alpha: float = 10.0, sigma: float = 15.0) -> np.ndarray:
    """Elastic deformation with albumentations `ElasticTransform(alpha=10, sigma=15)`
    semantics (`data/data_utils.py:42-45`, `configs/transform/clahe.yaml:10-11`):
    displacement fields gaussian_filter(U(-1, 1), sigma) * alpha, sampled bilinearly
    with mirrored borders."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    h, w = arr.shape[:2]
    dx = gaussian_filter(rng.uniform(-1.0, 1.0, size=(h, w)), sigma) * alpha
    dy = gaussian_filter(rng.uniform(-1.0, 1.0, size=(h, w)), sigma) * alpha
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    coords = [yy + dy, xx + dx]
    out = np.stack(
        [map_coordinates(arr[..., c], coords, order=1, mode="mirror")
         for c in range(arr.shape[2])], axis=-1)
    return out.astype(np.float32)


def transform_boxes_affine(boxes: np.ndarray, fwd: np.ndarray) -> np.ndarray:
    """Map [N, 4] xyxy boxes through a forward affine: the 4 corners transformed and
    their axis-aligned hull (imgaug BoundingBox semantics). No clipping: the
    reference keeps out-of-frame coordinates (`dataset_concepts.py:328-331`)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    if not len(boxes):
        return boxes
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack([
        np.stack([x1, y1], 1), np.stack([x2, y1], 1),
        np.stack([x1, y2], 1), np.stack([x2, y2], 1),
    ], axis=1)  # [N, 4, 2]
    pts = corners @ fwd[:2, :2].T + fwd[:2, 2]
    return np.concatenate([pts.min(axis=1), pts.max(axis=1)], axis=1)


def augment_detection(
    arr: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    max_rotate_deg: float = 20.0,
    translate_frac: float = 0.1,
    scale_range: tuple[float, float] = (0.8, 1.2),
    shear_deg: float = 20.0,
    elastic_alpha: float = 10.0,
    elastic_sigma: float = 15.0,
) -> tuple[np.ndarray, np.ndarray]:
    """The reference's box-aware detection augmentation (`Datasets/dataset_utils.py:64-71`,
    an imgaug Sequential): Fliplr(0.5), Flipud(0.5), then always Affine(rotate 20,
    translate 0.1, scale [0.8, 1.2], shear 20) and ElasticTransformation(alpha,
    sigma). The boxes follow the flips and the affine's corners; the elastic field
    (under 0.5 px at alpha 10, sigma 15) warps the image only. Draws from `rng` in
    the JAX package's order, so a seed gives the same image and boxes.

    arr: HWC float; boxes: [N, 4] xyxy pixels. Returns (arr, boxes)."""
    h, w = arr.shape[:2]
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4).copy()
    if rng.random() < 0.5:  # Fliplr
        arr = arr[:, ::-1]
        if len(boxes):
            boxes = np.stack([w - boxes[:, 2], boxes[:, 1],
                              w - boxes[:, 0], boxes[:, 3]], axis=1)
    if rng.random() < 0.5:  # Flipud
        arr = arr[::-1]
        if len(boxes):
            boxes = np.stack([boxes[:, 0], h - boxes[:, 3],
                              boxes[:, 2], h - boxes[:, 1]], axis=1)
    angle = rng.uniform(-max_rotate_deg, max_rotate_deg)
    tx = rng.uniform(-translate_frac, translate_frac) * w
    ty = rng.uniform(-translate_frac, translate_frac) * h
    scale = rng.uniform(*scale_range)
    shear = rng.uniform(-shear_deg, shear_deg)
    fwd = affine_matrix(angle, tx, ty, scale, shear, cx=w / 2.0, cy=h / 2.0)
    arr = apply_affine(np.ascontiguousarray(arr), fwd)
    boxes = transform_boxes_affine(boxes, fwd)
    if elastic_alpha > 0:
        arr = elastic_deform(np.ascontiguousarray(arr), rng,
                             alpha=elastic_alpha, sigma=elastic_sigma)
    return np.ascontiguousarray(arr), boxes


def augment_train(
    arr: np.ndarray,
    rng: np.random.Generator,
    hflip: bool = True,
    vflip: bool = True,
    max_rotate_deg: float = 20.0,
    translate_frac: float = 0.1,
    scale_range: tuple[float, float] = (0.8, 1.2),
    shear_deg: float = 20.0,
    elastic_alpha: float = 10.0,
    elastic_sigma: float = 15.0,
    p: float = 1.0,
) -> np.ndarray:
    """The reference's train augmentation, Compose([HFlip, VFlip, Affine(rotate 20,
    translate 0.1, scale [0.8, 1.2], shear 20), ElasticTransform(alpha 10, sigma 15)],
    p) (`data/data_utils.py:25-67`, `Datasets/dataset_utils.py:42-55`,
    `configs/transform/clahe.yaml:6-12`): the outer p gates the whole pipeline, each
    inner transform applies with probability 0.5. The affine is one combined warp;
    elastic_alpha=0 disables the elastic stage. Draws from `rng` in the JAX
    package's order, so a seed gives the same image."""
    if rng.random() >= p:
        return np.ascontiguousarray(arr)
    if hflip and rng.random() < 0.5:
        arr = arr[:, ::-1]
    if vflip and rng.random() < 0.5:
        arr = arr[::-1]
    if rng.random() < 0.5:
        angle = rng.uniform(-max_rotate_deg, max_rotate_deg)
        tx = rng.uniform(-translate_frac, translate_frac) * arr.shape[1]
        ty = rng.uniform(-translate_frac, translate_frac) * arr.shape[0]
        scale = rng.uniform(*scale_range)
        shear = rng.uniform(-shear_deg, shear_deg)
        fwd = affine_matrix(angle, tx, ty, scale, shear,
                            cx=arr.shape[1] / 2.0, cy=arr.shape[0] / 2.0)
        arr = apply_affine(np.ascontiguousarray(arr), fwd)
    if elastic_alpha > 0 and rng.random() < 0.5:
        arr = elastic_deform(np.ascontiguousarray(arr), rng,
                             alpha=elastic_alpha, sigma=elastic_sigma)
    return np.ascontiguousarray(arr)


def load_for_wire(path: str, size_hw: tuple[int, int], mean: float, std: float,
                  train: bool, wire: str, rng: np.random.Generator) -> np.ndarray:
    """The fine-tune loader's (train x wire) load matrix.

    wire="u8" ships post-transform uint8 (1 B/px; the trainer normalizes on the
    device): for eval a uint8 load and uint8 resize, the reference's pre-normalize
    eval pipeline; for train the augmented float image quantized back to uint8.
    wire="f32" ships the normalized float image."""
    if wire == "u8" and not train:
        return load_image_u8_resized(path, size_hw)
    arr = load_image(path, grayscale=True)
    if train:
        arr = augment_train(resize(arr, size_hw), rng)
        if wire == "u8":
            return to_u8(arr)
        return minmax_meanstd(arr, mean, std).astype(np.float32)
    return gray_resize_normalize(arr, size_hw, mean, std)
