"""Concept-detection dataset and collator (a copy of `mammodissect/train/detection_data.py`:
the reference's `Datasets/dataset_concepts.py` `MammoDataset_concept_detection` and
`collater_for_concept_detection` (:255-365) and `plot_image_with_boxes` (:468-477)).

The reference pads each batch's annotation lists to the batch's most boxes with -1
rows; this dataset pads to a fixed `max_boxes`, the JAX dataset's contract, so every
batch has one shape. Box format [x1, y1, x2, y2, class_id]; -1 rows are padding."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from mammodissect_torch.data import transforms as T


@dataclass
class DetectionDataset:
    """CSV with image_path and per-row box annotations.

    Boxes come from columns (xmin/ymin/xmax/ymax/finding), one row per box and
    several rows per image (the VinDr detection layout), grouped by image here."""

    df: "pandas.DataFrame"
    root: str = ""
    image_col: str = "image_path"
    box_cols: tuple = ("xmin", "ymin", "xmax", "ymax")
    class_col: str = "finding"
    class_map: Optional[Dict[str, int]] = None
    size_hw: tuple = (1520, 912)
    mean: float = T.VINDR_MEAN
    std: float = T.VINDR_STD
    max_boxes: int = 16
    # train=True: the reference's box-aware imgaug pipeline (Fliplr/Flipud 0.5, Affine
    # with shear 20, ElasticTransformation) before the min-max/mean-std normalization
    # (`Datasets/dataset_utils.py:64-71`, `dataset_concepts.py:313-331`)
    train: bool = False
    seed: int = 0

    def __post_init__(self):
        self.groups = list(self.df.groupby(self.image_col, sort=False))
        if self.class_map is None:
            names = sorted(self.df[self.class_col].dropna().unique())
            self.class_map = {n: i for i, n in enumerate(names)}
        self.image_shape = (self.size_hw[0], self.size_hw[1], 1)
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.groups)

    def __getitem__(self, i: int):
        path, rows = self.groups[i]
        arr = T.load_image(os.path.join(self.root, str(path)), grayscale=True)
        src_h, src_w = arr.shape[:2]
        sy = self.size_hw[0] / src_h
        sx = self.size_hw[1] / src_w
        xy, cls = [], []
        for _, r in rows.iterrows():
            if len(xy) >= self.max_boxes:
                break
            vals = [r.get(c) for c in self.box_cols]
            if any(v is None or (isinstance(v, float) and np.isnan(v)) for v in vals):
                continue
            x1, y1, x2, y2 = vals
            xy.append([x1 * sx, y1 * sy, x2 * sx, y2 * sy])
            cls.append(float(self.class_map.get(r.get(self.class_col), -1)))

        if self.train:
            arr = T.resize(arr, self.size_hw)
            arr, xy_t = T.augment_detection(
                arr, np.asarray(xy, np.float32).reshape(-1, 4), self._rng)
            xy = xy_t.tolist()
            img = T.minmax_meanstd(arr, self.mean, self.std).astype(np.float32)
        else:
            img = T.gray_resize_normalize(arr, self.size_hw, self.mean, self.std)

        boxes = np.full((self.max_boxes, 5), -1.0, np.float32)
        for n, (b, c) in enumerate(zip(xy, cls)):
            boxes[n] = [*b, c]
        return {"image": img, "boxes": boxes, "n_boxes": len(xy), "img_path": str(path)}


def collate_detection(items: List[Dict]) -> Dict[str, np.ndarray]:
    """One-shape batch: images [B, H, W, 1], boxes [B, max_boxes, 5] (-1 padded),
    n_boxes [B] int32, numpy arrays as the classifier batches (the reference pads to
    the batch's most boxes instead, `dataset_concepts.py:230-252`)."""
    return {
        "images": np.stack([it["image"] for it in items]),
        "boxes": np.stack([it["boxes"] for it in items]),
        "n_boxes": np.asarray([it["n_boxes"] for it in items], np.int32),
    }


def draw_boxes(image: np.ndarray, boxes: np.ndarray, value: float = 1.0,
               thickness: int = 3) -> np.ndarray:
    """Burn box outlines into a copy of an HW(C) image (what `plot_image_with_boxes`
    shows, without matplotlib)."""
    out = np.array(image, copy=True)
    h, w = out.shape[:2]
    for b in boxes:
        if b[0] < 0:
            continue
        x1, y1, x2, y2 = (int(np.clip(v, 0, lim - 1)) for v, lim in
                          zip(b[:4], (w, h, w, h)))
        t = thickness
        out[y1:y1 + t, x1:x2] = value
        out[max(y2 - t, 0):y2, x1:x2] = value
        out[y1:y2, x1:x1 + t] = value
        out[y1:y2, max(x2 - t, 0):x2] = value
    return out


# the label column of each concept spelling (the reference `MammoDataset_concept`'s
# 14-way switch, `dataset_concepts.py:405-446`; the aligner-bin concepts
# clip_v1/mark_v1/mole_v1/scar_v1 select the upper-cased bin columns of the aligner
# CSVs). The aliases calcification, scar, density, birads and cancer are the JAX
# package's additions.
CONCEPT_COLUMNS = {
    "mass": "Mass",
    "suspicious_calcification": "Suspicious_Calcification",
    "calcification": "Suspicious_Calcification",
    "focal_asymmetry": "Focal_Asymmetry",
    "architectural_distortion": "Architectural_Distortion",
    "suspicious_lymph_node": "Suspicious_Lymph_Node",
    "skin_thickening": "Skin_Thickening",
    "skin_retraction": "Skin_Retraction",
    "nipple_retraction": "Nipple_Retraction",
    "global_asymmetry": "Global_Asymmetry",
    "asymmetry": "Asymmetry",
    "clip_v1": "CLIP_V1",
    "mark_v1": "MARK_V1",
    "mole_v1": "MOLE_V1",
    "scar_v1": "SCAR_V1",
    "density": "density",
    "birads": "breast_birads",
    "cancer": "cancer",
    "scar": "SCAR",
}


def concept_dataset(df, concept: str, **kw):
    """The port's ClassifierDataset over a named concept's label column (the
    `MammoDataset_concept` capability)."""
    from mammodissect_torch.train.data import ClassifierDataset

    col = CONCEPT_COLUMNS.get(concept.lower(), concept)
    if col not in df.columns:
        raise KeyError(f"concept column {col!r} not in CSV (concept {concept!r})")
    return ClassifierDataset(df, label_col=col, **kw)
