"""CLIP-pretraining image-text datasets (a copy of `mammodissect/data/imagetext.py`;
the reference's `data/dataset/` family) around one batch contract.

- `ImageTextDataset`: multi-view CC/MLO sampling (`imagetext.py:73-108`), the report
  text from report lists or generated from finding labels through prompt templates
  (`:200-210`), an optional second image view, min-max + mean/std (`:129-138`), and
  `batches`, the collate that tokenizes both texts (`:217-237`).
- `GroupedImageTextDataset`: one item per (patient, laterality) group, report
  sentences segmented (`segment_report`).
- `ContrastiveSentenceDataset`, `RetrievalDataset`, `ImageAlignerDataset`, and
  `load_dataset`, the factory of `data/dataset/__init__.py:11-26` (the
  `image_classification` type is `train/data.py`'s dataset, `image_classification_zs`
  the `CsvProbe` probe).

Grayscale HWC numpy throughout. Randomness flows through per-dataset numpy
Generators, the same draws as the JAX package's, so the same seed gives the same
bytes on the `f32` and `u8` wires (`data/transforms.py::load_for_wire`)."""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from mammodissect_torch.data import transforms as T
from mammodissect_torch.data.prompts import generate_report_from_labels


def _aslist(cell) -> List[str]:
    if isinstance(cell, (list, tuple)):
        return list(cell)
    if isinstance(cell, str):
        try:
            v = ast.literal_eval(cell)
            return list(v) if isinstance(v, (list, tuple)) else [cell]
        except (ValueError, SyntaxError):
            return [cell]
    return [cell]


@dataclass
class ImageTextDataset:
    """Multi-view mammogram + report dataset for contrastive pretraining."""

    df: "pandas.DataFrame"
    root: str = ""
    img_dir: str = ""
    dataset: str = "vindr"  # path layout: vindr = root/img_dir/{patient}/{image}
    split: str = "train"
    size_hw: tuple = (1520, 912)
    mean: float = T.VINDR_MEAN
    std: float = T.VINDR_STD
    prompt_json: Optional[Dict] = None  # generate text from *_FINDING labels
    image_view_aug: bool = True  # emit a second image view
    seed: int = 0
    # 'u8': ship post-transform uint8 images (1 B/px wire; the pretrain loop
    # normalizes on device) — the reference's own contract keeps images uint8
    # through the transforms (see ops/normalize.py)
    wire: str = "f32"

    def __post_init__(self):
        if self.wire not in ("f32", "u8"):
            raise ValueError(f"wire must be 'f32' or 'u8', got {self.wire!r}")
        self._rng = np.random.default_rng(self.seed)
        self.image_shape = (self.size_hw[0], self.size_hw[1], 1)

    def __len__(self):
        return len(self.df)

    def _img_path(self, patient_id, image_id) -> str:
        if self.dataset.lower() == "upmc":
            return os.path.join(self.root, self.img_dir, f"Patient_{patient_id}", image_id)
        return os.path.join(self.root, self.img_dir, str(patient_id), image_id)

    def _load(self, path: str, train: bool) -> np.ndarray:
        return T.load_for_wire(path, self.size_hw, self.mean, self.std,
                               train, self.wire, self._rng)

    def __getitem__(self, index: int) -> Dict:
        row = self.df.iloc[index]
        train = self.split == "train"

        # ---- view selection (`imagetext.py:73-108`): sample 2 views when available
        views = _aslist(row["view"]) if "view" in row else ["image"]
        if len(views) >= 2:
            if train:
                pick = self._rng.choice(len(views), size=2, replace=False)
                views = [views[i] for i in pick]
            else:  # eval is deterministic: first two views, like the path pick below
                views = views[:2]
        paths = []
        for v in views:
            cands = _aslist(row[v]) if v in row else _aslist(row.get("image"))
            paths.append(cands[int(self._rng.integers(len(cands))) if train else 0])

        patient = str(row.get("patient_id", ""))
        image = self._load(self._img_path(patient, paths[0]), train)
        image_view = None
        if self.image_view_aug:
            src = paths[1] if len(paths) > 1 else paths[0]
            image_view = self._load(self._img_path(patient, src), train)

        # ---- text (`imagetext.py:166-210`): report columns or generated from labels
        text, text2 = self._texts(row, views, train)
        return {"image": image, "image_view": image_view, "text": text, "text2": text2}

    def _texts(self, row, views, train):
        if "REPORT" in row or "report" in row:
            report = _aslist(row.get("REPORT", row.get("report")))
            if train and len(report) > 1:
                pick = self._rng.choice(len(report), size=2, replace=True)
                return report[int(pick[0])], report[int(pick[1])]
            return report[0], report[-1]
        finding_cols = [f"{v}_FINDING" for v in views if f"{v}_FINDING" in row]
        if finding_cols and self.prompt_json:
            texts = [
                generate_report_from_labels(
                    _aslist_nested(row[c]), self.prompt_json,
                    deterministic=not train, rng=self._rng,
                )
                for c in finding_cols
            ]
            if len(texts) == 1:
                texts.append(texts[0])
            return texts[0], texts[1]
        raise AttributeError("DataFrame has neither REPORT nor *_FINDING columns")

    def batches(self, tokenizer, batch_size: int, max_length: int = 256,
                shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                host_index: int = 0, host_count: int = 1):
        """Collated contrastive batches (`imagetext.py:217-237` collate_fn):
        {'images', 'image_views', 'input_ids', 'attention_mask', 'input_ids2',
        'attention_mask2'} — static shapes, NHWC.

        Several processes: `batch_size` is the global contrastive batch; every
        process walks the same seeded order and materializes only its
        batch_size/host_count slice of each batch, in lockstep (the in-batch arange
        labels come from the assembled global batch)."""
        n = len(self)
        order = (np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n))
        for start in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size and drop_last:
                return
            if host_count > 1:
                if batch_size % host_count:
                    raise ValueError(
                        f"global batch_size {batch_size} must divide evenly over "
                        f"{host_count} hosts (the global contrastive batch "
                        "assembles from equal per-host slices)")
                if len(idx) < batch_size:  # drop_last=False tail: wrap-pad so
                    idx = np.resize(idx, batch_size)  # every host stays lockstep
                lbs = batch_size // host_count
                idx = idx[host_index * lbs : (host_index + 1) * lbs]
            items = [self[int(i)] for i in idx]
            batch = {
                "images": np.stack([it["image"] for it in items]),
                "texts": [it["text"] for it in items],
                "texts2": [it["text2"] for it in items],
            }
            t1 = tokenizer([it["text"] for it in items], max_length=max_length)
            batch["input_ids"] = t1["input_ids"]
            batch["attention_mask"] = t1["attention_mask"]
            t2 = tokenizer([it["text2"] for it in items], max_length=max_length)
            batch["input_ids2"] = t2["input_ids"]
            batch["attention_mask2"] = t2["attention_mask"]
            if self.image_view_aug:
                batch["image_views"] = np.stack([it["image_view"] for it in items])
            yield batch


def _aslist_nested(cell):
    """FINDING cells are 4-element nested lists [[pos_r], [pos_l], [neg_r], [neg_l]]."""
    v = _aslist(cell)
    if len(v) == 4 and all(isinstance(x, (list, tuple)) for x in v):
        return v
    if isinstance(cell, str):
        try:  # plain-string cells (e.g. a bare finding word) are not literals
            return ast.literal_eval(cell)
        except (ValueError, SyntaxError):
            return v
    return v


_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+|\n+")


def segment_report(text: str, min_words: int = 2) -> List[str]:
    """Split a free-text report into cleaned sentence segments (the capability of
    `imagetext_zz.py:69-94`'s nltk cleaning, regex-based — no nltk dependency):
    sentence split, whitespace collapse, drop fragments shorter than `min_words`."""
    segments = []
    for seg in _SENT_SPLIT.split(str(text)):
        seg = " ".join(seg.split()).strip()
        if len(seg.split()) >= min_words:
            segments.append(seg)
    return segments


class GroupedImageTextDataset(ImageTextDataset):
    """(patient, laterality)-grouped variant (`imagetext_zz.py`): one item per group,
    images sampled from the group's CC+MLO pair, report sentences segmented."""

    def __init__(self, df, group_cols=("patient_id", "laterality"), **kw):
        groups = []
        for _, grp in df.groupby(list(group_cols), sort=False):
            groups.append(grp.iloc[0])  # rows within a group share view columns
        import pandas as pd

        super().__init__(pd.DataFrame(groups).reset_index(drop=True), **kw)

    def _texts(self, row, views, train):
        if "REPORT" in row or "report" in row:
            sentences = []
            for r in _aslist(row.get("REPORT", row.get("report"))):
                sentences.extend(segment_report(r))
            if not sentences:
                sentences = [""]
            if train and len(sentences) > 1:
                pick = self._rng.choice(len(sentences), size=2, replace=True)
                return sentences[int(pick[0])], sentences[int(pick[1])]
            return sentences[0], sentences[-1]
        return super()._texts(row, views, train)


@dataclass
class ContrastiveSentenceDataset:
    """ConVIRT-style: image + one randomly sampled report sentence + label
    (`imagetext_contrastive.py:86-95`)."""

    df: "pandas.DataFrame"
    root: str = ""
    label_col: str = "BIRADS"
    size_hw: tuple = (1520, 912)
    mean: float = T.VINDR_MEAN
    std: float = T.VINDR_STD
    split: str = "train"
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.image_shape = (self.size_hw[0], self.size_hw[1], 1)

    def __len__(self):
        return len(self.df)

    def __getitem__(self, i):
        row = self.df.iloc[i]
        arr = T.load_image(os.path.join(self.root, str(row["image_path"])), grayscale=True)
        arr = T.resize(arr, self.size_hw)
        arr = T.minmax_meanstd(arr, self.mean, self.std).astype(np.float32)
        sentences = _aslist(row.get("REPORT", row.get("report", "")))
        if self.split == "train" and len(sentences) > 1:
            text = sentences[int(self._rng.integers(len(sentences)))]
        else:
            text = sentences[0]
        return {"image": arr, "text": text, "label": row.get(self.label_col)}


@dataclass
class ImageAlignerDataset:
    """Paired clip/classifier images + rich metadata passthrough
    (reference `data/dataset/image_aligner.py:82-114`: age, concept-threshold columns
    at 0.1/0.15/0.25, CLIP/SCAR/MARK/MOLE bins). Metadata columns are returned as-is
    in the item dict."""

    df: "pandas.DataFrame"
    root: str = ""
    clip_image_col: str = "clip_image_path"
    clf_image_col: str = "clf_image_path"
    metadata_cols: tuple = ()
    size_hw: tuple = (1520, 912)
    mean: float = T.VINDR_MEAN
    std: float = T.VINDR_STD

    def __post_init__(self):
        self.image_shape = (self.size_hw[0], self.size_hw[1], 1)
        if not self.metadata_cols:
            skip = {self.clip_image_col, self.clf_image_col}
            self.metadata_cols = tuple(c for c in self.df.columns if c not in skip)

    def __len__(self):
        return len(self.df)

    def __getitem__(self, i):
        row = self.df.iloc[i]

        def load(col):
            arr = T.load_image(os.path.join(self.root, str(row[col])), grayscale=True)
            return T.gray_resize_normalize(arr, self.size_hw, self.mean, self.std)

        item = {"clip_image": load(self.clip_image_col),
                "clf_image": load(self.clf_image_col)}
        item.update({c: row[c] for c in self.metadata_cols})
        return item


@dataclass
class RetrievalDataset:
    """Image + text-label tokens for retrieval eval (`imagetext_retrieval.py`)."""

    df: "pandas.DataFrame"
    root: str = ""
    text_col: str = "label_text"
    size_hw: tuple = (1520, 912)
    mean: float = T.VINDR_MEAN
    std: float = T.VINDR_STD

    def __post_init__(self):
        self.image_shape = (self.size_hw[0], self.size_hw[1], 1)

    def __len__(self):
        return len(self.df)

    def __getitem__(self, i):
        row = self.df.iloc[i]
        arr = T.load_image(os.path.join(self.root, str(row["image_path"])), grayscale=True)
        arr = T.resize(arr, self.size_hw)
        arr = T.minmax_meanstd(arr, self.mean, self.std).astype(np.float32)
        return {"image": arr, "text": str(row[self.text_col])}


DATASET_TYPES = {
    "imagetext": ImageTextDataset,
    "imagetext_zz": GroupedImageTextDataset,
    "imagetext_contrastive": ContrastiveSentenceDataset,
    "imagetext_retrieval": RetrievalDataset,
    "image_aligner": ImageAlignerDataset,
}


def load_dataset(data_type: str, **kw):
    """Factory mirroring `data/dataset/__init__.py:load_dataset(:11-26)`; the
    image_classification / image_classification_zs types live in train.data /
    data.probes (which takes only the kwargs listed, as in the JAX package)."""
    if data_type in DATASET_TYPES:
        return DATASET_TYPES[data_type](**kw)
    if data_type == "image_classification":
        from mammodissect_torch.train.data import ClassifierDataset

        return ClassifierDataset(**kw)
    if data_type == "image_classification_zs":
        from mammodissect_torch.data.probes import CsvProbe

        allowed = ("csv_file", "df", "image_col", "root", "label_col", "split_col",
                   "split", "size_hw", "mean", "std", "filters")
        unknown = sorted(k for k in kw if k not in allowed)
        if unknown:
            raise TypeError(
                f"image_classification_zs got unsupported kwargs {unknown}; "
                f"accepted: {sorted(allowed)}")
        return CsvProbe(**kw)
    raise KeyError(f"unknown data_type {data_type!r}")
