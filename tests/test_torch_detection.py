"""The port's concept-detection dataset and the transforms it adds, against the JAX
package's: the cases of `tests/test_datamodule_vit_detection.py::TestDetection` and
`::TestConceptSpellings` through both packages (items, collate and `draw_boxes`
equal), `augment_detection` from one seed within 1e-5 of JAX's image with the boxes
exact, `transform_boxes_affine` exact, `vindr_preprocess` and `clip_preprocess`
within 1e-5."""
import numpy as np
import pandas as pd
import pytest
from PIL import Image

import mammodissect.data.transforms as JT
import mammodissect.train.detection_data as jdd
import mammodissect_torch.data.transforms as TT
import mammodissect_torch.train.detection_data as tdd
from tests._jax_native import jax_native  # noqa: F401  (a fixture)

TOL = dict(rtol=1e-5, atol=1e-5)

REFERENCE_SPELLINGS = {
    "clip_v1": "CLIP_V1", "mark_v1": "MARK_V1", "mole_v1": "MOLE_V1", "scar_v1": "SCAR_V1",
    "architectural_distortion": "Architectural_Distortion", "asymmetry": "Asymmetry",
    "focal_asymmetry": "Focal_Asymmetry", "global_asymmetry": "Global_Asymmetry",
    "mass": "Mass", "nipple_retraction": "Nipple_Retraction",
    "skin_retraction": "Skin_Retraction", "skin_thickening": "Skin_Thickening",
    "suspicious_calcification": "Suspicious_Calcification",
    "suspicious_lymph_node": "Suspicious_Lymph_Node",
}


@pytest.fixture(scope="module")
def img_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        Image.fromarray((rng.random((40, 30)) * 255).astype("uint8")).save(root / f"i{i}.png")
        rows.append({"image_path": f"i{i}.png", "cancer": i % 2})
    return str(root), pd.DataFrame(rows)


DET_ROWS = [
    {"image_path": "i0.png", "xmin": 2, "ymin": 3, "xmax": 20, "ymax": 25, "finding": "Mass"},
    {"image_path": "i0.png", "xmin": 5, "ymin": 5, "xmax": 10, "ymax": 10, "finding": "Calc"},
    {"image_path": "i1.png", "xmin": 1, "ymin": 1, "xmax": 15, "ymax": 18, "finding": "Mass"},
    {"image_path": "i2.png", "xmin": np.nan, "ymin": 1, "xmax": 15, "ymax": 18,
     "finding": "Mass"},
]


def _assert_items_equal(got, want, image_tol=None):
    assert set(got) == set(want)
    assert got["n_boxes"] == want["n_boxes"] and got["img_path"] == want["img_path"]
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    assert got["image"].dtype == want["image"].dtype
    if image_tol:
        np.testing.assert_allclose(got["image"], want["image"], **image_tol)
    else:
        np.testing.assert_array_equal(got["image"], want["image"])


def test_dataset_collate_and_draw_equal(img_csv, jax_native):
    root, _ = img_csv
    det = pd.DataFrame(DET_ROWS)
    kw = dict(root=root, size_hw=(40, 30), max_boxes=4)
    want, got = jdd.DetectionDataset(det, **kw), tdd.DetectionDataset(det, **kw)
    assert len(got) == len(want) == 3 and got.class_map == want.class_map
    items = [got[i] for i in range(len(got))]
    for i, item in enumerate(items):
        _assert_items_equal(item, want[i], TOL)
    assert items[0]["n_boxes"] == 2 and (items[0]["boxes"][2:] == -1).all()
    assert items[2]["n_boxes"] == 0  # the NaN box is skipped
    batch, jbatch = tdd.collate_detection(items), jdd.collate_detection(
        [want[i] for i in range(len(want))])
    assert {k: (v.shape, v.dtype) for k, v in batch.items()} == \
        {k: (v.shape, v.dtype) for k, v in jbatch.items()}
    assert batch["images"].shape == (3, 40, 30, 1) and batch["boxes"].shape == (3, 4, 5)
    np.testing.assert_array_equal(batch["boxes"], jbatch["boxes"])
    np.testing.assert_array_equal(batch["n_boxes"], jbatch["n_boxes"])
    for thickness in (1, 3):
        drawn = tdd.draw_boxes(items[0]["image"], items[0]["boxes"], 9.0, thickness)
        np.testing.assert_array_equal(
            drawn, jdd.draw_boxes(items[0]["image"], items[0]["boxes"], 9.0, thickness))
        assert (drawn == 9.0).sum() > 0 and (items[0]["image"] == 9.0).sum() == 0


def test_train_items_follow_the_jax_draws(img_csv):
    root, _ = img_csv
    det = pd.DataFrame(DET_ROWS)
    kw = dict(root=root, size_hw=(48, 32), max_boxes=3, train=True, seed=5)
    want, got = jdd.DetectionDataset(det, **kw), tdd.DetectionDataset(det, **kw)
    for _ in range(2):  # the generator advances across items and epochs alike
        for i in range(len(got)):
            _assert_items_equal(got[i], want[i], TOL)


@pytest.mark.parametrize("seed,n_boxes", [(0, 2), (1, 0), (2, 2), (3, 1)])
def test_augment_detection_same_image_and_boxes(seed, n_boxes):
    rng = np.random.default_rng(100 + seed)
    arr = rng.random((36, 28, 1)).astype(np.float32)
    boxes = np.array([[2, 3, 20, 25], [5, 5, 10, 10]], np.float32)[:n_boxes]
    got_img, got_boxes = TT.augment_detection(arr, boxes, np.random.default_rng(seed))
    want_img, want_boxes = JT.augment_detection(arr, boxes, np.random.default_rng(seed))
    np.testing.assert_allclose(got_img, want_img, **TOL)
    np.testing.assert_array_equal(got_boxes, want_boxes)
    assert got_boxes.shape == (len(boxes), 4)


def test_transform_boxes_affine_exact():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, (5, 2, 2)).astype(np.float32)
    boxes = np.concatenate([xy.min(axis=1), xy.max(axis=1)], axis=1)  # x1 <= x2, y1 <= y2
    for args in [(0, 0, 0, 1, 0), (15, 3, -2, 1.1, 10), (-20, -5, 4, 0.8, -20)]:
        fwd = TT.affine_matrix(*args, cx=25.0, cy=20.0)
        np.testing.assert_array_equal(fwd, JT.affine_matrix(*args, cx=25.0, cy=20.0))
        np.testing.assert_array_equal(TT.transform_boxes_affine(boxes, fwd),
                                      JT.transform_boxes_affine(boxes, fwd))
    empty = TT.transform_boxes_affine(np.zeros((0, 4)), np.eye(3))
    assert empty.shape == (0, 4)
    ident = TT.transform_boxes_affine(boxes, TT.affine_matrix(0, 0, 0, 1, 0, 25.0, 20.0))
    np.testing.assert_allclose(ident, boxes, atol=1e-5)


def test_vindr_and_clip_preprocess_equal():
    rng = np.random.default_rng(4)
    gray = rng.random((61, 45, 1)).astype(np.float32)
    rgb = rng.random((50, 70, 3)).astype(np.float32)
    for arr in (gray, rgb):
        got = TT.vindr_preprocess(arr, (40, 24))
        assert got.shape == (40, 24, 1) and got.dtype == np.float32
        np.testing.assert_allclose(got, JT.vindr_preprocess(arr, (40, 24)), **TOL)
        for size in (32, 224):
            got = TT.clip_preprocess(arr, size)
            assert got.shape == (size, size, 3) and got.dtype == np.float32
            np.testing.assert_allclose(got, JT.clip_preprocess(arr, size), **TOL)
    for method in ("bilinear", "bicubic"):
        np.testing.assert_array_equal(TT.resize(rgb, (33, 41), method=method),
                                      JT.resize(rgb, (33, 41), method=method))
    np.testing.assert_array_equal(TT.CLIP_MEAN, JT.CLIP_MEAN)
    np.testing.assert_array_equal(TT.CLIP_STD, JT.CLIP_STD)


def test_concept_dataset_column_switch(img_csv, jax_native):
    root, df = img_csv
    df = df.assign(Mass=1)
    ds = tdd.concept_dataset(df, "mass", root=root, size_hw=(40, 30))
    assert ds.label(0) == 1 and type(ds).__module__ == "mammodissect_torch.train.data"
    np.testing.assert_allclose(
        ds.image(0), jdd.concept_dataset(df, "mass", root=root, size_hw=(40, 30)).image(0),
        **TOL)
    with pytest.raises(KeyError):
        tdd.concept_dataset(df, "calcification", root=root)


def test_every_reference_spelling_resolves(img_csv):
    root, df = img_csv
    assert tdd.CONCEPT_COLUMNS == jdd.CONCEPT_COLUMNS
    for concept, col in REFERENCE_SPELLINGS.items():
        assert tdd.CONCEPT_COLUMNS.get(concept) == col, concept
        ds = tdd.concept_dataset(df.assign(**{col: 1}), concept.upper(), root=root,
                                 size_hw=(40, 30))
        assert ds.label(0) == 1, concept
