"""The reference's named mammography probes in the PyTorch port against the JAX
package's, on a tiny metadata CSV with `Marker`, `Implant_type` and `split` columns:
each name selects the same rows in the same order and gives the same pixels. And
the float eval resize (fault F1 of the roadmap): `CsvProbe.image` and the fine-tune
loader's f32 eval wire follow the JAX package's default, the native cv2-style
resize, within 1e-5 on a noise image shrunk more than 2x, while the uint8 paths
keep PIL's bytes."""
import numpy as np
import pandas as pd
import pytest
from PIL import Image

import mammodissect.data.probes as J
import mammodissect.data.transforms as JT
import mammodissect_torch.data.probes as P
import mammodissect_torch.data.transforms as PT
from mammodissect_torch import native

NAMES = ["vindr", "csaw", "csaw_all_splits", "embed_png", "embed_marker_84",
         "embed_marker_only", "embed_implant", "embed_non_implant", "embed_non_implant_100"]
SIZE = (48, 32)


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    """Ten grayscale noise PNGs of varied sizes and their metadata CSV."""
    root = tmp_path_factory.mktemp("named")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(10):
        h, w = (120 + 7 * i, 80 + 5 * i) if i % 3 else (30, 20)
        name = f"p{i}/img{i}.png"
        (root / f"p{i}").mkdir()
        Image.fromarray(rng.integers(0, 256, size=(h, w), dtype=np.uint8)).save(root / name)
        rows.append({"image_path": name, "Marker": int(i % 2 == 0), "Implant_type": int(i % 4 == 1),
                     "split": ("training", "test", "validation")[i % 3], "Mass": i % 2})
    pd.DataFrame(rows).to_csv(root / "meta.csv", index=False)
    return root


@pytest.mark.parametrize("name", NAMES)
def test_named_probe_matches_jax(metadata, name):
    kw = dict(csv_file=str(metadata / "meta.csv"), root=str(metadata))
    jp, pp = J.get_probe(name, **kw), P.get_probe(name, **kw)
    pd.testing.assert_frame_equal(pp.df, jp.df)
    assert 0 < len(pp) < 10 or name in ("vindr", "csaw_all_splits", "embed_png")
    assert pp.image_shape == jp.image_shape == (1520, 912, 1)
    for i in (0, len(pp) - 1):
        np.testing.assert_array_equal(pp.image_u8(i), jp.image_u8(i))
        np.testing.assert_allclose(pp.image(i), jp.image(i), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,kw,rows", [
    ("csaw", {"split": "test"}, [1, 4, 7]),
    ("csaw", {}, [0, 3, 6, 9]),
    ("embed_marker_only", {}, [0, 2, 4, 6, 8]),
    ("embed_implant", {}, [1, 5, 9]),
    ("embed_non_implant", {"filters": {"Marker": 0, "Implant_type": 0}}, [3, 7]),
])
def test_named_probe_rows(metadata, name, kw, rows):
    """The `split` of csaw (default "training") and the EMBED filters select these
    rows, in the CSV's order, in both packages."""
    kw = dict(csv_file=str(metadata / "meta.csv"), root=str(metadata), **kw)
    want = [f"p{i}/img{i}.png" for i in rows]
    assert list(P.get_probe(name, **kw).df["image_path"]) == want
    assert list(J.get_probe(name, **kw).df["image_path"]) == want


def test_named_probe_needs_a_csv_file():
    for name in NAMES:
        for get_probe in (J.get_probe, P.get_probe):
            with pytest.raises(ValueError, match="csv_file"):
                get_probe(name, root="/data")
    assert set(NAMES) <= set(P.PROBES)


def test_float_eval_resize_follows_the_jax_default(metadata):
    """Fault F1: the float eval path resizes natively (no antialiasing), as the JAX
    package does by default; PIL's antialiased bilinear differs on a shrink."""
    assert native.available(), "g++ could not build the native library"
    csv = str(metadata / "meta.csv")
    jp = J.CsvProbe(csv, root=str(metadata), size_hw=SIZE)
    pp = P.get_probe(f"csv:{csv}", root=str(metadata), size_hw=SIZE)
    i = 8  # 176x120 -> 48x32: shrunk more than 2x on each axis
    path = str(metadata / jp.df.iloc[i]["image_path"])
    arr = JT.load_image(path, grayscale=True)
    assert arr.shape[0] >= 2 * SIZE[0] and arr.shape[1] >= 2 * SIZE[1]
    want = JT.gray_resize_normalize(arr, SIZE, jp.mean, jp.std)  # the JAX default
    np.testing.assert_allclose(pp.image(i), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pp.image(i), jp.image(i), rtol=0, atol=1e-5)
    rng = np.random.default_rng(0)
    for loader in (JT.load_for_wire, PT.load_for_wire):
        got = loader(path, SIZE, jp.mean, jp.std, train=False, wire="f32", rng=rng)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pil = PT.gray_resize_normalize(arr, SIZE, jp.mean, jp.std, prefer_native=False)
    assert np.abs(pil - want).max() > 1e-2  # the two resizes differ here
    np.testing.assert_allclose(pil, JT.gray_resize_normalize(arr, SIZE, jp.mean, jp.std,
                                                              prefer_native=False),
                               rtol=0, atol=1e-5)
    # the uint8 paths keep PIL's bytes in both packages
    np.testing.assert_array_equal(pp.image_u8(i), jp.image_u8(i))
    np.testing.assert_array_equal(
        PT.load_for_wire(path, SIZE, 0.3, 0.25, train=False, wire="u8", rng=rng),
        JT.load_for_wire(path, SIZE, 0.3, 0.25, train=False, wire="u8", rng=rng))
