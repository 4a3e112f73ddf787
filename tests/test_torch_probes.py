"""Probe datasets of the PyTorch port (a copy of the part of `mammodissect/data/probes.py`
the resident path needs) against the JAX package's on the same files and seeds."""
import numpy as np
import pandas as pd
import pytest
from PIL import Image

import mammodissect.data.probes as J
import mammodissect.data.transforms as JT
import mammodissect_torch.data.probes as P
import mammodissect_torch.data.transforms as T
from tests._jax_native import jax_native  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(40, 30), (25, 33), (40, 30)]):
        sub = root / f"class{i % 2}"
        sub.mkdir(exist_ok=True)
        p = sub / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(h, w), dtype=np.uint8)).save(p)
        paths.append(str(p.relative_to(root)))
    pd.DataFrame({"image_path": paths, "label": [0, 1, 0]}).to_csv(root / "probe.csv",
                                                                   index=False)
    return root


def test_csv_probe_matches_jax(image_dir, jax_native):
    kw = dict(root=str(image_dir), size_hw=(20, 16), label_col="label")
    jp = J.CsvProbe(str(image_dir / "probe.csv"), **kw)
    pp = P.get_probe(f"csv:{image_dir / 'probe.csv'}", **kw)
    assert len(pp) == len(jp) == 3 and pp.image_shape == jp.image_shape == (20, 16, 1)
    for i in range(3):
        np.testing.assert_array_equal(pp.image_u8(i), jp.image_u8(i))
        # float images resize natively in both packages; the PIL fallback (no g++)
        # is held to the JAX package's
        np.testing.assert_allclose(pp.image(i), jp.image(i), rtol=1e-6, atol=1e-6)
        arr = JT.load_image(str(image_dir / jp.df.iloc[i]["image_path"]), grayscale=True)
        want = JT.gray_resize_normalize(arr, (20, 16), jp.mean, jp.std, prefer_native=False)
        got = T.gray_resize_normalize(arr, (20, 16), jp.mean, jp.std, prefer_native=False)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert pp.label(i) == jp.label(i)


@pytest.mark.parametrize("shape", [(24, 20, 1), (24, 20, 3)])
def test_folder_probe_matches_jax(image_dir, shape):
    jp = J.get_probe(f"folder:{image_dir}", image_shape=shape)
    pp = P.get_probe(f"folder:{image_dir}", image_shape=shape)
    assert len(pp) == len(jp) == 3
    for i in range(3):
        np.testing.assert_allclose(pp.image(i), jp.image(i), rtol=1e-6, atol=1e-6)
        assert pp.label(i) == jp.label(i)


@pytest.mark.parametrize("spec", ["synthetic", "synthetic_u8"])
def test_synthetic_probes_match_jax(spec):
    kw = dict(n=5, h=12, w=9, seed=3)
    jp, pp = J.get_probe(spec, **kw), P.get_probe(spec, **kw)
    np.testing.assert_array_equal(pp.images, jp.images)
    assert (pp.mean, pp.std) == (jp.mean, jp.std)
    for i in range(5):
        np.testing.assert_array_equal(pp.image(i), jp.image(i))


@pytest.mark.parametrize("shape", [(224, 224, 3), (24, 20, 1)])
def test_txt_list_probe_matches_jax(image_dir, tmp_path, shape):
    """`path label` lines (a missing label reads -1, blank lines are skipped); the
    ImageNet eval pipeline at 224x224x3, the folder preprocessing otherwise."""
    listing = tmp_path / "list.txt"
    listing.write_text("class0/img0.png 4\nclass1/img1.png\n\nclass0/img2.png 7\n")
    jp = J.get_probe(f"txt:{listing}", root=str(image_dir), image_shape=shape)
    pp = P.get_probe(f"txt:{listing}", root=str(image_dir), image_shape=shape)
    assert len(pp) == len(jp) == 3 and pp.image_shape == jp.image_shape == shape
    for i in range(3):
        np.testing.assert_allclose(pp.image(i), jp.image(i), rtol=1e-6, atol=1e-6)
        assert pp.label(i) == jp.label(i)
    assert [pp.label(i) for i in range(3)] == [4, -1, 7]


def test_combined_probe_matches_jax():
    kw = dict(n=4, h=6, w=5, seed=2)
    jp, pp = J.get_probe("combined:synthetic+synthetic_u8", **kw), \
        P.get_probe("combined:synthetic+synthetic_u8", **kw)
    assert len(pp) == len(jp) == 8
    for i in range(8):
        np.testing.assert_array_equal(pp.image(i), jp.image(i))
        assert pp.label(i) == jp.label(i)
    with pytest.raises(ValueError, match="image_shape"):
        P.ConcatProbe([P.synthetic_probe(h=4), P.synthetic_probe(h=5)])


def test_unknown_probe_raises():
    for pkg in (J, P):
        with pytest.raises(KeyError):
            pkg.get_probe("imagenet_broden")
