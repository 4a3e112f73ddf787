"""The packed uint8 wire of the PyTorch port (`mammodissect_torch/dissect/packing.py`)
against the JAX package's: the same numpy batches through both host packers must give
the same wire bytes, metadata and buckets, and both device unpacks must rebuild the
batch bit for bit. Then the packed resident dissection: equal to the plain wire in the
port, and in agreement with the JAX package's packed run."""
import ast
import json
import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import mammodissect.dissect.packing as J
import mammodissect_torch.dissect.packing as P
from mammodissect_torch import native


def _sparse_images(rng, n, h, w, c=1):
    """Mammogram-shaped batches: zero background, one textured region per image
    attached to the left or right edge."""
    imgs = np.zeros((n, h, w, c), np.uint8)
    for i in range(n):
        hh = rng.integers(h // 3, h + 1)
        ww = rng.integers(w // 4, (2 * w) // 3)
        y0 = rng.integers(0, h - hh + 1)
        x0 = 0 if rng.integers(2) == 0 else w - ww
        imgs[i, y0:y0 + hh, x0:x0 + ww] = rng.integers(1, 256, size=(hh, ww, c), dtype=np.uint8)
    return imgs


def _edges():
    """The unpack's bounds: spans ending at W, the first row starting right of 0, empty
    rows, interior zeros inside a span, an all-zero image, a full row."""
    img = np.zeros((4, 6, 10, 1), np.uint8)
    img[0, 0, 7:10] = 9      # first row, start > 0, span ends at W
    img[0, 1, 0:10] = 3      # full row
    img[0, 3, 2:8, 0] = [0, 5, 0, 7, 0, 0]  # interior and edge zeros: span is 3..5
    img[1, 5, 9] = 1         # last row, last pixel
    img[3, 2:4, 4] = 200     # image 2 stays all zero
    return img


CASES = {
    "sparse": lambda rng: _sparse_images(rng, 6, 37, 29),
    "dense": lambda rng: rng.integers(0, 256, size=(4, 16, 24, 1), dtype=np.uint8),
    "all_zero": lambda rng: np.zeros((2, 8, 8, 1), np.uint8),
    "multichannel": lambda rng: _sparse_images(rng, 4, 20, 18, c=3),
    "edges": lambda rng: _edges(),
}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_unpack_bit_exact_against_jax(case, groups):
    u8 = CASES[case](np.random.default_rng(0))
    cap = u8.size // groups
    quantum = max(cap // 16, 1)
    flat, meta, bucket = P.pack_batch_groups_padded(u8, groups, quantum=quantum, cap=cap)
    jflat, jmeta, jbucket = J.pack_batch_groups_padded(u8, groups, quantum=quantum, cap=cap,
                                                       native=False)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(meta, jmeta)
    assert bucket == jbucket
    got = P.unpack_canvas_groups(torch.from_numpy(flat), torch.from_numpy(meta), u8.shape)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), u8)
    want = jax.jit(lambda f, m: J.unpack_canvas_groups(f, m, u8.shape))(jflat, jmeta)
    np.testing.assert_array_equal(np.asarray(want), u8)
    if groups == 1:  # the one-group form takes the flat payload
        np.testing.assert_array_equal(
            P.unpack_canvas(torch.from_numpy(flat[0]), torch.from_numpy(meta), u8.shape).numpy(), u8)


def test_exact_pack_and_groups_match_jax():
    u8 = _sparse_images(np.random.default_rng(3), 4, 30, 22)
    flat, meta = P.pack_batch(u8)
    jflat, jmeta = J.pack_batch(u8, native=False)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(meta, jmeta)
    assert P.packed_nbytes(meta, 1) == flat.size == J.packed_nbytes(jmeta, 1)
    flats, gmeta = P.pack_batch_groups(u8, 2)
    jflats, _ = J.pack_batch_groups(u8, 2, native=False)
    for a, b in zip(flats, jflats):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gmeta, meta)
    # a padded bucket reads back the same canvas (the bucket tail is ignored)
    padded = P.pad_flat(flat, flat.size + 17)
    got = P.unpack_canvas(torch.from_numpy(padded), torch.from_numpy(meta), u8.shape)
    np.testing.assert_array_equal(got.numpy(), u8)


def test_native_packer_equals_numpy_packer():
    assert native.available(), "g++ could not build the native span packer"
    assert P.native_packer() == "native" and P.native_packer(False) == "numpy"
    rng = np.random.default_rng(5)
    u8 = np.concatenate([_sparse_images(rng, 5, 6, 10, c=3), _edges().repeat(3, axis=-1)])
    spans = [P.row_spans(img) for img in u8]
    for fixed_len in (None, u8.size):
        out = [P.pack_batch_groups_padded(u8, 3, quantum=1000, cap=u8.size // 3,
                                          fixed_len=fixed_len, native=nat)
               for nat in (True, False)]
        out.append(P.pack_batch_groups_padded(u8, 3, spans=spans, quantum=1000,
                                              cap=u8.size // 3, fixed_len=fixed_len))
        for flat, meta, bucket in out[1:]:
            np.testing.assert_array_equal(flat, out[0][0])
            np.testing.assert_array_equal(meta, out[0][1])
            assert bucket == out[0][2]


def test_native_packer_checks_bounds():
    u8 = np.zeros((2, 4, 5, 1), np.uint8)
    start = np.zeros((2, 4), np.int32)
    length = np.full((2, 4), 5, np.int32)
    with pytest.raises(ValueError, match="outside"):
        native.batch_pack(u8, start, length, np.zeros(30, np.uint8), np.array([0, 20]))
    with pytest.raises(ValueError, match="outside"):
        native.batch_pack(u8, start + 1, length, np.zeros(40, np.uint8), np.array([0, 20]))


@pytest.mark.parametrize("args", [(0, 10, 100), (1, 10, 100), (95, 10, 100), (250, 10, 100),
                                  (7, 0, 3), (1 << 40, 1 << 20, 1 << 41)])
def test_bucket_len_matches_jax(args):
    assert P.bucket_len(*args) == J.bucket_len(*args)


class _Probe:
    def __init__(self, images, exact=None):
        self.images, self.exact = images, exact
        self.image_shape = images.shape[1:]
        self.mean, self.std = 0.3, 0.25

    def __len__(self):
        return len(self.images)

    def image_u8(self, i):
        return self.images[i]

    def exact_pack_fraction(self):
        return self.exact


@pytest.mark.parametrize("kind", ["sparse", "dense", "mixed", "exact", "empty"])
def test_sample_pack_fraction_and_auto_match_jax(kind):
    import mammodissect.dissect.engine as JE
    import mammodissect_torch.dissect.engine as PE

    rng = np.random.default_rng(2)
    sparse, dense = _sparse_images(rng, 40, 24, 20), rng.integers(1, 256, (40, 24, 20, 1), np.uint8)
    images = {"sparse": sparse, "dense": dense, "exact": dense, "empty": sparse[:0],
              "mixed": np.stack([sparse, dense], 1).reshape(80, 24, 20, 1)}[kind]
    probe = _Probe(images, exact=0.25 if kind == "exact" else None)
    assert P.sample_pack_fraction(probe) == J.sample_pack_fraction(probe)
    if len(probe):
        for mode in ("auto", "on", "off"):
            assert PE._decide_wire_pack(mode, probe) == JE._decide_wire_pack(mode, probe)


# ---------------------------------------------------------------- packed resident path
SMALL = {"bert_layers": 2, "model_config": {
    "name": "clip_custom", "temperature": 0.07,
    "image_encoder": {"model_type": "cnn", "variant": "efficientnet-test", "in_channels": 1},
    "text_encoder": {"pooling": "eos"},
    "projection_head": {"name": "linear", "proj_dim": 32}}}


@pytest.fixture(scope="module")
def dissectors():
    from mammodissect.dissect.dissectors import get_dissector as jax_get_dissector
    from mammodissect_torch.convert import breastclip_from_jax
    from mammodissect_torch.dissect.dissectors import get_dissector

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy-vocab warning
        jd = jax_get_dissector("breastclip", image_shape=(64, 48, 1), **SMALL)
        pd_ = get_dissector("breastclip", device="cpu", **SMALL)
    pd_.module.load_state_dict(breastclip_from_jax(jax.tree.map(np.array, jd.variables)))
    images = _sparse_images(np.random.default_rng(4), 20, 64, 48)
    images[16:] = images[:4]  # repeated images: exact activation ties
    return images, jd, pd_


def _cfg(cls, tmp_path, tag, **kw):
    return cls(target_model="breastclip", clip_model="breastclip",
               target_layers=[f"blocks.{i}" for i in range(7)], d_probe="synthetic_u8",
               concept_set="tests/assets/tiny_concepts.txt", batch_size=8, num_top_concepts=3,
               num_top_images=4, resident=True, activation_dir=str(tmp_path / tag / "a"),
               result_dir=str(tmp_path / tag / "r"), **kw)


def test_packed_resident_equals_plain_resident(dissectors, tmp_path):
    from mammodissect_torch.data.probes import ArrayProbe
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

    images, _, pd_ = dissectors
    probe = ArrayProbe(images, mean=0.3, std=0.25)
    out = {}
    for wire in ("on", "off"):
        logs, timing = [], []
        cfg = _cfg(DissectConfig, tmp_path, wire, device="cpu", wire_pack=wire)
        out[wire], _ = run_dissection(cfg, probe=probe, dissector=pd_, log=logs.append,
                                      timing=timing)
        packed_logs = [l for l in logs if "packed uint8 wire" in l]
        assert packed_logs == (["[resident] packed uint8 wire (native packer)"]
                               if wire == "on" else []), logs
        raw = 8 * 64 * 48
        sent = [t["wire_bytes"] for t in timing]
        assert len(sent) == 3
        assert all((b < raw) if wire == "on" else (b == raw) for b in sent), sent
    pd.testing.assert_frame_equal(out["on"], out["off"])


def test_resume_key_takes_the_resolved_wire(dissectors, tmp_path):
    """'auto' that resolves to packing resumes the chunks of an 'on' run (and only
    those: the plain wire's chunks carry another key)."""
    from mammodissect_torch.data.probes import ArrayProbe
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

    images, _, pd_ = dissectors
    probe = ArrayProbe(images, mean=0.3, std=0.25)
    first, _ = run_dissection(_cfg(DissectConfig, tmp_path, "w", device="cpu", wire_pack="on"),
                              probe=probe, dissector=pd_, log=lambda *_: None)
    for wire, resumed in (("auto", True), ("off", False)):
        logs = []
        again, _ = run_dissection(_cfg(DissectConfig, tmp_path, "w", device="cpu",
                                       wire_pack=wire),
                                  probe=probe, dissector=pd_, log=logs.append)
        assert any(l.startswith("[resident] resumed") for l in logs) == resumed, logs
        pd.testing.assert_frame_equal(first, again)


def test_packed_resident_agrees_with_jax(dissectors, tmp_path):
    from mammodissect.data.probes import ArrayProbe as JaxArrayProbe
    from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
    from mammodissect.dissect.engine import run_dissection as jax_run_dissection
    from mammodissect_torch.data.probes import ArrayProbe
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

    images, jd, pd_ = dissectors
    jdf, jpath = jax_run_dissection(_cfg(JaxDissectConfig, tmp_path, "jax", wire_pack="on"),
                                    probe=JaxArrayProbe(images, mean=0.3, std=0.25),
                                    dissector=jd, log=lambda *_: None)
    df, path = run_dissection(_cfg(DissectConfig, tmp_path, "port", device="cpu", wire_pack="on"),
                              probe=ArrayProbe(images, mean=0.3, std=0.25), dissector=pd_,
                              log=lambda *_: None)
    jdf, df = pd.read_csv(jpath), pd.read_csv(path)
    top = [[ast.literal_eval(row)[0] for row in d["description"]] for d in (df, jdf)]
    assert np.mean([a == b for a, b in zip(*top)]) >= 0.99
    assert list(df["images"]) == list(jdf["images"])
    sim, jsim = (np.array([json.loads(s) for s in d["similarity"]]) for d in (df, jdf))
    np.testing.assert_allclose(sim, jsim, rtol=1e-4, atol=1e-4 * np.abs(jsim).max())

