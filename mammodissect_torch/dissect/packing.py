"""Lossless packed uint8 wire of the dissection harvest (counterpart of
`mammodissect/dissect/packing.py`, the same wire format and bucket rule).

Probe mammograms are 1520x912 grayscale with ~40-60% exactly-black background, so
the harvest can send only each row's nonzero span instead of the whole frame:
  host    per image, per ROW: the [first, last] span of nonzero pixels
          (start[H], length[H] int32). The spans' bytes are packed contiguously,
          batch-row-major, into one flat uint8 buffer per shard group, padded to a
          bucket; per-row metadata is [B, H, 2] int32 (start, length).
  device  `unpack_canvas_groups` rebuilds the [B, H, W, C] uint8 canvas with one
          row gather and a mask. Pixels outside the spans are exactly zero, so the
          canvas is bit-identical to the batch and everything downstream sees the
          same bytes.

The host packer runs the native span scan and memcpy (`mammodissect_torch/native`)
when g++ could build it, else numpy; both give the same bytes (`native_packer`
says which one runs). The device unpack is plain PyTorch: the JAX package computes
it outside any Pallas kernel too.

Buckets: the flat payload's length rounds up to a multiple of `quantum` (a sixteenth
of the raw batch by default in the engine), never above the raw size, so the wire
shape takes few values; padding costs at most one quantum a batch.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mammodissect_torch import native


def row_spans(img_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row [first, last] nonzero span of one [H, W, C] uint8 image.

    Returns (start[H] int32, length[H] int32); all-zero rows get length 0."""
    nz = img_u8.any(axis=-1) if img_u8.ndim == 3 else img_u8 != 0  # [H, W]
    any_row = nz.any(axis=1)
    first = nz.argmax(axis=1).astype(np.int32)
    last = (nz.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)).astype(np.int32)
    start = np.where(any_row, first, 0).astype(np.int32)
    length = np.where(any_row, last - first + 1, 0).astype(np.int32)
    return start, length


def packed_nbytes(meta: np.ndarray, channels: int) -> int:
    """Exact packed payload size for span metadata [..., H, 2]."""
    return int(meta[..., 1].astype(np.int64).sum()) * channels


def pack_image(img_u8: np.ndarray, start: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Pack one [H, W, C] image's row spans into a flat row-major uint8 vector."""
    w = img_u8.shape[1]
    x = np.arange(w, dtype=np.int32)
    keep = (x[None, :] >= start[:, None]) & (x[None, :] < (start + length)[:, None])
    return img_u8[keep].reshape(-1)  # [sum(length) * C]


def _use_native(native_opt) -> bool:
    """native=None: the native packer when it is built; False: numpy (the parity
    oracle of the tests); True: the native packer, numpy if it cannot be built."""
    return native.available() if native_opt is None else bool(native_opt) and native.available()


def native_packer(native_opt=None) -> str:
    """Which packer `pack_batch*` runs with this `native` argument: "native" or "numpy"."""
    return "native" if _use_native(native_opt) else "numpy"


def _spans_meta(u8: np.ndarray, spans, use_native: bool) -> np.ndarray:
    """[B, H, 2] int32 (start, length) metadata from precomputed per-image span
    tuples, the native batched row scan, or numpy."""
    b, h = u8.shape[0], u8.shape[1]
    meta = np.empty((b, h, 2), np.int32)
    if spans is not None:
        for i in range(b):
            meta[i, :, 0], meta[i, :, 1] = spans[i]
        return meta
    if use_native:
        meta[:, :, 0], meta[:, :, 1] = native.batch_row_spans(u8)
        return meta
    for i in range(b):
        meta[i, :, 0], meta[i, :, 1] = row_spans(u8[i])
    return meta


def _fill(u8: np.ndarray, meta: np.ndarray, flat: np.ndarray, offs: np.ndarray,
          use_native: bool) -> None:
    """Copy image i's spans into the flat uint8 buffer at byte offset offs[i]."""
    if use_native:
        native.batch_pack(u8, meta[:, :, 0], meta[:, :, 1], flat, offs)
        return
    for i in range(u8.shape[0]):
        p = pack_image(u8[i], meta[i, :, 0], meta[i, :, 1])
        flat[offs[i]:offs[i] + p.shape[0]] = p


def pack_batch(u8: np.ndarray, spans=None, native=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a [B, H, W, C] uint8 batch.

    spans: optional per-image precomputed (start, length) tuples. native: None =
    the native packer when built, False = numpy.

    Returns (flat uint8 [L_exact], meta int32 [B, H, 2])."""
    c = u8.shape[3]
    use_native = _use_native(native)
    meta = _spans_meta(u8, spans, use_native)
    img_bytes = meta[:, :, 1].astype(np.int64).sum(axis=1) * c  # [B]
    offs = np.cumsum(img_bytes) - img_bytes
    flat = np.empty(int(img_bytes.sum()), np.uint8)
    _fill(u8, meta, flat, offs, use_native)
    return flat, meta


def pack_batch_groups(u8: np.ndarray, n_groups: int, spans=None, native=None):
    """Pack a [B, H, W, C] batch as `n_groups` contiguous shard groups (group g covers
    batch rows [g*B/n, (g+1)*B/n)).

    Returns (list of n_groups flat uint8 arrays (exact, unpadded), meta [B, H, 2])."""
    b = u8.shape[0]
    if b % n_groups:
        raise ValueError(f"batch {b} not divisible by {n_groups} shard groups")
    bs = b // n_groups
    flats, metas = [], []
    for g in range(n_groups):
        sl = slice(g * bs, (g + 1) * bs)
        f, m = pack_batch(u8[sl], spans=spans[sl] if spans is not None else None,
                          native=native)
        flats.append(f)
        metas.append(m)
    return flats, np.concatenate(metas, axis=0)


def pack_batch_groups_padded(u8: np.ndarray, n_groups: int, spans=None,
                             quantum: int = 1, cap: Optional[int] = None,
                             fixed_len: Optional[int] = None, native=None,
                             alloc: Callable[[tuple], np.ndarray] = None):
    """Pack a [B, H, W, C] batch per shard group directly into the
    [n_groups, bucket] uint8 wire buffer (one allocation, one copy of each span).

    Bucket: `fixed_len` when every group fits it, else the `quantum` rounding
    capped at `cap` (both per-group byte sizes). `alloc(shape)` returns the zeroed
    uint8 buffer to pack into (default `np.zeros`; the engine passes pinned memory).

    Returns (flat2d [n_groups, bucket] uint8, meta [B, H, 2] int32, bucket)."""
    b, c = u8.shape[0], u8.shape[3]
    if b % n_groups:
        raise ValueError(f"batch {b} not divisible by {n_groups} shard groups")
    use_native = _use_native(native)
    meta = _spans_meta(u8, spans, use_native)
    img_bytes = meta[:, :, 1].astype(np.int64).sum(axis=1) * c  # [B]
    grp = img_bytes.reshape(n_groups, b // n_groups)
    max_exact = int(grp.sum(axis=1).max()) if b else 0
    if fixed_len is not None and max_exact <= fixed_len:
        bucket = int(fixed_len)
    else:
        bucket = bucket_len(max_exact, quantum, cap if cap is not None else max(max_exact, 1))
    flat2d = (alloc or (lambda shape: np.zeros(shape, np.uint8)))((n_groups, bucket))
    # exclusive prefix sums within each group, shifted to the group's wire row
    excl = np.cumsum(grp, axis=1) - grp
    offs = (np.arange(n_groups, dtype=np.int64)[:, None] * bucket + excl).reshape(-1)
    _fill(u8, meta, flat2d.reshape(-1), offs, use_native)
    return flat2d, meta, bucket


def bucket_len(n_exact: int, quantum: int, cap: int) -> int:
    """Static-shape bucket of a flat payload: round up to a `quantum` multiple,
    never above `cap` (the raw batch size: packing can't lose)."""
    q = max(int(quantum), 1)
    return int(min(max(((n_exact + q - 1) // q) * q, q), cap))


def pad_flat(flat: np.ndarray, n_bucket: int) -> np.ndarray:
    out = np.zeros((n_bucket,), np.uint8)
    out[: flat.shape[0]] = flat
    return out


def sample_pack_fraction(probe, k: int = 16) -> float:
    """Packed-wire fraction (payload + metadata over raw bytes) estimated from up to
    k probe images: ~1.0 for dense images, ~the fill fraction for mammograms.

    A probe that knows its exact fraction (`exact_pack_fraction()`) short-circuits
    the sample. The k images are drawn by a seeded generator without replacement:
    deterministic for a given probe length, and free of the stride aliasing an
    evenly spaced sample suffers on a probe that interleaves dense and sparse
    content."""
    exact = getattr(probe, "exact_pack_fraction", None)
    if callable(exact):
        f = exact()
        if f is not None:
            return float(f)
    n = len(probe)
    if n == 0:
        return 1.0
    h, w, c = probe.image_shape
    idxs = sorted(np.random.default_rng(0).choice(n, size=min(k, n), replace=False))
    raw = h * w * c
    fracs = []
    for i in idxs:
        img = probe.image_u8(i)
        _, length = probe.image_spans(i) if hasattr(probe, "image_spans") else row_spans(img)
        fracs.append((int(length.sum()) * c + h * 2 * 4) / raw)
    return float(np.mean(fracs))


def unpack_canvas_groups(flat2d: torch.Tensor, meta: torch.Tensor, shape) -> torch.Tensor:
    """Rebuild the [B, H, W, C] uint8 canvas of a per-group packed batch, on the
    device of the inputs, bit-identical to the batch that was packed.

    flat2d [D, L] uint8 (bucket-padded payloads of D groups of B/D images), meta
    [B, H, 2] int32 (start, length). Each canvas row is one W*C-byte window of its
    group's payload, starting start*C bytes before the row's span (the bytes left
    and right of the span belong to other rows and are masked to zero). The bounds
    of the JAX version, written out:
      - row offsets restart at 0 in every group (groups pack independently) and
        are int64 (a batch of 200 canvases is 277 MB);
      - each group's payload gets W*C zero bytes in front (the first row with
        start > 0 reaches left of offset 0) and behind (a row whose span ends
        near the payload's end reads past it);
      - the window start is clamped to [0, L + W*C], as `dynamic_slice` clamps,
        so a window never leaves its group's padded payload."""
    d, flat_len = flat2d.shape
    b, h, w, c = shape
    wc = w * c
    if b % d or tuple(meta.shape) != (b, h, 2):
        raise ValueError(f"meta {tuple(meta.shape)} and {d} groups do not fit the canvas {shape}")
    start = meta[..., 0].long()  # [B, H]
    length = meta[..., 1].long()
    row_bytes = (length * c).reshape(d, -1)  # [D, (B/D)*H], the host's pack order
    rowoff = torch.cumsum(row_bytes, dim=1) - row_bytes  # exclusive, per group
    seg = flat_len + 2 * wc  # one group's padded payload
    offs = (rowoff - start.reshape(d, -1) * c + wc).clamp(0, flat_len + wc)
    offs = offs + torch.arange(d, device=offs.device)[:, None] * seg
    padded = torch.zeros((d, seg), dtype=torch.uint8, device=flat2d.device)
    padded[:, wc:wc + flat_len] = flat2d
    windows = padded.reshape(-1).unfold(0, wc, 1)  # [d*seg - wc + 1, wc], a view
    rows = windows.index_select(0, offs.reshape(-1)).reshape(b, h, w, c)
    x = torch.arange(w, device=meta.device)
    inside = (x >= start[..., None]) & (x < (start + length)[..., None])  # [B, H, W]
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=torch.uint8,
                                                            device=rows.device))


def unpack_canvas(flat_u8: torch.Tensor, meta: torch.Tensor, shape) -> torch.Tensor:
    """`unpack_canvas_groups` of one group: flat_u8 [L] uint8 (bucket-padded)."""
    return unpack_canvas_groups(flat_u8[None], meta, shape)
