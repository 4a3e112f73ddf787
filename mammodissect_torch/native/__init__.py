"""Native host-side image kernels (C++ through ctypes): the float eval resize and
the span packer of the packed uint8 wire.

The port's own copy of `mammodissect/native/`: `fastimage.cpp` is built with g++
on first use into `build/mammodissect_torch/`, under a file name that carries a
digest of the source and the flags (as `ops/kernels.py` builds the CUDA kernels),
so an edited source is rebuilt and a stale library is never loaded.
The build uses no `-march=native` (a build directory copied to another machine
must still run there), only `-mfma` on x86-64, which every x86 server CPU since 2013
has.

When no compiler is found, `available()` is False: `data/transforms.py` then
resizes float eval images with PIL (which antialiases when it shrinks, so the
pixels differ from the native resize's), and `dissect/packing.py` packs with numpy
(the same bytes, more host time). The packer reports which one it used
(`packing.native_packer`)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fastimage.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mammodissect_torch"
# -mfma on x86-64: the JAX package builds its copy with -march=native, which lets g++
# contract a*b + c into fused multiply-adds on any x86 host of the last decade; built
# without them, the resize's sample coordinates round otherwise, and a 1520x912
# upsample differs by up to ~3e-5 (with them the two libraries agree bit for bit)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17",
             *(("-mfma",) if platform.machine() in ("x86_64", "AMD64") else ()))

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libfastimage_{h.hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader sees a whole library or none
    return True


def get_lib():
    """The loaded ctypes library, or None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.fi_resize_normalize.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_float]
        lib.fi_resize_normalize.restype = None
        lib.fi_batch_resize_normalize.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, f32p, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                  ctypes.c_float, ctypes.c_int]
        lib.fi_batch_resize_normalize.restype = None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.fi_row_spans.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                     i32p, i32p]
        lib.fi_row_spans.restype = None
        lib.fi_batch_pack.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, i32p, i32p, u8p, i64p, ctypes.c_int]
        lib.fi_batch_pack.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastimage unavailable (no g++ or the build failed)")
    return lib


def resize_normalize(src: np.ndarray, size_hw, mean: float, std: float,
                     minmax: bool = True) -> np.ndarray:
    """Bilinear resize (cv2-style: pixel centres, no antialiasing) of a [H, W] or
    [H, W, 1] float32 image to `size_hw`, then min-max over the resized image (when
    `minmax`) and mean/std: [h, w, 1] float32."""
    lib = _require()
    img = np.ascontiguousarray(np.squeeze(src, -1) if src.ndim == 3 else src, dtype=np.float32)
    dh, dw = size_hw
    out = np.empty((dh, dw), np.float32)
    lib.fi_resize_normalize(img, img.shape[0], img.shape[1], out, dh, dw, 1 if minmax else 0,
                            float(mean), float(std))
    return out[..., None]


def batch_resize_normalize(src: np.ndarray, size_hw, mean: float, std: float,
                           minmax: bool = True, n_threads: int | None = None) -> np.ndarray:
    """`resize_normalize` of a [N, H, W] or [N, H, W, 1] float32 batch, threaded
    across images: [N, h, w, 1] float32."""
    lib = _require()
    arr = np.ascontiguousarray(np.squeeze(src, -1) if src.ndim == 4 else src, dtype=np.float32)
    n, sh, sw = arr.shape
    dh, dw = size_hw
    out = np.empty((n, dh, dw), np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 4, 16)
    lib.fi_batch_resize_normalize(arr, n, sh, sw, out, dh, dw, 1 if minmax else 0,
                                  float(mean), float(std), int(n_threads))
    return out[..., None]


def batch_row_spans(u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row nonzero spans of a [B, H, W, C] uint8 batch (nonzero = any channel
    nonzero): (start [B, H] int32, length [B, H] int32), the batched
    `packing.row_spans`."""
    lib = _require()
    arr = np.ascontiguousarray(u8, dtype=np.uint8)
    b, h, w, c = arr.shape
    start = np.empty((b, h), np.int32)
    length = np.empty((b, h), np.int32)
    lib.fi_row_spans(arr.reshape(-1), b * h, w, c, start.reshape(-1), length.reshape(-1))
    return start, length


def batch_pack(u8: np.ndarray, start: np.ndarray, length: np.ndarray, out: np.ndarray,
               out_offsets: np.ndarray, n_threads: int | None = None) -> None:
    """Pack each image's row spans into the flat uint8 `out` at byte offset
    `out_offsets[i]` (one memcpy per row, threaded across images). Every image's
    payload must fit: `out_offsets[i] + sum(length[i]) * C <= out.size`."""
    lib = _require()
    arr = np.ascontiguousarray(u8, dtype=np.uint8)
    b, h, w, c = arr.shape
    start = np.ascontiguousarray(start, np.int32)
    length = np.ascontiguousarray(length, np.int32)
    offs = np.ascontiguousarray(out_offsets, np.int64)
    if start.shape != (b, h) or length.shape != (b, h) or offs.shape != (b,):
        raise ValueError(f"spans {start.shape}/{length.shape} and offsets {offs.shape} "
                         f"do not match the batch {arr.shape}")
    if not (out.dtype == np.uint8 and out.ndim == 1 and out.flags.c_contiguous):
        raise ValueError("out must be a flat contiguous uint8 array")
    ends = offs + length.astype(np.int64).sum(axis=1) * c
    if b and (int(offs.min()) < 0 or int(ends.max()) > out.size
              or int(start.min()) < 0 or int((start + length).max()) > w):
        raise ValueError("span or payload offset outside the batch or the output buffer")
    if n_threads is None:
        n_threads = min(os.cpu_count() or 2, 8)
    lib.fi_batch_pack(arr.reshape(-1), b, h, w, c, start.reshape(-1), length.reshape(-1),
                      out, offs, int(n_threads))
