"""Build the hand-written CUDA kernels under `csrc/` and load them with ctypes.

Each source is one shared library with a plain C interface, compiled by nvcc for
sm_90a (Hopper) into `build/mammodissect_torch/` beside the package on first use.
The library's file name carries a digest of its source, the headers under `csrc/`
and the flags, so an edited source or header is rebuilt and a stale build is never
loaded. Several sources build in
parallel, one nvcc process each (`build`).

Calling convention of every C entry point: tensor pointers and the CUDA stream
are passed as `ctypes.c_void_p` (a plain int would be cut to 32 bits), sizes as
`ctypes.c_int`; the entry returns `cudaGetLastError()` after its launch, and the
wrapper raises when that is not 0 (`check`). A failed build raises too: there is
no fallback to the plain PyTorch versions on the GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from mammodissect_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mammodissect_torch"
KERNEL_SOURCES = ("wpmi_gather_logsum", "mbconv_expand_dw", "bn_epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
                       "and PATH): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """`build/.../lib<name>_<digest>.so`; the digest covers the source, every header
    under `csrc/` (any source may include any of them) and the nvcc flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    headers = sorted(p for p in CSRC.iterdir() if p.suffix in (".cuh", ".h"))
    for header in headers:
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile the named sources that are not built yet (all of them with
    `ptxas_verbose`, whose log carries ptxas's figures), all nvcc processes started
    together. Returns {name: {"seconds", "cached", "log"}}; raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas=-v",) if ptxas_verbose else ()
    started = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_verbose:
            report[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, out)
    failures = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False, "log": log}
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees a whole library or none
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed; the build or the
    load of a built library is a span `build.kernels`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with span("build.kernels"):
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
