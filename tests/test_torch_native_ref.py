"""Fault F5 of the roadmap: a pytest worker that loses the race to build the JAX
package's native library (built in place, unlocked, by every worker at collection)
keeps no library, and the JAX float resize falls back to PIL, so the port's float
pixels differ from it by more than the parity tests' 1e-5. `tests/_jax_native.py`
gives such a worker JAX's own library, built where only it writes.

The check runs in a fresh interpreter that writes only to its temporary directory:
the JAX loader starts as a losing worker finds it (a file newer than the source that
holds every export name but is not a whole ELF), then takes the helper."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, os, sys
from pathlib import Path

import numpy as np

import mammodissect.data.transforms as JT
import mammodissect_torch.data.transforms as PT
from mammodissect import native
from mammodissect_torch import native as port_native
from tests._jax_native import jax_native_lib

tmp = Path(sys.argv[1])
port_native.BUILD_DIR = tmp / "port"
broken = tmp / "shared" / "_fastimage.so"
broken.parent.mkdir()
broken.write_bytes(b"\x7fELF" + b" ".join(s.encode() for s in native._REQUIRED_SYMBOLS))
newer = os.path.getmtime(native._SRC) + 60
os.utime(broken, (newer, newer))
native._SO = str(broken)

# the shrink image of test_float_eval_resize_follows_the_jax_default: the 9th of its
# noise images (176x120), as JT.load_image reads it, to 48x32
rng = np.random.default_rng(0)
for i in range(9):
    u8 = rng.integers(0, 256, size=(120 + 7 * i, 80 + 5 * i) if i % 3 else (30, 20),
                      dtype=np.uint8)
arr = u8.astype(np.float32)[..., None] / 255.0
args = ((48, 32), JT.VINDR_MEAN, JT.VINDR_STD)
port = PT.gray_resize_normalize(arr, *args)
out = {"lost_race_lib": native.get_lib() is not None,
       "port_native": port_native.available(),
       "err_lost_race": float(np.abs(JT.gray_resize_normalize(arr, *args) - port).max())}
lib = jax_native_lib(str(tmp / "private"))
out.update(err_helper=float(np.abs(JT.gray_resize_normalize(arr, *args) - port).max()),
           helper_so=native._SO, loaded=lib._name, broken_so=str(broken))
print(json.dumps(out))
"""


def test_helper_replaces_the_library_of_a_worker_that_lost_the_build_race(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONDONTWRITEBYTECODE="1")
    run = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    # (a) the fault: no JAX library, so JAX resizes with PIL, far from the port
    assert not out["lost_race_lib"] and out["port_native"]
    assert out["err_lost_race"] > 1e-5
    # (b) the helper: JAX's own library from another file, within the tests' 1e-5
    assert out["err_helper"] <= 1e-5
    assert out["loaded"] == out["helper_so"] != out["broken_so"]
    assert not os.path.samefile(out["helper_so"], out["broken_so"])
    assert out["helper_so"].startswith(str(tmp_path))
