"""Import hygiene and device policy of the PyTorch port.

In a fresh interpreter, importing every module of `mammodissect_torch` loads no
jax, no flax and nothing of the JAX package `mammodissect`. And the entry points
run on CUDA unless the caller asks for the CPU: without a GPU they raise."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import mammodissect_torch
names = ["mammodissect_torch"] + [m.name for m in pkgutil.walk_packages(
    mammodissect_torch.__path__, "mammodissect_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mammodissect"))
print(len(names), "modules;", "forbidden:", bad)
sys.exit(1 if bad else 0)
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "forbidden: []" in proc.stdout
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 35, proc.stdout  # every module of the package was imported


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_cli_without_device_raises_without_a_gpu(no_cuda, tmp_path):
    proc = _run(["-m", "mammodissect_torch.cli.dissect", "--target_model", "breastclip",
                 "--clip_model", "breastclip", "--resident", "--d_probe", "synthetic_u8",
                 "--concept_set", "tests/assets/tiny_concepts.txt",
                 "--activation_dir", str(tmp_path / "a"), "--result_dir", str(tmp_path / "r")])
    assert proc.returncode != 0
    assert "no" in proc.stderr and "device='cpu'" in proc.stderr, proc.stderr
    assert not (tmp_path / "r").exists()  # nothing ran on the CPU


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(no_cuda):
    from mammodissect_torch.device import resolve_device
    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

    with pytest.raises(RuntimeError, match="GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="GPU"):
        get_dissector("breastclip", bert_layers=1)
    with pytest.raises(RuntimeError, match="GPU"):
        run_dissection(DissectConfig(target_model="breastclip", clip_model="breastclip",
                                     resident=True))
    assert resolve_device("cpu") == torch.device("cpu")
