"""Import hygiene and device policy of the PyTorch port.

In a fresh interpreter, importing every module of `mammodissect_torch` loads no
jax, no flax, no optax, no orbax and nothing of the JAX package `mammodissect`. And
the entry points run on CUDA unless the caller asks for the CPU: without a GPU they
raise."""
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "mammodissect"))
unwalked = [m for m in sys.argv[1:] if m not in names]
print(len(names), "modules;", "forbidden:", bad, "unwalked:", unwalked)
sys.exit(1 if bad or unwalked else 0)
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


# the host modules of the analysis flow and the detection dataset: each must be walked
HOST_MODULES = ("mammodissect_torch.assets", "mammodissect_torch.utils.xlsx",
                "mammodissect_torch.analysis", "mammodissect_torch.analysis.postprocess",
                "mammodissect_torch.analysis.figures", "mammodissect_torch.cli.analyze",
                "mammodissect_torch.train.detection_data")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL, *HOST_MODULES])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "forbidden: [] unwalked: []" in proc.stdout
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 80, proc.stdout  # every module of the package was imported


_REEXPORTS = r"""
import subprocess, sys
import torch  # loads its own libraries first
spawned = []
subprocess.Popen = lambda *a, **k: spawned.append(a)  # an nvcc build would start one
import ctypes
loaded = []
ctypes.CDLL = lambda *a, **k: loaded.append(a)  # a kernel library would load through it
from mammodissect_torch.ops import soft_wpmi, get_similarity_fn, pool_activation
from mammodissect_torch.models import SqueezeExcite, EfficientNetMammo
from mammodissect_torch.train import linear_warmup_cosine_annealing
from mammodissect_torch.data import get_probe, iter_batches
from mammodissect_torch.dissect import run_dissection, write_results
from mammodissect_torch.utils import seed_everything, Registry
import importlib
names = 0
for pkg in ("ops", "train", "models", "data", "dissect", "utils"):
    module = importlib.import_module("mammodissect_torch." + pkg)
    for name in module.__all__:
        getattr(module, name)
        names += 1
from mammodissect_torch.ops import kernels
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "mammodissect"))
print(names, "names;", "forbidden:", bad, "spawned:", spawned, "loaded:", loaded,
      "libs:", kernels._libs)
"""


def test_reexported_names_import_without_jax_or_a_kernel_build():
    """The six subpackages' `__all__` names (41) import in a fresh interpreter: no jax,
    nothing of the JAX package, no nvcc started and no kernel library loaded (the
    CUDA kernels build at their first launch)."""
    proc = _run(["-c", _REEXPORTS])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == ("41 names; forbidden: [] spawned: [] loaded: [] libs: {}"), \
        proc.stdout


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


def test_zseval_cli_without_device_raises_without_a_gpu(no_cuda, tmp_path):
    out = tmp_path / "zs.json"
    proc = _run(["-m", "mammodissect_torch.cli.zseval", "--clip_model", "ViT-B/16",
                 "--d_probe", "synthetic", "--probe_kwargs", '{"n": 4, "h": 32, "w": 32, "c": 3}',
                 "--dissector_kwargs", '{"image_size": 32, "vision_layers": 1, "text_layers": 1}',
                 "--output", str(out)])
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr, proc.stderr
    assert not out.exists()


def test_clip_entry_points_raise_without_a_gpu(no_cuda):
    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.dissect.evalmetrics import default_text_embedder

    tiny = {"image_size": 32, "vision_layers": 1, "text_layers": 1}
    with pytest.raises(RuntimeError, match="GPU"):
        get_dissector("ViT-B/16", **tiny)
    with pytest.raises(RuntimeError, match="GPU"):
        get_target_model("clip", **tiny)
    with pytest.raises(RuntimeError, match="GPU"):
        get_target_model("clip_rn50", input_size=32)
    with pytest.raises(RuntimeError, match="GPU"), pytest.warns(UserWarning, match="RANDOM"):
        default_text_embedder("clip", **tiny)


def test_zoo_entry_points_raise_without_a_gpu(no_cuda, tmp_path):
    """The zoo targets, BreastClip's other towers and the scoring helpers default to
    CUDA: without a GPU they raise, and nothing scores quietly on the CPU."""
    import numpy as np

    from mammodissect_torch.dissect.engine import (
        get_similarity_from_activations,
        score_all_layers,
    )
    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.models.breastclip import BreastClip
    from mammodissect_torch.ops.similarity import soft_wpmi

    for name, kw in (("resnet18", {}), ("resnet18_places", {}), ("vit-bloodmnist", {}),
                     ("breastclip_swin", {})):
        with pytest.raises(RuntimeError, match="GPU"):
            get_target_model(name, **kw)
    for tower in ("swin", "vit"):
        cfg = {"image_encoder": {"model_type": tower}, "text_encoder": {}}
        with pytest.raises(RuntimeError, match="GPU"):
            BreastClip.create(model_config=cfg, bert_layers=1)
    paths = []
    for name, arr in (("t", np.ones((4, 3))), ("c", np.ones((4, 2))), ("x", np.ones((5, 2)))):
        np.save(tmp_path / f"{name}.npy", arr.astype(np.float32))
        paths.append(str(tmp_path / f"{name}.npy"))
    with pytest.raises(RuntimeError, match="GPU"):
        score_all_layers({"l": np.ones((4, 3), np.float32)}, paths[1], paths[2], "soft_wpmi")
    with pytest.raises(RuntimeError, match="GPU"):
        get_similarity_from_activations(*paths, soft_wpmi)


def _finetune_data(root, n=12, hw=(32, 24)):
    """n grayscale PNGs and a VinDr-style CSV (split column), labels alternating."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        arr = (rng.random(hw) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / f"i{i}.png")
        rows.append({"image_path": f"i{i}.png", "Mass": i % 2,
                     "split": "training" if i < 8 else "test"})
    pd.DataFrame(rows).to_csv(root / "meta.csv", index=False)
    return str(root / "meta.csv")


def _finetune_args(tmp_path):
    csv = _finetune_data(tmp_path)
    return ["-m", "mammodissect_torch.cli.finetune", "--csv-file", csv, "--data-dir",
            str(tmp_path), "--label", "Mass", "--arch", "t_test_ft", "--img-size", "32", "24",
            "--epochs", "1", "--batch-size", "4", "--dtype", "float32", "--pad-mode", "same",
            "--weighted-BCE", "y", "--checkpoints", str(tmp_path / "ck"),
            "--output-path", str(tmp_path / "out"), "--tensorboard-path", str(tmp_path / "tb")]


def test_finetune_cli_without_device_raises_without_a_gpu(no_cuda, tmp_path):
    proc = _run(_finetune_args(tmp_path))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr, proc.stderr
    assert not (tmp_path / "out").exists() and not (tmp_path / "ck").exists()


def test_finetune_cli_runs_on_the_cpu(tmp_path):
    proc = _run(_finetune_args(tmp_path) + ["--device", "cpu"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done: 4 out-of-fold predictions" in proc.stdout
    ckpts = list((tmp_path / "ck").glob("*.pth"))
    assert [p.name for p in ckpts] == ["mammodissect_clf_seed_10_fold0_best_Mass_ver1.pth"]
    assert (tmp_path / "out" / "oof_predictions.csv").exists()


def test_finetune_entry_points_raise_without_a_gpu(no_cuda, tmp_path):
    from mammodissect_torch.models.classifier import BreastClipClassifierModule
    from mammodissect_torch.train.experiments import FinetuneConfig, do_experiments
    from mammodissect_torch.train.trainer import Trainer, make_optimizer

    cfg = FinetuneConfig(csv_file=_finetune_data(tmp_path), output_path=str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="GPU"):
        do_experiments(cfg)
    assert not (tmp_path / "out").exists()
    model = BreastClipClassifierModule("efficientnet-test")
    optimizer, _ = make_optimizer(model, 1e-3, 0.0, 0, 10)
    with pytest.raises(RuntimeError, match="GPU"):
        Trainer(model, optimizer)
    # several ranks need torchrun's process group (tests/test_torch_parallel.py trains
    # model_parallel=2 under one)
    with pytest.raises(RuntimeError, match="torchrun"):
        do_experiments(FinetuneConfig(csv_file=cfg.csv_file, model_parallel=2, device="cpu",
                                      output_path=str(tmp_path / "out")))
    assert not (tmp_path / "out").exists()


def test_pretrain_entry_points_raise_without_a_gpu(no_cuda, tmp_path):
    """Pretraining and the V2 classifier target default to CUDA: without a GPU the
    loop, the CLI and the target raise before any step or checkpoint, and the
    CLI's --model-parallel > 1 on the CPU without a process group says to launch with
    torchrun."""
    import pandas as pd

    from mammodissect_torch.cli.pretrain import main as pretrain_main
    from mammodissect_torch.data.imagetext import ImageTextDataset
    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.train.pretrain import PretrainConfig, pretrain

    df = pd.DataFrame({"image": ["x.png"], "REPORT": ["['mass']"]})
    df.to_csv(tmp_path / "d.csv", index=False)
    cfg = PretrainConfig(checkpoints=str(tmp_path / "ck"), tensorboard_path=str(tmp_path / "tb"))
    with pytest.raises(RuntimeError, match="GPU"):
        pretrain(cfg, ImageTextDataset(df))
    argv = ["--csv-file", str(tmp_path / "d.csv"), "--checkpoints", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="GPU"):
        pretrain_main(argv)
    assert not (tmp_path / "ck").exists()
    with pytest.raises(RuntimeError, match="torchrun"):
        pretrain_main(argv + ["--model-parallel", "2", "--device", "cpu"])
    assert not (tmp_path / "ck").exists()
    with pytest.raises(RuntimeError, match="GPU"):
        get_target_model("breastclip_classifier", arch="upmc_breast_clip_efficientnetv2-s_ft")
