"""The port's public surface against the JAX package's: for every module of
`mammodissect`, each public function or class defined there exists in the port's
counterpart module, each function takes every JAX parameter with JAX's default,
each class (but the flax modules, whose fields are flax's idiom) takes every JAX
constructor parameter with JAX's default; every `__all__` is JAX's; every CLI
parser has JAX's flags and defaults. The deliberate differences are named below,
each with its reason. Also F3's parity checks on the CPU: the learning-rate
schedule with a warmup start and a floor against optax in float64, `iter_epoch`'s
dropped tail, `convert_dictconfig_to_dict` and `seed_everything`."""
import importlib
import inspect
import pkgutil

import flax.linen as nn
import jax
import numpy as np
import pytest

import mammodissect

MESH = "a JAX device mesh; the port's ranks each own a GPU in a process group (parallel/mesh.py)"
FLAX_STATE = "a flax variable tree; the port's object holds a torch module on a device"

# JAX modules without a counterpart file
MODULES = {
    "mammodissect.ops.pallas_mbconv":
        "the TPU kernel: csrc/mbconv_expand_dw.cu behind ops/cuda_mbconv.py",
    "mammodissect.ops.pallas_wpmi":
        "the TPU kernel: csrc/wpmi_gather_logsum.cu behind ops/cuda_wpmi.py",
    "mammodissect.utils.jit_cache":
        "XLA's compilation cache: the port's kernels build once into build/ (ops/kernels.py)",
    "mammodissect.utils.torch_convert":
        "torch weights into flax variables: the port holds the torch names (convert.py is "
        "its inverse)",
}
# JAX names without a counterpart
NAMES = {
    "mammodissect.dissect.targets.os_path_is_orbax": "orbax checkpoints are JAX's",
    "mammodissect.models.clip_vit.clip_torch_to_flax": "the port loads torch weights as they are",
    "mammodissect.models.modified_resnet.modified_resnet_torch_to_flax":
        "the port loads torch weights as they are",
    "mammodissect.models.resnet.resnet_torch_to_flax": "the port loads torch weights as they are",
    "mammodissect.models.swin.swin_torch_to_flax": "the port loads torch weights as they are",
    "mammodissect.models.vit_encoder.vit_torch_to_flax": "the port loads torch weights as they are",
    "mammodissect.models.efficientnet.static_same_padding":
        "flax's explicit pad tuples; the port pads with F.pad (EfficientNet._paddings)",
    "mammodissect.models.efficientnet.StemConv":
        "the flax stem and its space-to-depth form; the port's plain conv computes the same "
        "function, faster on the H100",
    "mammodissect.parallel.mesh.auto_data_mesh": MESH,
    "mammodissect.parallel.mesh.global_data_mesh": MESH,
    "mammodissect.parallel.mesh.mesh_spans_processes": MESH,
    "mammodissect.parallel.multihost.global_batch_from_local":
        "builds a global jax.Array from host shards; each port rank keeps its own rows",
    "mammodissect.parallel.sharding.replicated": "jax.sharding placement; DDP places the port's",
    "mammodissect.parallel.sharding.batch_sharding": "jax.sharding placement; DDP places the port's",
    "mammodissect.parallel.sharding.replicate_tree":
        "jax.sharding placement; DDP places the port's",
    "mammodissect.parallel.sharding.param_shardings":
        "jax.sharding placement; the TP plan places the port's",
    "mammodissect.train.clip_trainer.jit_clip_train_step":
        "jax.jit of the step; the port's step runs eagerly",
    "mammodissect.train.trainer.TrainerState":
        "flax's immutable train state; the port's Trainer holds the model and optimizer",
    "mammodissect.utils.profiling.annotate":
        "a labelled range in a trace; the port's `span` is one under the profiler and also "
        "records itself (utils/profiling.py)",
}
# (JAX function or class, parameter): why the port's differs
PARAMS = {
    ("mammodissect.dissect.engine.fused_harvest_embed_resident", "pack_fixed_len"):
        "XLA's static bucket of the packed wire; the port's eager step takes any length",
    ("mammodissect.models.classifier.frozen_param_labels", "params"):
        "labels a flax parameter tree; the port labels a torch module's parameters (`module`)",
    ("mammodissect.models.layers.drop_connect", "deterministic"):
        "the caller draws the keep mask (drop_connect_mask, a torch.Generator) and passes "
        "`keep`; None is the deterministic case",
    ("mammodissect.models.layers.drop_connect", "rng"):
        "the caller draws the keep mask (drop_connect_mask, a torch.Generator) and passes `keep`",
    ("mammodissect.ops.pooling.pool_activation", "data_format"):
        "default NCHW: the port's towers hold NCHW tensors; NHWC is accepted",
    ("mammodissect.ops.pooling.gem_pool", "data_format"):
        "the port's extra layout argument, default NCHW as its towers",
    ("mammodissect.parallel.collectives.all_gather_with_grad", "axis_name"):
        "a shard_map axis; the port's collectives take a process group",
    ("mammodissect.parallel.collectives.all_gather_with_grad", "tiled"):
        "a shard_map option; the port always concatenates the ranks' rows",
    ("mammodissect.parallel.collectives.psum", "axis_name"):
        "a shard_map axis; the port's collectives take a process group",
    ("mammodissect.parallel.collectives.pmean", "axis_name"):
        "a shard_map axis; the port's collectives take a process group",
    ("mammodissect.parallel.mesh.make_mesh", "devices"): MESH,
    ("mammodissect.parallel.mesh.make_mesh", "axis_names"): MESH,
    ("mammodissect.parallel.sharding.shard_batch", "mesh"): MESH,
    ("mammodissect.train.checkpoints.save_checkpoint", "trainer_state"):
        "a flax state tree; the port saves torch state dicts",
    ("mammodissect.train.checkpoints.load_checkpoint", "template"):
        "a flax state tree to fill; the port loads torch state dicts",
    ("mammodissect.train.clip_trainer.make_clip_train_step", "module"):
        "a pure step of a flax module; the port's step closes over the torch model",
    ("mammodissect.train.clip_trainer.make_clip_train_step", "tx"):
        "an optax transform; the port's step closes over the torch optimizer",
    ("mammodissect.dissect.engine.DissectConfig", "wire_pack"):
        "default off: the packed wire moved fewer bytes and no faster on the H100 (PERF.md)",
    ("mammodissect.dissect.targets.EfficientNetTarget", "variables"): FLAX_STATE,
    ("mammodissect.dissect.targets.EfficientNetTarget", "dtype"):
        "the torch module carries its dtype",
    ("mammodissect.dissect.targets.EfficientNetTarget", "mesh"): MESH,
    ("mammodissect.models.breastclip.BreastClip", "variables"): FLAX_STATE,
    ("mammodissect.models.breastclip.BreastClip", "mesh"): MESH,
    ("mammodissect.models.breastclip.BreastClip", "_jit_cache"): "jax.jit's programs",
    ("mammodissect.models.clip_vit.OpenAIClip", "dtype"):
        "a torch dtype or its name; None computes in float32, JAX's default",
    ("mammodissect.train.trainer.Trainer", "module"): FLAX_STATE,
    ("mammodissect.train.trainer.Trainer", "variables"): FLAX_STATE,
    ("mammodissect.train.trainer.Trainer", "tx"):
        "an optax transform; the port's Trainer builds its torch optimizer",
}
# (CLI, flag destination): why the port's flag differs
CLI_FLAGS = {
    ("dissect", "device"): "default cuda: the port's entry points run on the GPU unless asked",
    ("dissect", "wire_pack"):
        "default off: the packed wire moved fewer bytes and no faster on the H100 (PERF.md)",
    ("finetune", "device"): "the port's flag: cuda unless --device cpu",
    ("pretrain", "device"): "the port's flag: cuda unless --device cpu",
    ("zseval", "device"): "the port's flag: cuda unless --device cpu",
}
CLIS = ("dissect", "finetune", "pretrain", "zseval", "analyze")
# packages whose `__all__` holds more than JAX's: every JAX name that has a
# counterpart is in it
ALL_SUPERSETS = {
    "mammodissect.configs": "adds load_preset and ZeroShotConfig, the presets as the port's "
                            "dataclasses",
    "mammodissect.parallel": "adds the process-group API (data_group, data_parallel, psum, "
                             "pmean, initialize, gather_predictions, the TP plan); JAX's "
                             "jax.sharding placements are in NAMES",
}


def _jax_modules():
    """Every public module of the JAX package, imported."""
    jax.config.update("jax_platforms", "cpu")
    out = []
    for info in pkgutil.walk_packages(mammodissect.__path__, "mammodissect."):
        if not info.name.rsplit(".", 1)[-1].startswith("_"):
            out.append(importlib.import_module(info.name))
    return out


def _port_name(name: str) -> str:
    return "mammodissect_torch" + name[len("mammodissect"):]


def _public(module):
    """The public functions and classes a module defines."""
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__}


def _param_gaps(qualname, jax_obj, port_obj):
    """The JAX parameters the port's callable lacks or defaults otherwise, less the
    named exceptions."""
    js, ps = inspect.signature(jax_obj), inspect.signature(port_obj)
    gaps = []
    for p in js.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or (qualname, p.name) in PARAMS:
            continue
        q = ps.parameters.get(p.name)
        if q is None:
            gaps.append(f"{qualname}({p.name}) missing")
        elif p.default is not p.empty and (q.default is q.empty
                                           or repr(q.default) != repr(p.default)):
            gaps.append(f"{qualname}({p.name}={p.default!r}), the port {q.default!r}")
    return gaps


@pytest.fixture(scope="module")
def jax_modules():
    return _jax_modules()


def test_every_public_name_and_parameter_has_its_counterpart(jax_modules):
    missing_modules, missing, gaps, used = [], [], [], set()
    for module in jax_modules:
        name = module.__name__
        if name in MODULES:
            continue
        try:
            port = importlib.import_module(_port_name(name))
        except ModuleNotFoundError:
            missing_modules.append(name)
            continue
        for attr, obj in _public(module).items():
            qualname = f"{name}.{attr}"
            if qualname in NAMES:
                used.add(qualname)
                continue
            if not hasattr(port, attr):
                missing.append(qualname)
                continue
            if inspect.isclass(obj) and issubclass(obj, nn.Module):
                continue  # flax fields: the port's torch modules take their own sizes
            gaps += _param_gaps(qualname, obj, getattr(port, attr))
    assert not missing_modules and not missing and not gaps, (missing_modules, missing, gaps)
    assert used == set(NAMES), set(NAMES) - used  # no stale exception
    jax_pairs = {f"{m.__name__}.{k}" for m in jax_modules for k in _public(m)}
    assert {q for q, _ in PARAMS} <= jax_pairs
    assert all(m.__name__ not in MODULES or not hasattr(m, "__path__") for m in jax_modules)
    assert set(MODULES) <= {m.__name__ for m in jax_modules}


def test_every_all_is_the_jax_packages(jax_modules):
    packages = [m for m in jax_modules if hasattr(m, "__path__") and hasattr(m, "__all__")]
    assert len(packages) == 11
    for package in packages:
        port = importlib.import_module(_port_name(package.__name__))
        if package.__name__ in ALL_SUPERSETS:
            want = {n for n in package.__all__ if not any(
                q.endswith(f".{n}") and q.startswith(package.__name__) for q in NAMES)}
            assert want <= set(port.__all__), package.__name__
        else:
            assert list(port.__all__) == list(package.__all__), package.__name__
        assert all(hasattr(port, name) for name in port.__all__), package.__name__


@pytest.mark.parametrize("cli", CLIS)
def test_cli_parser_has_the_jax_flags_and_defaults(cli):
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    want = actions(importlib.import_module(f"mammodissect.cli.{cli}").build_parser())
    got = actions(importlib.import_module(f"mammodissect_torch.cli.{cli}").build_parser())
    excepted = {dest for c, dest in CLI_FLAGS if c == cli}
    assert set(got) - set(want) <= excepted and not set(want) - set(got)
    for dest, a in want.items():
        if dest in excepted:
            continue
        assert got[dest].option_strings == a.option_strings, (cli, dest)
        assert got[dest].default == a.default, (cli, dest, a.default, got[dest].default)
        assert got[dest].type == a.type or (a.type, got[dest].type) == (None, None), (cli, dest)


def test_dissect_cli_defaults_build_the_jax_models():
    """F2: without model flags the port's dissect CLI builds JAX's defaults, the test
    target and the random dissector."""
    from mammodissect_torch.cli.dissect import build_parser
    from mammodissect_torch.dissect.engine import DissectConfig

    args = build_parser().parse_args([])
    assert (args.target_model, args.clip_model) == ("tiny_cnn", "random")
    assert (DissectConfig.target_model, DissectConfig.clip_model) == ("tiny_cnn", "random")


@pytest.mark.parametrize("warmup,start,floor", [(0, 0.0, 1e-6), (4, 1e-6, 0.0), (4, 2e-6, 5e-6),
                                                (7, 3e-5, 1e-5)])
def test_schedule_warmup_start_and_floor_match_optax_in_float64(warmup, start, floor):
    from mammodissect.train.schedule import linear_warmup_cosine_annealing as jax_schedule
    from mammodissect_torch.train.schedule import linear_warmup_cosine_annealing

    total = 23
    got = linear_warmup_cosine_annealing(5e-5, warmup, total, warmup_start_lr=start, eta_min=floor)
    with jax.enable_x64(True):
        want = jax_schedule(5e-5, warmup, total, warmup_start_lr=start, eta_min=floor)
        values = [float(want(np.float64(i))) for i in range(total + 3)]
    assert [got(i) for i in range(total + 3)] == values
    assert got(total + 2) == pytest.approx(floor, abs=1e-20)
    if warmup:
        assert got(0) == pytest.approx(start, rel=1e-12, abs=1e-20)


def test_iter_epoch_drop_last_drops_the_tail():
    from mammodissect.train.data import iter_epoch as jax_iter_epoch
    from mammodissect_torch.train.data import iter_epoch

    class DS:
        image_shape = (2, 3, 1)

        def __len__(self):
            return 10

        def image(self, i):
            return np.full(self.image_shape, i, np.float32)

        def label(self, i):
            return float(i % 2)

    for drop_last in (False, True):
        got = list(iter_epoch(DS(), 4, shuffle=True, seed=3, drop_last=drop_last))
        want = list(jax_iter_epoch(DS(), 4, shuffle=True, seed=3, drop_last=drop_last))
        assert [b.n_valid for b in got] == ([4, 4] if drop_last else [4, 4, 2])
        assert [b.n_valid for b in got] == [b.n_valid for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)


def test_convert_dictconfig_to_dict_and_seed_everything():
    import random

    from mammodissect.utils.seed import convert_dictconfig_to_dict as jax_convert
    from mammodissect_torch.utils import seed_all, seed_everything
    from mammodissect_torch.utils.seed import convert_dictconfig_to_dict

    cfg = {"a": {"b": [1, {"c": (2, 3)}], "d": "x"}, "e": [{"f": None}]}
    assert convert_dictconfig_to_dict(cfg) == jax_convert(cfg) == cfg
    assert type(convert_dictconfig_to_dict(cfg)["a"]["b"][1]["c"]) is tuple
    assert seed_everything is seed_all
    seed_everything(5)
    first = (random.random(), np.random.rand())
    seed_all(5)
    assert (random.random(), np.random.rand()) == first
