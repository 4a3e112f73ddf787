"""Multi-GPU paths of the PyTorch port on the CPU, against the JAX package's mesh
results, and the utilities and CLI flags of the last slice.

One module-scoped process group of 2 gloo ranks (`tests/_torch_parallel_worker.py`,
which imports torch and the port only) runs every multi-process scenario once,
started as soon as the inputs exist and held to one shared timeout, while this
process computes the JAX side on conftest's 8 CPU devices at the same global batch:
- the staged harvest over an uneven probe (both wires) against JAX's harvest_probe;
- a tiny resident dissection's CSV against JAX's, on an odd probe;
- three data-parallel fine-tune steps against JAX's Trainer on a (2, 1) mesh, the
  BatchNorm statistics included (a BatchNorm with local moments fails), and two
  steps with drop-connect against the port's single-process steps;
- a data-parallel and a tensor-parallel (1, 2) pretraining step against
  `jit_clip_train_step` on (2, 1) and (1, 2) meshes;
- gather_predictions, all_gather_with_grad's gradient, the sliced masks, and
  model_parallel=2 training under the process group (do_experiments, cli.pretrain).
In this process: HostShardedProbe's index contract and the tensor-parallel plan
against JAX's, the mesh helpers, configs and presets, get_Paths, the NaN hooks,
PhaseTimer and the dissect CLI's --wandb, --debug_nans and --profile."""
import json
import os
import socket
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mammodissect.data.probes import ArrayProbe as JaxArrayProbe
from mammodissect.data.probes import HostShardedProbe as JaxHostShardedProbe
from mammodissect.data.probes import get_probe as jax_probe
from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
from mammodissect.dissect.engine import harvest_probe as jax_harvest
from mammodissect.dissect.engine import run_dissection as jax_run_dissection
from mammodissect.dissect.targets import EfficientNetTarget as JaxEfficientNetTarget
from mammodissect.models.breastclip import BreastClip as JaxBreastClip
from mammodissect.models.breastclip import BreastClipModule as JaxBreastClipModule
from mammodissect.models.classifier import BreastClipClassifierModule as JaxClassifier
from mammodissect.models.efficientnet import EfficientNet as JaxEfficientNet
from mammodissect.models.tokenizers import WordPieceTokenizer as JaxWordPiece
from mammodissect.parallel.mesh import make_mesh as jax_make_mesh
from mammodissect.parallel.sharding import param_shardings
from mammodissect.train.clip_trainer import jit_clip_train_step
from mammodissect.train.trainer import Trainer as JaxTrainer
from mammodissect.train.trainer import make_optimizer as jax_make_optimizer
from mammodissect_torch.convert import breastclip_from_jax, classifier_from_jax, efficientnet_from_jax
from mammodissect_torch.data.probes import ArrayProbe, HostShardedProbe
from mammodissect_torch.models.breastclip import BreastClipModule
from mammodissect_torch.models.classifier import BreastClipClassifierModule
from mammodissect_torch.models.layers import drop_connect_mask, init_weights
from mammodissect_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
TIMEOUT_S = 300  # shared by both ranks from their start (~15 s alone, several times that
# beside other test workers): a hang fails the tests instead of eating the run
MEAN, STD = 0.3089279, 0.25053555
POS_WEIGHT = 15.573306370070778
HARVEST_KW = {"n": 13, "h": 48, "w": 40, "seed": 3}
HARVEST_LAYERS = ["blocks.1", "blocks.4", "blocks.6"]
SMALL = {"bert_layers": 2, "model_config": {
    "name": "clip_custom", "temperature": 0.07,
    "image_encoder": {"model_type": "cnn", "variant": "efficientnet-test", "in_channels": 1},
    "text_encoder": {"pooling": "eos"},
    "projection_head": {"name": "linear", "proj_dim": 32}}}
RESIDENT_CFG = dict(target_model="breastclip", clip_model="breastclip",
                    target_layers=[f"blocks.{i}" for i in range(7)], d_probe="synthetic_u8",
                    concept_set=os.path.join(REPO, "tests", "assets", "tiny_concepts.txt"),
                    batch_size=8, num_top_concepts=3, num_top_images=4, top_k=5,
                    resident=True)
NARROW = dict(image_variant="efficientnet-test", bert_layers=2, bert_hidden=32, bert_heads=2,
              bert_intermediate=64, proj_dim=16)
WORDS = ["mass", "right", "left", "no", "clear"]
HW = (32, 24)
PT_HW = (64, 48)


# ------------------------------------------------------------------------ inputs
def _redraw(variables, seed):
    """Unit-preserving random weights and BN parameters and statistics, drawn for the
    leaves' shapes (arrays or `jax.eval_shape` structs), logit_scale log(1/0.07)."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name, shape = str(path[-1].key), tuple(leaf.shape)
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)


def _init_like(variables, seed):
    """Random kernels (LeCun normal) and embeddings (N(0, 1/width)), zero biases,
    identity BatchNorm: deep towers keep their inputs apart (the redrawn statistics
    of `_redraw` map every probe image of a dissection to one embedding)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), tuple(leaf.shape)
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "embedding":
            return (rng.normal(size=shape) / np.sqrt(shape[-1])).astype(np.float32)
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        return (np.ones if name in ("scale", "var") else np.zeros)(shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _drawn(module, seed, *args, draw=_redraw):
    """The module's variables drawn for the shapes of its init (no compile)."""
    return draw(jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args), seed)


def _u8_batches(seed, valid, b=8, hw=HW):
    """uint8 batches of b; a batch with fewer valid rows is wrap-padded."""
    rng = np.random.default_rng(seed)
    out = []
    for n_valid in valid:
        u8 = rng.integers(0, 256, size=(b, *hw, 1), dtype=np.uint8)
        labels = (rng.random(b) > 0.6).astype(np.float32)
        u8[n_valid:], labels[n_valid:] = u8[:b - n_valid], labels[:b - n_valid]
        out.append((u8, labels, n_valid))
    return out


def _pt_batch():
    """A collated u8 contrastive batch of 6 with both text views and the image view."""
    rng = np.random.default_rng(1)
    jtok = JaxWordPiece.toy(words=WORDS)
    texts = ["mass right", "clear left", "no mass left", "mass left no mass right",
             "clear right", "mass"]
    t1, t2 = jtok(texts, max_length=12), jtok(texts[::-1], max_length=12)
    return {"images": rng.integers(0, 256, (6, *PT_HW, 1), dtype=np.uint8),
            "image_views": rng.integers(0, 256, (6, *PT_HW, 1), dtype=np.uint8),
            "input_ids": t1["input_ids"], "attention_mask": t1["attention_mask"],
            "input_ids2": t2["input_ids"], "attention_mask2": t2["attention_mask"]}


def _jax_frozen_labels(params):
    def label(path, _):
        keys = [str(k.key) for k in path]
        frozen = keys[-2:] == ["bn2", "bias"] or keys[-3:] == ["attention", "key", "bias"]
        return "frozen" if frozen else "train"

    return jax.tree_util.tree_map_with_path(label, params)


def _finetune_data(root, n=12):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        Image.fromarray((rng.random(HW) * 255).astype(np.uint8)).save(root / f"i{i}.png")
        rows.append({"image_path": f"i{i}.png", "Mass": i % 2,
                     "split": "training" if i < 8 else "test"})
    pd.DataFrame(rows).to_csv(root / "meta.csv", index=False)


def _pretrain_data(root):
    """8 patients' CC and MLO PNGs and a CSV of *_FINDING labels."""
    rng = np.random.default_rng(0)
    rows = []
    for pid in range(8):
        os.makedirs(root / str(pid), exist_ok=True)
        for img in ("cc0.png", "mlo0.png"):
            Image.fromarray((rng.random((40, 30)) * 255).astype("uint8")).save(root / str(pid) / img)
        rows.append({"patient_id": pid, "laterality": "LR"[pid % 2], "view": "['CC', 'MLO']",
                     "CC": "['cc0.png']", "MLO": "['mlo0.png']",
                     "CC_FINDING": "[['Mass'], [], [], ['Mass']]",
                     "MLO_FINDING": "[['No Finding'], [], ['Mass'], []]"})
    pd.DataFrame(rows).to_csv(root / "data.csv", index=False)
    return ["--csv-file", str(root / "data.csv"), "--root", str(root), "--epochs", "1",
            "--batch-size", "4", "--img-size", "32", "24", "--image-variant",
            "efficientnet-test", "--bert-layers", "1", "--warmup-steps", "1",
            "--checkpoints", str(root / "ck")]


class _Ranks:
    """The running ranks; `result(r)` waits (within the shared timeout) and loads
    rank r's results."""

    def __init__(self, procs, work, jax_side):
        self.procs, self.work, self.jax = procs, work, jax_side
        self.deadline = time.monotonic() + TIMEOUT_S
        self._results = None

    def result(self, r):
        if self._results is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=max(self.deadline - time.monotonic(), 1))[0])
                except subprocess.TimeoutExpired:
                    self.close()
                    pytest.fail(f"the 2-rank group did not finish within {TIMEOUT_S} s")
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"--- rank log ---\n{log[-4000:]}"
            self._results = [torch.load(self.work / f"rank{i}.pt", weights_only=False)
                             for i in range(2)]
        return self._results[r]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    # every JAX model's variables drawn for its init's shapes: no init compiles
    tower = JaxEfficientNet(variant="efficientnet-test", in_channels=1)
    jt = JaxEfficientNetTarget(tower, _drawn(tower, 1, jnp.ones((1, 48, 40, 1))))
    tok = JaxWordPiece.toy()
    # SMALL's dissector as BreastClip.create builds it (an image encoder without a
    # name is "-detect": average pooling)
    dm = JaxBreastClipModule(image_variant="efficientnet-test", in_channels=1,
                             image_pooling="avg", proj_dim=32, bert_layers=2,
                             vocab_size=len(tok.vocab))
    jd = JaxBreastClip(module=dm, tokenizer=tok, variables=_drawn(dm, 3, {
        "images": jnp.ones((1, 64, 48, 1)), "input_ids": jnp.ones((1, 8), jnp.int32),
        "attention_mask": jnp.ones((1, 8), jnp.int32)}, draw=_init_like))
    module = JaxClassifier(variant="efficientnet-test", n_class=1, pad_mode="same",
                           bn_momentum=0.9)
    ft_vars = _drawn(module, 0, jnp.ones((1, *HW, 1)))
    jtok = JaxWordPiece.toy(words=WORDS)
    jm = JaxBreastClipModule(vocab_size=len(jtok.vocab), **NARROW)
    host = _pt_batch()
    norm = {k: (v.astype(np.float32) if k in ("images", "image_views") else v)
            for k, v in host.items()}
    pt_vars = _drawn(jm, 2, jax.tree.map(jnp.asarray, norm))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(21, 64, 48, 1), dtype=np.uint8)
    images[17:] = images[:4]  # repeated images: exact activation ties
    ft_dir = work / "ft"
    ft_dir.mkdir()
    _finetune_data(ft_dir)
    pt_dir = work / "pt"
    pt_dir.mkdir()
    tiny = jax.tree.map(np.array, jt.variables)
    inputs = {
        "mean": MEAN, "std": STD, "pos_weight": POS_WEIGHT,
        "tower": efficientnet_from_jax(tiny["params"], tiny["batch_stats"]),
        "harvest_kw": HARVEST_KW, "harvest_layers": HARVEST_LAYERS,
        "small": SMALL, "small_state": breastclip_from_jax(jax.tree.map(np.array, jd.variables)),
        "resident_cfg": RESIDENT_CFG, "resident_images": images,
        "ft_state": classifier_from_jax(jax.tree.map(np.array, ft_vars)),
        "ft_batches": _u8_batches(1, (8, 8, 5)), "b0_batches": _u8_batches(4, (8, 6)),
        "pt_state": breastclip_from_jax(jax.tree.map(np.array, pt_vars)),
        "pt_vocab": len(jtok.vocab), "pt_narrow": NARROW, "pt_batch": host,
        "finetune_dir": str(ft_dir), "pretrain_argv": _pretrain_data(pt_dir),
    }
    torch.save(inputs, work / "inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(port), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    handle = _Ranks(procs, work, {"target": jt, "dissector": jd, "ft": (module, ft_vars),
                                  "pt": (jm, pt_vars, host), "inputs": inputs})
    try:
        _references(handle.jax, work)  # while the ranks run
        yield handle
    finally:
        handle.close()


def _references(ref, work):
    """What the ranks' results are held to, computed in this process on threads (the
    compiles overlap): JAX's harvest, resident CSV, Trainer steps on a (2, 1) mesh and
    pretraining step on a (2, 2) mesh, and the port's single-process drop-connect
    steps."""
    inputs = ref["inputs"]

    def harvest():
        return {spec: jax_harvest(ref["target"], jax_probe(spec, **HARVEST_KW), HARVEST_LAYERS,
                                  "avg", 5) for spec in ("synthetic_u8", "synthetic")}

    def resident_csv():
        jcfg = JaxDissectConfig(activation_dir=str(work / "ja"), result_dir=str(work / "jr"),
                                wire_pack="off", **RESIDENT_CFG)
        probe = JaxArrayProbe(inputs["resident_images"], mean=0.3, std=0.25)
        return jax_run_dissection(jcfg, probe=probe, dissector=ref["dissector"],
                                  log=lambda *_: None)[1]

    def finetune():
        module, variables = ref["ft"]
        jlabels = jax.tree_util.tree_map_with_path(
            lambda path, _: "frozen" if [k.key for k in path[-2:]] == ["bn2", "bias"] else "train",
            variables["params"])
        jtr = JaxTrainer(module, variables,
                         jax_make_optimizer(1e-3, 1e-4, 2, 10, param_labels=jlabels),
                         loss_kind="bce", pos_weight=POS_WEIGHT, input_wire="u8", norm_mean=MEAN,
                         norm_std=STD, mesh=jax_make_mesh(jax.devices()[:2]))
        losses = [jtr.train_batch(u8, y, n) for u8, y, n in inputs["ft_batches"]]
        return losses, classifier_from_jax(jax.tree.map(np.array, jtr.variables))

    def pt_step():
        # JAX's step on a (2, 2) mesh, data- and tensor-parallel at once (one compile:
        # under global view every mesh computes the same step)
        jm, variables, host = ref["pt"]
        tx = jax_make_optimizer(1e-3, 1e-4, 0, 10,
                                param_labels=_jax_frozen_labels(variables["params"]))
        mesh = jax_make_mesh(jax.devices()[:4], model_parallel=2)
        step = jit_clip_train_step(jm, tx, mesh, tensor_parallel=True, variables=variables,
                                   label_smoothing=0.1, input_wire="u8", norm_mean=MEAN,
                                   norm_std=STD)
        with mesh:
            params, stats, _, loss = step(variables["params"], variables["batch_stats"],
                                          tx.init(variables["params"]),
                                          jax.tree.map(jnp.asarray, host), jax.random.PRNGKey(3))
        return params, stats, loss

    def dropconnect():
        model = BreastClipClassifierModule("efficientnet-b0", n_class=1, bn_momentum=0.9,
                                           pad_mode="same")
        init_weights(model, torch.Generator().manual_seed(0))
        tr = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.01), loss_kind="bce",
                     input_wire="u8", norm_mean=MEAN, norm_std=STD, seed=5, device="cpu")
        return ([tr.train_batch(u8, y, n) for u8, y, n in inputs["b0_batches"]],
                model.state_dict())

    jobs = {f.__name__: f for f in (pt_step, finetune, dropconnect, harvest, resident_csv)}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(f) for name, f in jobs.items()}
    ref.update({name: f.result() for name, f in futures.items()})


# ------------------------------------------------------------- the 2-rank group
@pytest.mark.parametrize("spec", ["synthetic_u8", "synthetic"])
def test_staged_harvest_over_two_ranks_matches_jax(ranks, spec):
    """Each rank harvests its shard (7 of the 13 images, the last repeated) at batch
    5 // 2; the gathered layers, trimmed to 13 rows in probe order, equal JAX's
    single-process harvest within 1e-5 of the largest entry."""
    want, jn = ranks.jax["harvest"][spec]
    (got, n), (got1, n1) = ranks.result(0)[f"harvest_{spec}"], ranks.result(1)[f"harvest_{spec}"]
    assert n == n1 == jn == 13
    for layer in HARVEST_LAYERS:
        assert got[layer].shape == want[layer].shape == (13, want[layer].shape[1])
        np.testing.assert_array_equal(got[layer], got1[layer])
        np.testing.assert_allclose(got[layer], want[layer], rtol=0,
                                   atol=1e-5 * np.abs(want[layer]).max())


def test_resident_csv_over_two_ranks_matches_jax(ranks):
    """21 images (11 a rank, the last repeated): both ranks score the gathered rows
    and hold the same frame, the first writes the CSV; its descriptions and top
    images equal JAX's, its similarities within 1e-4."""
    jpath = ranks.jax["resident_csv"]
    r0, r1 = ranks.result(0)["resident"], ranks.result(1)["resident"]
    assert r1["csv_path"] is None and r0["df"] == r1["df"]
    assert any("[resident] gathered 21 rows from 2 rank shards" in l for l in r0["logs"])
    assert any("_host0of2" in f for f in r0["spills"])
    assert any("_host1of2" in f for f in r1["spills"])
    df, jdf = pd.read_csv(r0["csv_path"]), pd.read_csv(jpath)
    assert len(df) == 280 and list(df["layer"]) == list(jdf["layer"])
    assert list(df["description"]) == list(jdf["description"])
    assert list(df["images"]) == list(jdf["images"])
    sim, jsim = (np.array([json.loads(s) for s in d["similarity"]]) for d in (df, jdf))
    np.testing.assert_allclose(sim, jsim, rtol=1e-4, atol=1e-4 * np.abs(jsim).max())


def test_dp_finetune_steps_match_jax_on_a_2x1_mesh(ranks):
    """Three steps of the global batch of 8 (4 a rank; the last batch has 5 real rows:
    1 on the second rank) against JAX's Trainer on a (2, 1) mesh: the losses, every
    parameter and the BatchNorm running statistics, at test_torch_finetune.py's
    tolerances. The ranks end equal."""
    want, final = ranks.jax["finetune"]
    (losses, state), (losses1, state1) = ranks.result(0)["finetune"], ranks.result(1)["finetune"]
    assert losses == losses1
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for k in final:
        assert torch.equal(state[k], state1[k]), k
        np.testing.assert_allclose(state[k].numpy(), final[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_dp_steps_with_drop_connect_equal_the_single_process_steps(ranks):
    """EfficientNet-B0 (residual blocks: drop-connect masks in every step): two SGD
    steps (lr 0.01; the second batch has 6 real rows, 2 on the second rank) on 2 ranks
    equal two single-process steps on the global batch. The masks are drawn for the
    global batch and sliced by rank (local draws would differ). Tolerance: float32 in
    another summation order through 16 blocks, the global BatchNorm moments combined
    from the ranks' (losses 1e-4; weights 2e-5 + 1e-4 |w|, test_torch_pretrain.py's)."""
    want, single = ranks.jax["dropconnect"]
    losses, state = ranks.result(0)["dropconnect"]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    for k, v in single.items():
        err = (state[k].float() - v.float()).abs()
        assert bool((err <= 2e-5 + 1e-4 * v.float().abs()).all()), (k, float(err.max()))


def _assert_step_matches(got_state, got_loss, jloss, params, stats, start, grads):
    """test_torch_pretrain.py's comparison of one step: the loss within 1e-5, every
    parameter and statistic within 2e-5 + 1e-4 |v|, entries whose gradient is within
    rounding of 0 within 2 lr."""
    np.testing.assert_allclose(got_loss, float(jloss), rtol=1e-5)
    want = breastclip_from_jax(jax.tree.map(np.array, {"params": params, "batch_stats": stats}))
    assert set(want) == {k for k in got_state if not k.endswith("num_batches_tracked")}
    moved = noise = 0
    for k, v in want.items():
        moved += not torch.equal(v, start[k])
        err = (got_state[k] - v).abs()
        tol = 2e-5 + 1e-4 * v.abs()
        g = grads.get(k)
        if g is not None:
            near_zero = (g.abs() <= 1e-6 * g.abs().max()) & (g != 0)
            noise += int(near_zero.sum())
            tol = torch.where(near_zero, torch.full_like(tol, 2e-3), tol)
        assert bool((err <= tol).all()), (k, float(err.max()))
    assert moved > 0.8 * len(want)
    assert noise <= 1e-4 * sum(v.numel() for v in want.values()), noise


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_pretrain_step_over_two_ranks_matches_jax(ranks, kind):
    """One contrastive step (both views, label smoothing 0.1, AdamW 1e-3) of the
    global batch of 6 against `jit_clip_train_step` on a (2, 2) mesh with JAX's
    tensor-parallel plan: the port data-parallel on 2 ranks (3 rows a rank: the
    embeddings gathered, the in-batch labels over the global batch), and
    tensor-parallel on a (1, 2) mesh (BERT and the heads split, the state gathered to
    whole tensors)."""
    params, stats, jloss = ranks.jax["pt_step"]
    r0, r1 = ranks.result(0)[f"pretrain_{kind}"], ranks.result(1)[f"pretrain_{kind}"]
    assert r0["loss"] == r1["loss"]
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    grads = ranks.result(0)["pretrain_dp"]["grads"]  # the same step's gradients
    _assert_step_matches(r0["state"], r0["loss"], jloss, params, stats,
                         ranks.jax["inputs"]["pt_state"], grads)
    if kind == "tp":
        split = {k: tuple(v.shape) for k, v in r0["state"].items()}
        for name, dim in r0["plan"].items():
            assert r0["local_shapes"][name][dim] * 2 == split[name][dim], name
        assert "text_encoder.embeddings.word_embeddings.weight" in r0["plan"] or \
            ranks.jax["inputs"]["pt_vocab"] % 2


def test_collectives_over_two_ranks(ranks):
    """gather_predictions of 4 + 4 rows trimmed to 7; all_gather_with_grad's forward
    (rank order) and backward (the gradient summed over the ranks, this rank's
    slice); the drop-connect masks of a data-parallel forward (the global draw's
    rows of each rank)."""
    w = torch.arange(12.0).reshape(6, 2)
    full = drop_connect_mask(8, 0.5, torch.device("cpu"), torch.Generator().manual_seed(7))
    for r in range(2):
        res = ranks.result(r)
        np.testing.assert_array_equal(res["gather_predictions"], np.arange(7, dtype=np.float32))
        gathered, grad = res["all_gather_with_grad"]
        torch.testing.assert_close(gathered, torch.cat([torch.arange(6.0).reshape(3, 2),
                                                        torch.arange(6.0).reshape(3, 2) * 2]))
        torch.testing.assert_close(grad, 2 * w[3 * r:3 * r + 3])
        assert torch.equal(res["masks"], full[4 * r:4 * r + 4])


def test_model_parallel_2_trains_under_the_process_group(ranks):
    """do_experiments(model_parallel=2) fine-tunes on a (1, 2) mesh and the first rank
    writes the checkpoint and the out-of-fold CSV; cli.pretrain --model-parallel 2
    trains the split model and its final.pth holds the whole tensors: it loads as
    the single-GPU dissector."""
    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.models.breastclip import default_model_config
    from mammodissect_torch.train.checkpoints import load_checkpoint

    oof = ranks.result(0)["do_experiments"]
    assert oof == ranks.result(1)["do_experiments"]
    assert len(oof["prediction"]) == 4 and np.isfinite(oof["prediction"]).all()
    assert [p.name for p in (ranks.work / "ft_ck").iterdir()] == \
        ["mammodissect_clf_seed_10_fold0_best_Mass_ver1.pth"]
    assert (ranks.work / "ft_out" / "oof_predictions.csv").exists()
    assert ranks.result(0)["pretrain_cli"] == ranks.result(1)["pretrain_cli"] == 0
    ckpt = load_checkpoint(str(ranks.work / "pt" / "ck" / "final.pth"))
    assert ckpt["step"] == 2
    cfg = default_model_config()
    cfg["image_encoder"]["variant"] = "efficientnet-test"
    dissector = get_dissector("breastclip", ckpt_path=str(ranks.work / "pt" / "ck" / "final.pth"),
                              model_config=cfg, bert_layers=1, device="cpu")
    state = dissector.module.state_dict()
    assert all(torch.equal(state[k], v) for k, v in ckpt["model"].items())
    assert ckpt["model"]["text_encoder.encoder.layer.0.intermediate.dense.weight"].shape == \
        (3072, 768)
    emb = dissector.embed_images(np.zeros((2, 32, 24, 1), np.float32))
    assert emb.shape == (2, 512) and np.isfinite(emb).all()


# ------------------------------------------------------------------ in process
@pytest.mark.parametrize("n,count,index", [(13, 2, 0), (13, 2, 1), (7, 3, 2), (5, 4, 3),
                                           (1, 2, 1), (8, 4, 2)])
def test_host_sharded_probe_matches_jax(n, count, index):
    """Contiguous shards of ceil(n / count), the last repeating the final image;
    image_spans mirrors the base probe as an instance attribute."""
    images = np.random.default_rng(n).integers(0, 256, (n, 4, 3, 1), dtype=np.uint8)
    base, jbase = ArrayProbe(images, mean=0.3, std=0.25), JaxArrayProbe(images, mean=0.3, std=0.25)
    base.image_spans = jbase.image_spans = lambda i: (np.full(4, i), np.full(4, i + 1))
    got, want = HostShardedProbe(base, index, count), JaxHostShardedProbe(jbase, index, count)
    assert (len(got), got.per_host, got.mean, got.std) == (len(want), want.per_host, 0.3, 0.25)
    assert [got._base_index(i) for i in range(len(got))] == \
        [want._base_index(i) for i in range(len(want))]
    for i in range(len(got)):
        np.testing.assert_array_equal(got.image_u8(i), want.image_u8(i))
        np.testing.assert_array_equal(got.image_spans(i)[0], want.image_spans(i)[0])
    assert "image_spans" in vars(got)
    assert not hasattr(HostShardedProbe(ArrayProbe(images), index, count), "image_spans")


@pytest.mark.parametrize("model_parallel", [2, 3])
def test_tensor_parallel_plan_matches_jax_param_shardings(model_parallel):
    """The (parameter, split dim) pairs of the port's plan on a tiny BreastClip equal
    those of JAX's `param_shardings(tensor_parallel=True)`, carried through
    convert.py's name map (a kernel [in, out] is the weight [out, in]); at 3 shards
    nothing divides and everything stays whole."""
    from mammodissect_torch.parallel.sharding import tensor_parallel_plan

    jm = JaxBreastClipModule(vocab_size=64, **NARROW)
    host = {k: jnp.asarray(v.astype(np.float32) if k.startswith("image") else v)
            for k, v in _pt_batch().items()}
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b), host)
    mesh = jax_make_mesh(jax.devices()[:6 if model_parallel == 3 else 8],
                         model_parallel=model_parallel)
    specs = param_shardings(mesh, shapes["params"], tensor_parallel=True)

    def marked(leaf, sharding):
        """0 everywhere; along a split dim, the index along it (found after the map)."""
        dims = [d for d, a in enumerate(sharding.spec) if a == "model"]
        x = np.zeros(leaf.shape, np.float32)
        if dims:
            shape = [1] * len(leaf.shape)
            shape[dims[0]] = leaf.shape[dims[0]]
            x = x + np.arange(leaf.shape[dims[0]], dtype=np.float32).reshape(shape)
        return x

    tagged = {"params": jax.tree.map(marked, shapes["params"], specs),
              "batch_stats": jax.tree.map(lambda l: np.zeros(l.shape, np.float32),
                                          shapes["batch_stats"])}
    want = set()
    for name, t in breastclip_from_jax(tagged).items():
        for d in range(t.dim()):
            if t.shape[d] > 1 and not bool((t == t.select(d, 0).unsqueeze(d)).all()):
                want.add((name, d))
    got = set(tensor_parallel_plan(BreastClipModule(vocab_size=64, **NARROW), model_parallel).items())
    assert got == want
    assert len(got) == (0 if model_parallel == 3 else 2 * 4 * 2 + 2 * 2 * 1 + 2 + 1)


def test_mesh_helpers_and_initialize_without_a_process_group(monkeypatch):
    from mammodissect_torch.parallel.mesh import (
        GlobalEnv,
        data_group,
        data_parallel_size,
        make_mesh,
        mesh_shape_for,
    )
    from mammodissect_torch.parallel.multihost import gather_predictions, initialize
    from mammodissect_torch.parallel.sharding import shard_batch

    assert mesh_shape_for(8, 2) == (4, 2) and mesh_shape_for(4) == (4, 1)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape_for(6, 4)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_LOCALID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize(num_processes=1) is False and initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert data_group() is None and data_parallel_size() == 1
    assert GlobalEnv.get() == GlobalEnv(1, 0, 0, torch.cuda.device_count(), True)
    monkeypatch.setenv("SLURM_LOCALID", "3")
    assert GlobalEnv.get().local_rank == 3
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(model_parallel=2)
    np.testing.assert_array_equal(gather_predictions(np.arange(5), 3), np.arange(3))
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    assert shard_batch(batch, rank=1, size=2)["b"].tolist() == [[8, 9], [10, 11], [12, 13],
                                                                [14, 15]]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(np.arange(5), rank=0, size=2)


# ------------------------------------------------------- configs and utilities
def test_load_config_and_overrides_on_the_ports_dataclasses(tmp_path):
    from mammodissect_torch.configs import apply_overrides, load_config, save_config
    from mammodissect_torch.dissect.engine import DissectConfig
    from mammodissect_torch.train.experiments import FinetuneConfig

    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"target_model": "tiny_cnn", "top_k": 42, "_comment": "a note"}))
    cfg = load_config(DissectConfig, str(p), overrides=["similarity_fn=wpmi", "top_k=7",
                                                        "resident=true", "device=cpu"])
    assert (cfg.target_model, cfg.top_k, cfg.similarity_fn, cfg.resident, cfg.device) == \
        ("tiny_cnn", 7, "wpmi", True, "cpu")
    assert apply_overrides({"a": {"b": 1}}, ["a.c=[1, 2]", "d=x"]) == \
        {"a": {"b": 1, "c": [1, 2]}, "d": "x"}
    p.write_text(json.dumps({"nonexistent_flag": 1}))
    with pytest.raises(ValueError, match="unknown config keys"):
        load_config(DissectConfig, str(p))
    with pytest.raises(ValueError, match="key=value"):
        apply_overrides({}, ["novalue"])
    ft = FinetuneConfig(label="Mass", img_size=(64, 48), BCE_weights={"fold0": 2.0})
    save_config(ft, str(tmp_path / "ft.json"))
    assert load_config(FinetuneConfig, str(tmp_path / "ft.json")) == ft


@pytest.mark.parametrize("name,cls,field,value", [
    ("dissect_mammoclip", "DissectConfig", "target_layers",
     [f"blocks.{i}" for i in range(39)]),
    ("finetune_vindr_mass", "FinetuneConfig", "img_size", (1520, 912)),
    ("zs_clip", "ZeroShotConfig", "tasks", ["Mass", "Suspicious_Calcification"]),
])
def test_presets_load_into_the_ports_dataclasses(name, cls, field, value):
    """The JAX package's three presets, copied byte for byte, each into its dataclass."""
    from mammodissect_torch.configs import ZeroShotConfig, load_preset
    from mammodissect_torch.configs.config import PRESETS
    from mammodissect_torch.dissect.engine import DissectConfig
    from mammodissect_torch.train.experiments import FinetuneConfig

    with open(os.path.join(PRESETS, f"{name}.json"), "rb") as f, \
            open(os.path.join(REPO, "mammodissect", "configs", "presets", f"{name}.json"),
                 "rb") as g:
        assert f.read() == g.read()
    classes = {"DissectConfig": DissectConfig, "FinetuneConfig": FinetuneConfig,
               "ZeroShotConfig": ZeroShotConfig}
    cfg = load_preset(classes[cls], name)
    assert getattr(cfg, field) == value


def test_get_paths_matches_jax(tmp_path):
    from mammodissect.utils.paths import get_Paths as jax_get_paths
    from mammodissect_torch.utils.paths import get_Paths

    args = types.SimpleNamespace(checkpoints=str(tmp_path / "ck"), output_path=str(tmp_path / "o"),
                                 tensorboard_path=str(tmp_path / "tb"), dataset="vindr",
                                 arch="b5", label="Mass")
    got = get_Paths(args)
    assert got == jax_get_paths(args) and all(p.is_dir() for p in got)
    assert get_Paths(types.SimpleNamespace(checkpoints=str(tmp_path / "d")))[0] == \
        tmp_path / "d" / "dataset" / "arch" / "label"


def test_debug_nans_names_the_first_module_with_a_nan():
    from mammodissect_torch.utils.profiling import enable_debug_nans

    class Log(torch.nn.Module):
        def forward(self, x):
            return torch.log(x)

    net = torch.nn.Sequential(torch.nn.Identity(), Log(), torch.nn.Sequential(Log()))
    x = torch.tensor([-1.0, 2.0])
    assert torch.isnan(net(x)).any()  # off: nothing checks
    enable_debug_nans()
    try:
        with pytest.raises(FloatingPointError, match=r"module '1' \(Log\)"):
            net(x)
        net(torch.tensor([2.0, 3.0]))
    finally:
        enable_debug_nans(False)
    assert torch.isnan(net(x)).any()


def test_phase_timer_matches_jax():
    from mammodissect.utils.profiling import PhaseTimer as JaxPhaseTimer
    from mammodissect_torch.utils.profiling import PhaseTimer

    timers = [PhaseTimer(), JaxPhaseTimer()]
    for t in timers:
        for name, s in (("a", 0.0), ("b", 0.02), ("a", 0.0)):
            with t.phase(name):
                time.sleep(s)
    got, want = (t.report() for t in timers)
    assert list(got) == list(want) == ["b", "a"] and got["b"] >= 0.02


def test_dissect_cli_wandb_debug_nans_and_profile(tmp_path, capsys, monkeypatch):
    """--wandb (a stand-in wandb module records the run: the reference driver's
    status events, the run name), --debug_nans (hooks on during the run, removed
    after) and --profile DIR (a Chrome trace in DIR/trace.json and the operator
    table) on the CPU; without wandb, --wandb is a no-op."""
    from mammodissect_torch.cli.dissect import main

    events, inits = [], []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: inits.append(kw) or types.SimpleNamespace(
        log=events.append, finish=lambda: events.append("finish"))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    argv = ["--target_model", "tiny_cnn", "--clip_model", "random",
            "--target_layers", "blocks.0,blocks.3", "--d_probe", "synthetic_u8",
            "--batch_size", "4", "--probe_kwargs", json.dumps({"n": 6, "h": 40, "w": 32}),
            "--concept_set", os.path.join(REPO, "tests", "assets", "tiny_concepts.txt"),
            "--device", "cpu", "--activation_dir", str(tmp_path / "a"),
            "--result_dir", str(tmp_path / "r"), "--wandb", "--wandb_name", "run1",
            "--debug_nans", "--profile", str(tmp_path / "prof")]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "Dissection done! 56 units described" in out and "Self CPU" in out
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    assert inits[0]["name"] == "run1" and inits[0]["project"] == "broader_clip-dissect"
    assert inits[0]["config"]["debug_nans"] is True
    assert {"status": "activations_saved"} in events
    assert [e for e in events if isinstance(e, dict) and "layer" in e] == [
        {"layer": "blocks.0", "similarity_calculated": True},
        {"layer": "blocks.3", "similarity_calculated": True}]
    assert events[-3:] == [{"status": "all_layers_processed"}, {"status": "results_saved"},
                           "finish"]
    from mammodissect_torch.utils import profiling

    assert profiling._NAN_HOOKS == []
    monkeypatch.delitem(sys.modules, "wandb")
    assert main(argv[:-3] + ["--activation_dir", str(tmp_path / "a2")]) == 0
