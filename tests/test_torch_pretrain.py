"""Contrastive pretraining in the PyTorch port against the JAX package, on the CPU:
one `make_clip_train_step` update against JAX's on carried weights (efficientnet-test
tower, a 2-layer narrow BERT, the toy vocab), BERT's gradient checkpoint, the
image-text datasets byte for byte, the DataModule, the label maps, and
`cli.pretrain` end to end with its `final.pth` loading as a dissector."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from PIL import Image

from mammodissect.data import imagetext as J
from mammodissect.models.breastclip import BreastClipModule as JaxBreastClipModule
from mammodissect.models.tokenizers import WordPieceTokenizer as JaxWordPiece
from mammodissect.train.clip_trainer import make_clip_train_step as jax_make_step
from mammodissect.train.trainer import make_optimizer as jax_make_optimizer
from mammodissect_torch.convert import breastclip_from_jax
from mammodissect_torch.data import imagetext as P
from mammodissect_torch.models.breastclip import BreastClipModule
from mammodissect_torch.models.tokenizers import WordPieceTokenizer
from mammodissect_torch.train.clip_trainer import batch_to_device, make_clip_train_step
from mammodissect_torch.train.trainer import make_optimizer

PROMPTS = {
    "Mass": {"pos_right": ["mass right"], "pos_left": ["mass left"],
             "neg_right": ["no mass right"], "neg_left": ["no mass left"]},
    "No Finding": {"pos_right": ["clear right"], "pos_left": ["clear left"],
                   "neg_right": [], "neg_left": []},
}
WORDS = ["mass", "right", "left", "no", "clear"]
HW = (64, 48)
MEAN, STD = 0.3089279, 0.25053555
NARROW = dict(image_variant="efficientnet-test", bert_layers=2, bert_hidden=32, bert_heads=2,
              bert_intermediate=64, proj_dim=16)


@pytest.fixture(scope="module")
def multiview(tmp_path_factory):
    """10 patients, a CC and an MLO PNG each (40x30, resized by the loader), with
    *_FINDING labels (as tests/test_imagetext_pretrain.py) and a REPORT column."""
    root = tmp_path_factory.mktemp("torch_mv")
    rng = np.random.default_rng(0)
    rows = []
    for pid in range(10):
        os.makedirs(root / str(pid), exist_ok=True)
        for img in ("cc0.png", "mlo0.png"):
            arr = (rng.random((40, 30)) * 255).astype("uint8")
            Image.fromarray(arr).save(root / str(pid) / img)
        rows.append({
            "patient_id": pid, "laterality": "LR"[pid % 2], "view": "['CC', 'MLO']",
            "CC": "['cc0.png']", "MLO": "['mlo0.png']",
            "CC_FINDING": "[['Mass'], [], [], ['Mass']]",
            "MLO_FINDING": "[['No Finding'], [], ['Mass'], []]",
        })
    return pd.DataFrame(rows), str(root)


def _toks():
    return JaxWordPiece.toy(words=WORDS), WordPieceTokenizer.toy(words=WORDS)


# ------------------------------------------------------------------- the train step
def _jax_variables(module, batch, seed):
    """Variables drawn from their shapes: unit-preserving kernels, BN/LN scales and
    variances in [0.5, 1.5], biases, means and embeddings ~0.1, logit_scale log(1/0.07)."""
    shapes = jax.eval_shape(lambda b: module.init(jax.random.PRNGKey(0), b), batch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        if name == "kernel":
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _shift_invariant(name):
    """Parameters whose true gradient is 0, so that the computed one is rounding
    noise that Adam's first, sign-like step would turn into +-lr in any
    implementation: each block's project BatchNorm bias (a batch-statistics
    BatchNorm follows after a 1x1 convolution) and the attention key bias (q.b_k is
    constant over the keys, which the softmax removes). Frozen in both packages."""
    return name.endswith("_bn2.bias") or name.endswith("attention.self.key.bias")


def _jax_frozen_labels(params):
    def label(path, _):
        keys = [str(k.key) for k in path]
        frozen = keys[-2:] == ["bn2", "bias"] or keys[-3:] == ["attention", "key", "bias"]
        return "frozen" if frozen else "train"

    return jax.tree_util.tree_map_with_path(label, params)


def _host_batch(views, seed=1, b=6):
    """A collated u8 batch: images (and views), token ids of two texts."""
    rng = np.random.default_rng(seed)
    jtok, _ = _toks()
    texts = ["mass right", "clear left", "no mass left", "mass left no mass right",
             "clear right", "mass"][:b]
    t1 = jtok(texts, max_length=12)
    t2 = jtok(texts[::-1], max_length=12)
    batch = {"images": rng.integers(0, 256, (b, *HW, 1), dtype=np.uint8),
             "input_ids": t1["input_ids"], "attention_mask": t1["attention_mask"]}
    if views:
        batch.update(image_views=rng.integers(0, 256, (b, *HW, 1), dtype=np.uint8),
                     input_ids2=t2["input_ids"], attention_mask2=t2["attention_mask"])
    return batch


@pytest.mark.parametrize("views,smoothing", [(True, 0.1), (False, 0.0)])
def test_train_step_matches_jax(views, smoothing):
    """One update of the port's `make_clip_train_step` and of JAX's on the same
    weights and uint8 batch (normalized on the device), float32: the loss, every
    parameter and every BatchNorm running statistic. With the second text view and
    the image view (i2i 1.0, t2t 0.5) and label smoothing 0.1, and without either.
    AdamW 1e-3, weight decay 1e-4, no warmup. Tolerance: float32 forward and
    backward in another summation order (rtol 1e-4, atol 2e-5). Adam's first step
    is lr * g / (|g| + 1e-8): an entry whose gradient is within rounding of 0 but
    not 0 (at most 1e-6 of its tensor's largest, a handful of entries, the port's
    gradient read after the step) may move by anything up to lr in either package,
    so it is held within 2 lr."""
    jtok, _ = _toks()
    jm = JaxBreastClipModule(vocab_size=len(jtok.vocab), **NARROW)
    host = _host_batch(views)
    norm = {k: (v.astype(np.float32) if k in ("images", "image_views") else v)
            for k, v in host.items()}
    variables = _jax_variables(jm, jax.tree.map(jnp.asarray, norm), seed=2)
    tx = jax_make_optimizer(1e-3, 1e-4, 0, 10, param_labels=_jax_frozen_labels(variables["params"]))
    jstep = jax.jit(jax_make_step(jm, tx, label_smoothing=smoothing, input_wire="u8",
                                  norm_mean=MEAN, norm_std=STD))
    params, stats, _, jloss = jstep(variables["params"], variables["batch_stats"],
                                    tx.init(variables["params"]),
                                    jax.tree.map(jnp.asarray, host), jax.random.PRNGKey(3))

    model = BreastClipModule(vocab_size=len(jtok.vocab), **NARROW)
    start = breastclip_from_jax(jax.tree.map(np.array, variables))
    model.load_state_dict(start)
    labels = {k: "frozen" if _shift_invariant(k) else "train" for k, _ in model.named_parameters()}
    assert sum(v == "frozen" for v in labels.values()) == 7 + 2
    optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 0, 10, param_labels=labels)
    step = make_clip_train_step(model, optimizer, scheduler, label_smoothing=smoothing,
                                input_wire="u8", norm_mean=MEAN, norm_std=STD,
                                generator=torch.Generator().manual_seed(3))
    loss = step(batch_to_device(host, torch.device("cpu")))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = breastclip_from_jax(jax.tree.map(np.array, {"params": params, "batch_stats": stats}))
    state = model.state_dict()
    assert set(want) == {k for k in state if not k.endswith("num_batches_tracked")}
    grads = {k: p.grad for k, p in model.named_parameters()}
    moved = noise = 0
    for k, v in want.items():
        moved += not torch.equal(v, start[k])
        err = (state[k] - v).abs()
        tol = 2e-5 + 1e-4 * v.abs()
        g = grads.get(k)
        if g is not None:
            near_zero = (g.abs() <= 1e-6 * g.abs().max()) & (g != 0)
            noise += int(near_zero.sum())
            tol = torch.where(near_zero, torch.full_like(tol, 2e-3), tol)
        assert bool((err <= tol).all()), (k, float(err.max()))
    assert moved > 0.8 * len(want)
    assert noise <= 1e-4 * sum(v.numel() for v in want.values()), noise


def _module_pairs(variables):
    """{port module name: flax module path} for every module that holds parameters:
    each flax module's variables are filled with its index and carried across by
    `breastclip_from_jax`, which moves every value of a module into one port module."""
    paths = []

    def tag(path, leaf):
        module = tuple(str(p.key) for p in path[1:-1])  # drop the collection and the leaf
        if module not in paths:
            paths.append(module)
        return np.full(leaf.shape, paths.index(module), np.float32)

    tagged = breastclip_from_jax(jax.tree_util.tree_map_with_path(tag, jax.tree.map(np.array, variables)))
    pairs = {}
    for key, value in tagged.items():
        (index,) = set(np.unique(value.numpy()).astype(int).tolist())
        pairs.setdefault(key.rsplit(".", 1)[0], set()).add(paths[index])
    assert all(len(v) == 1 for v in pairs.values())
    return {k: v.pop() for k, v in pairs.items() if k != "logit_scale"}


def _flax_outputs(intermediates):
    """{flax module path: its first output} from `capture_intermediates`."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if key == "__call__":
                out[path] = jax.tree_util.tree_leaves(value[0])[0]
            else:
                walk(value, path + (key,))

    walk(intermediates, ())
    return out


def _sgd_step(model_or_module, host, start, variables=None):
    """One step with SGD at lr 0.01 (so that each weight moves by its gradient):
    (loss, {name: gradient}, {name: BatchNorm statistic}) in the port's names."""
    lr = 0.01
    if variables is not None:
        tx = optax.sgd(lr)
        step = jax.jit(jax_make_step(model_or_module, tx, label_smoothing=0.1, input_wire="u8",
                                     norm_mean=MEAN, norm_std=STD))
        params, stats, _, loss = step(variables["params"], variables["batch_stats"],
                                      tx.init(variables["params"]),
                                      jax.tree.map(jnp.asarray, host), jax.random.PRNGKey(3))
        state = breastclip_from_jax(jax.tree.map(np.array, {"params": params, "batch_stats": stats}))
    else:
        optimizer = torch.optim.SGD(model_or_module.parameters(), lr=lr)
        step = make_clip_train_step(model_or_module, optimizer, label_smoothing=0.1,
                                    input_wire="u8", norm_mean=MEAN, norm_std=STD,
                                    generator=torch.Generator().manual_seed(3))
        loss = step(batch_to_device(host, torch.device("cpu")))
        state = model_or_module.state_dict()
    running = {k for k in start if k.endswith(("running_mean", "running_var"))}
    grads = {k: (start[k] - state[k]) / lr for k in start
             if k not in running and not _shift_invariant(k)}
    return float(loss), grads, {k: state[k] for k in running}, state


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _distance(a, b):
    """The relative L2 distance of two {name: tensor} dicts taken as one vector."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return (num / sum(float((b[k] ** 2).sum()) for k in b)) ** 0.5


def test_bf16_train_step_matches_jax():
    """The mixed-precision step that pretraining runs (bf16 compute over float32
    master weights) against JAX's step with the module at dtype=bfloat16 over
    flax's float32 parameters, both views, label smoothing 0.1.

    - Casts: in the training forward every module that holds parameters (80: convs,
      BatchNorms, dense layers, LayerNorms, embeddings, projections) returns the
      dtype its flax counterpart returns (`capture_intermediates`), and after the
      step every weight and BatchNorm statistic is float32.
    - The first operations, on identical inputs, agree to float32 rounding: the
      embedding lookups exactly, the embeddings' bf16 sum through its LayerNorm and
      the bf16 stem conv within 1e-6 of the largest entry (summing the embeddings in
      float32 before the cast moves the LayerNorm's output by ~4e-3).
    - The step (SGD, so each weight's change is its gradient): XLA and PyTorch round
      bf16 elementwise ops differently (SiLU, GELU, a dense layer's bias add: one
      rounding or two), and the narrow tower's batch statistics over 6 images
      amplify it, so the two bf16 steps are two independent bf16 roundings of the
      float32 step. Measured on the CPU, as distances relative to JAX's bf16 step
      from the float32 step: the port's bf16 step from the float32 step 0.96
      (gradients) and 0.98 (BatchNorm statistics), the two bf16 steps from each
      other 1.34 and 1.18. Held: the first within [0.5, 2] (an image tower left in
      float32 reads 0.05), the second at most 2, the loss within 2e-2 of JAX's
      (1.1e-2 measured; bf16's epsilon is 7.8e-3)."""
    jtok, _ = _toks()
    host = _host_batch(True)
    floats = {k: (v.astype(np.float32) / 255 if k in ("images", "image_views") else v)
              for k, v in host.items()}
    jax_module = {d: JaxBreastClipModule(vocab_size=len(jtok.vocab), dtype=d, **NARROW)
                  for d in (jnp.float32, jnp.bfloat16)}
    variables = _jax_variables(jax_module[jnp.float32], jax.tree.map(jnp.asarray, floats), seed=2)
    start = breastclip_from_jax(jax.tree.map(np.array, variables))

    def port(dtype):
        model = BreastClipModule(vocab_size=len(jtok.vocab), dtype=dtype,
                                 param_dtype=torch.float32, **NARROW)
        model.load_state_dict(start)
        return model

    # the casts, in one training forward
    _, flax_state = jax_module[jnp.bfloat16].apply(
        variables, jax.tree.map(jnp.asarray, floats), train=True,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True)
    flax_out = _flax_outputs(flax_state["intermediates"])
    model = port(torch.bfloat16)
    port_out = {}
    for name, m in model.named_modules():
        if name and list(m.parameters(recurse=False)):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: port_out.setdefault(name, out.detach()))
    batch = {k: torch.from_numpy(v) if k in ("images", "image_views") else torch.from_numpy(v).long()
             for k, v in floats.items()}
    model.train()(batch, generator=torch.Generator().manual_seed(0))
    pairs = _module_pairs(variables)
    assert len(pairs) == 80
    dtypes = {name: (str(port_out[name].dtype).split(".")[-1], str(flax_out[path].dtype))
              for name, path in pairs.items()}
    assert all(p == f for p, f in dtypes.values()), {k: v for k, v in dtypes.items() if v[0] != v[1]}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        got = port_out[f"text_encoder.embeddings.{name}"].float().numpy()
        np.testing.assert_array_equal(got, np.asarray(
            flax_out[("text_encoder", name)].astype(jnp.float32)).reshape(got.shape))
    for name, path in (("text_encoder.embeddings.LayerNorm", ("text_encoder", "embeddings_norm")),
                       ("image_encoder._conv_stem", ("image_encoder", "backbone", "stem_conv"))):
        got = port_out[name].float()
        got = got.permute(0, 2, 3, 1) if got.ndim == 4 else got
        assert _rel_err(got.numpy(), flax_out[path].astype(jnp.float32)) <= 1e-6, name

    # the step
    jax32 = _sgd_step(jax_module[jnp.float32], host, start, variables)
    jax16 = _sgd_step(jax_module[jnp.bfloat16], host, start, variables)
    model = port(torch.bfloat16)
    port16 = _sgd_step(model, host, start)
    assert {v.dtype for v in port16[3].values() if v.is_floating_point()} == {torch.float32}
    for i, what in ((1, "gradients"), (2, "BatchNorm statistics")):
        noise = _distance(jax16[i], jax32[i])
        assert 0.5 <= _distance(port16[i], jax32[i]) / noise <= 2, what
        assert _distance(port16[i], jax16[i]) / noise <= 2, what
    assert abs(port16[0] - jax16[0]) <= 2e-2 * abs(jax16[0]), (port16[0], jax16[0])


def test_bert_checkpoint_gives_the_gradients_of_no_checkpoint():
    """BERT's gradient checkpoint (`text_encoder.gradient_checkpointing`): the same
    loss and gradients of every parameter as without it, in one training forward
    and backward of the narrow BreastClip with both views."""
    _, tok = _toks()
    batch = batch_to_device(_host_batch(True), torch.device("cpu"))
    batch = {k: v.float() / 255 if k in ("images", "image_views") else v for k, v in batch.items()}
    base = BreastClipModule(vocab_size=len(tok.vocab), **NARROW).state_dict()
    grads = {}
    for remat in (False, True):
        model = BreastClipModule(vocab_size=len(tok.vocab), grad_checkpoint=remat, **NARROW)
        model.load_state_dict(base)
        assert model.text_encoder.encoder.grad_checkpoint is remat
        out = model.train()(batch, generator=torch.Generator().manual_seed(0))
        loss = (out["image_embeddings"] * out["text_embeddings"]).sum() \
            + (out["text_embeddings2"] * out["image_view_embeddings"]).sum()
        loss.backward()
        grads[remat] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()})
    torch.testing.assert_close(grads[True][0], grads[False][0])
    text = [k for k in grads[False][1] if k.startswith("text_encoder.encoder.")]
    assert text and all(grads[False][1][k] is not None for k in text)
    for k, g in grads[False][1].items():
        torch.testing.assert_close(grads[True][1][k], g, msg=k)


def test_forward_outputs_and_config_keys():
    """The training forward's outputs (labels arange(B), exp(logit_scale), the
    second views only when both are in the batch); `BreastClip.create` reads
    `text_encoder.gradient_checkpointing` and accepts `image_encoder.s2d_stem`; a
    `param_dtype` of float32 under bf16 compute keeps float32 weights; the MLP
    head's dropout comes from the generator (the same seed, the same masks)."""
    from mammodissect_torch.models.breastclip import BreastClip, default_model_config

    _, tok = _toks()
    host = _host_batch(True)
    batch = {k: (torch.from_numpy(v).float() / 255 if k in ("images", "image_views")
                 else torch.from_numpy(v).long()) for k, v in host.items()}
    model = BreastClipModule(vocab_size=len(tok.vocab), **NARROW).eval()
    with torch.no_grad():
        out = model(batch)
        no_views = model({k: v for k, v in batch.items() if k != "image_views"})
    assert torch.equal(out["labels"], torch.arange(6))
    torch.testing.assert_close(out["logit_scale"], torch.tensor(1 / 0.07))
    assert set(out) == {"image_embeddings", "text_embeddings", "labels", "logit_scale",
                        "text_embeddings2", "image_view_embeddings"}
    assert set(no_views) == {"image_embeddings", "text_embeddings", "labels", "logit_scale"}
    torch.testing.assert_close(out["image_embeddings"].norm(dim=1), torch.ones(6))

    cfg = default_model_config()
    cfg["image_encoder"].update(variant="efficientnet-test", s2d_stem=True)
    cfg["text_encoder"]["gradient_checkpointing"] = True
    cfg["projection_head"]["name"] = "mlp"
    clip = BreastClip.create(model_config=cfg, bert_layers=1, vocab_size=len(tok.vocab),
                             device="cpu", dtype=torch.bfloat16, param_dtype=torch.float32)
    m = clip.module
    assert m.text_encoder.encoder.grad_checkpoint
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    m.train()
    runs = [m(batch, generator=torch.Generator().manual_seed(s)) for s in (4, 4, 5)]
    assert runs[0]["image_embeddings"].dtype == torch.float32  # normalized in float32
    torch.testing.assert_close(runs[0]["text_embeddings"], runs[1]["text_embeddings"])
    assert not torch.allclose(runs[0]["text_embeddings"], runs[2]["text_embeddings"])


def test_mesh_and_tensor_parallel_name_item_17():
    """Without a process group the step is a single process's, and a mesh (data or
    tensor parallelism) raises, saying to launch with torchrun; under one, both train
    (tests/test_torch_parallel.py)."""
    from mammodissect_torch.parallel.mesh import make_mesh

    model = BreastClipModule(vocab_size=64, **NARROW)
    optimizer, _ = make_optimizer(model, 1e-3, 0.0, 0, 10)
    step = make_clip_train_step(model, optimizer)
    assert callable(step) and not torch.distributed.is_initialized()
    for model_parallel in (1, 2):
        with pytest.raises(RuntimeError, match="torchrun"):
            make_mesh(model_parallel=model_parallel)


# ---------------------------------------------------------------------- the datasets
@pytest.mark.parametrize("wire", ["f32", "u8"])
@pytest.mark.parametrize("split", ["train", "valid"])
def test_imagetext_batches_match_jax(multiview, wire, split):
    """ImageTextDataset.batches against the JAX package's, same seeds: every array
    byte for byte and the same texts (view and path draws, the augmentation of the
    train split, the generated reports)."""
    df, root = multiview
    jtok, tok = _toks()
    kw = dict(root=root, size_hw=(32, 24), prompt_json=PROMPTS, split=split, seed=3, wire=wire)
    got = list(P.ImageTextDataset(df, **kw).batches(tok, 4, max_length=16, seed=5))
    want = list(J.ImageTextDataset(df, **kw).batches(jtok, 4, max_length=16, seed=5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["images"].dtype == (np.uint8 if wire == "u8" else np.float32)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
            else:
                assert g[k] == w[k], k


def test_imagetext_host_slices_match_jax(multiview):
    """Two processes' slices of each batch: the same rows as the JAX package's."""
    df, root = multiview
    jtok, tok = _toks()
    kw = dict(root=root, size_hw=(32, 24), prompt_json=PROMPTS, split="valid")
    for host in (0, 1):
        got = list(P.ImageTextDataset(df, **kw).batches(tok, 4, max_length=16, seed=5,
                                                         host_index=host, host_count=2))
        want = list(J.ImageTextDataset(df, **kw).batches(jtok, 4, max_length=16, seed=5,
                                                          host_index=host, host_count=2))
        assert [g["texts"] for g in got] == [w["texts"] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["images"], w["images"])
    with pytest.raises(ValueError, match="divide evenly"):
        next(P.ImageTextDataset(df, **kw).batches(tok, 3, host_count=2))


def test_sibling_datasets_match_jax(multiview, tmp_path):
    """The grouped (report sentences), contrastive-sentence, retrieval and aligner
    datasets and `segment_report` against the JAX package's on the same rows."""
    df, root = multiview
    reports = df.assign(REPORT=["['Mass in the right breast. Dense tissue.', 'No change.']"] * 10)
    kw = dict(root=root, size_hw=(32, 24), prompt_json=PROMPTS, split="train", seed=1)
    g = P.GroupedImageTextDataset(reports, **kw)
    jg = J.GroupedImageTextDataset(reports, **kw)
    assert len(g) == len(jg) == 10
    for i in range(3):
        a, b = g[i], jg[i]
        assert (a["text"], a["text2"]) == (b["text"], b["text2"])
        np.testing.assert_array_equal(a["image"], b["image"])
    text = "Mass in the right breast.  Dense\ntissue! ok. Two words"
    assert P.segment_report(text) == J.segment_report(text)

    flat = pd.DataFrame({"image_path": [f"{p}/cc0.png" for p in range(4)],
                         "REPORT": ["['a mass.', 'no mass.']", "['clear.']"] * 2,
                         "BIRADS": [1, 2, 3, 4], "label_text": ["mass", "clear"] * 2,
                         "clip_image_path": [f"{p}/cc0.png" for p in range(4)],
                         "clf_image_path": [f"{p}/mlo0.png" for p in range(4)],
                         "age": [50, 60, 70, 80]})
    pairs = [(P.ContrastiveSentenceDataset(flat, root=root, size_hw=(32, 24), seed=2),
              J.ContrastiveSentenceDataset(flat, root=root, size_hw=(32, 24), seed=2)),
             (P.RetrievalDataset(flat, root=root, size_hw=(32, 24)),
              J.RetrievalDataset(flat, root=root, size_hw=(32, 24))),
             (P.ImageAlignerDataset(flat[["clip_image_path", "clf_image_path", "age"]],
                                    root=root, size_hw=(32, 24)),
              J.ImageAlignerDataset(flat[["clip_image_path", "clf_image_path", "age"]],
                                    root=root, size_hw=(32, 24)))]
    for ours, theirs in pairs:
        for i in range(4):
            a, b = ours[i], theirs[i]
            assert set(a) == set(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
                else:
                    assert a[k] == b[k], k


def test_load_dataset_matches_jax(multiview, tmp_path):
    """The factory: each type of `DATASET_TYPES`, `image_classification` as the
    fine-tune dataset, `image_classification_zs` as the CSV probe with JAX's kwargs
    check, an unknown type raising KeyError (tests/test_imagetext_pretrain.py)."""
    from mammodissect_torch.data.probes import CsvProbe
    from mammodissect_torch.train.data import ClassifierDataset

    df, root = multiview
    ds = P.load_dataset("imagetext", df=df, root=root, size_hw=(32, 24), prompt_json=PROMPTS)
    assert isinstance(ds, P.ImageTextDataset) and len(ds) == 10
    assert set(P.DATASET_TYPES) == set(J.DATASET_TYPES)
    flat = pd.DataFrame({"image_path": ["0/cc0.png", "1/cc0.png"], "cancer": [0, 1]})
    clf = P.load_dataset("image_classification", df=flat, root=root, size_hw=(32, 24))
    assert isinstance(clf, ClassifierDataset) and clf.label(1) == 1
    zs = P.load_dataset("image_classification_zs", df=flat, root=root, size_hw=(32, 24),
                        label_col="cancer")
    assert isinstance(zs, CsvProbe) and len(zs) == 2
    for mod in (P, J):
        with pytest.raises(TypeError, match="unsupported kwargs"):
            mod.load_dataset("image_classification_zs", df=flat, wire="u8")
        with pytest.raises(KeyError):
            mod.load_dataset("no_such_type")


@pytest.fixture
def img_csv(tmp_path):
    """12 PNGs at 48x36 and a CSV with a `split` column: 8 training, 4 test."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        Image.fromarray((rng.random((48, 36)) * 255).astype(np.uint8)).save(tmp_path / f"i{i}.png")
        rows.append({"image_path": f"i{i}.png", "cancer": i % 2,
                     "split": "training" if i < 8 else "test"})
    pd.DataFrame(rows).to_csv(tmp_path / "meta.csv", index=False)
    return str(tmp_path / "meta.csv"), str(tmp_path)


def test_datamodule_matches_jax(img_csv):
    """DataModule on the cases of tests/test_datamodule_vit_detection.py::TestDataModule:
    the split, the train split's augmentation, a fresh shuffle per epoch, the valid
    loaders; every batch equal to the JAX package's."""
    from mammodissect.data.datamodule import DataModule as JaxDataModule
    from mammodissect_torch.data.datamodule import DataModule, host_rank

    csv, root = img_csv
    cfg = {"vindr": {"data_type": "image_classification", "csv_file": csv, "root": root,
                     "label_col": "cancer", "size_hw": (40, 30)}}
    dm, jdm = DataModule(cfg, {"batch_size": 4}), JaxDataModule(cfg, {"batch_size": 4})
    assert dm.datasets["vindr"]["train"].train and not dm.datasets["vindr"]["valid"].train
    assert host_rank() == (0, 1)
    for epoch in (0, 1):
        got, want = list(dm.train_dataloader(epoch=epoch)), list(jdm.train_dataloader(epoch=epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)
    labels = [[float(x) for b in dm.train_dataloader(epoch=e) for x in b.labels] for e in (0, 0, 1)]
    assert labels[0] == labels[1] and labels[0] != labels[2]
    (name, valid), = dm.valid_dataloader().items()
    assert name == "vindr" and sum(b.n_valid for b in valid) == 4


@pytest.mark.parametrize("host_count", [1, 3])
def test_iter_epoch_host_slices_match_jax(img_csv, host_count):
    from mammodissect.train.data import ClassifierDataset as JaxDataset
    from mammodissect.train.data import iter_epoch as jax_iter_epoch
    from mammodissect_torch.train.data import ClassifierDataset, iter_epoch

    csv, root = img_csv
    df = pd.read_csv(csv)
    for host in range(host_count):
        got = list(iter_epoch(ClassifierDataset(df, root=root, size_hw=(16, 12)), 2, shuffle=True,
                              seed=4, host_index=host, host_count=host_count))
        want = list(jax_iter_epoch(JaxDataset(df, root=root, size_hw=(16, 12)), 2, shuffle=True,
                                   seed=4, host_index=host, host_count=host_count))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            assert g.n_valid == w.n_valid


def test_labelmaps_match_jax(tmp_path):
    """The copy of `data/labelmaps.py` on tests/test_misc_parity.py's cases."""
    from mammodissect.data import labelmaps as JL
    from mammodissect_torch.data import labelmaps as PL

    assert PL.CIFAR100_FINE_TO_COARSE == JL.CIFAR100_FINE_TO_COARSE
    assert PL.CIFAR100_COARSE_NAMES == JL.CIFAR100_COARSE_NAMES
    assert all(PL.CIFAR100_FINE_TO_COARSE.count(c) == 5 for c in range(20))
    assert [PL.cifar100_superclass(i) for i in range(100)] == \
        [JL.cifar100_superclass(i) for i in range(100)]
    p = tmp_path / "label.csv"
    p.write_text("number,name,category\n1,wall,material\n2,sky,scene\nx,bad,row\n")
    assert PL.load_broden_labels(str(p)) == JL.load_broden_labels(str(p)) == {1: "wall", 2: "sky"}
    q = tmp_path / "classes.txt"
    q.write_text("/a/abbey 0\n/b/beach 1\n\n")
    assert PL.load_class_list(str(q)) == JL.load_class_list(str(q)) == ["abbey", "beach"]


# --------------------------------------------------------------------------- the CLI
def test_pretrain_cli_on_the_cpu_writes_a_dissector(multiview, tmp_path):
    """`cli.pretrain` on the CPU (efficientnet-test, 1-layer BERT, 32x24, the default
    prompts.json read by path, bf16 compute over float32 weights): 10 rows in
    batches of 4 give 2 steps an epoch, a finite loss and `final.pth`, which loads as
    a Mammo-CLIP dissector with the trained weights. `pretrain` writes `step_{n}.pth`
    every `ckpt_freq_steps` and logs every `log_freq`; a CSV shorter than a batch
    gives 0 steps and a NaN loss, as in JAX."""
    import contextlib
    import io

    from mammodissect_torch.cli.pretrain import main
    from mammodissect_torch.dissect.dissectors import get_dissector
    from mammodissect_torch.models.breastclip import default_model_config
    from mammodissect_torch.train.checkpoints import load_checkpoint
    from mammodissect_torch.train.pretrain import PretrainConfig, pretrain

    df, root = multiview
    df.to_csv(tmp_path / "data.csv", index=False)
    argv = ["--csv-file", str(tmp_path / "data.csv"), "--root", root, "--epochs", "1",
            "--batch-size", "4", "--img-size", "32", "24", "--image-variant", "efficientnet-test",
            "--bert-layers", "1", "--warmup-steps", "1", "--checkpoints", str(tmp_path / "ck"),
            "--device", "cpu"]
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the tensorboard directory's default is relative
    try:
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
    finally:
        os.chdir(cwd)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["steps"] == 2 and np.isfinite(result["last_loss"])
    assert result["final_checkpoint"] == str(tmp_path / "ck" / "final.pth")
    ckpt = load_checkpoint(result["final_checkpoint"])
    assert ckpt["step"] == 2 and ckpt["optimizer"]["state"] and ckpt["scheduler"]
    assert {p.dtype for p in ckpt["model"].values() if p.is_floating_point()} == {torch.float32}
    cfg = default_model_config()
    cfg["image_encoder"]["variant"] = "efficientnet-test"
    dissector = get_dissector("breastclip", ckpt_path=result["final_checkpoint"],
                              model_config=cfg, bert_layers=1, device="cpu")
    state = dissector.module.state_dict()
    assert set(state) == set(ckpt["model"])
    assert all(torch.equal(state[k], v) for k, v in ckpt["model"].items())
    emb = dissector.embed_images(np.zeros((2, 32, 24, 1), np.float32))
    assert emb.shape == (2, 512) and np.isfinite(emb).all()

    def run(rows, name, **kw):
        logs = []
        ds = P.ImageTextDataset(df.iloc[:rows], root=root, size_hw=(32, 24), prompt_json=PROMPTS)
        cfg = PretrainConfig(epochs=1, batch_size=4, img_size=(32, 24), bert_layers=1,
                             image_variant="efficientnet-test", device="cpu", dtype="float32",
                             checkpoints=str(tmp_path / name),
                             tensorboard_path=str(tmp_path / f"tb_{name}"), **kw)
        return pretrain(cfg, ds, log=logs.append), logs

    res, logs = run(8, "ck1", ckpt_freq_steps=1, log_freq=2)
    assert res["steps"] == 2 and np.isfinite(res["last_loss"])
    assert sorted(p.name for p in (tmp_path / "ck1").iterdir()) == \
        ["final.pth", "step_1.pth", "step_2.pth"]
    assert load_checkpoint(str(tmp_path / "ck1" / "step_1.pth"))["step"] == 1
    assert len(logs) == 1 and logs[0].startswith("epoch 0 step 2/2 loss ")
    res, _ = run(3, "ck0")
    assert res["steps"] == 0 and np.isnan(res["last_loss"])
    with pytest.raises(RuntimeError, match="torchrun"):
        main(argv[:-2] + ["--model-parallel", "2", "--device", "cpu"])
