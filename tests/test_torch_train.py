"""The fine-tune building blocks of the PyTorch port against the JAX package on the
same numpy inputs, on the CPU: losses, the learning-rate schedule, AdamW, the
training-mode forward of the EfficientNet tower (batch-statistics BatchNorm),
remat, the metrics copy and the fine-tune loader's batches."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from PIL import Image

import mammodissect.metrics as JM
import mammodissect.train.losses as JL
import mammodissect_torch.metrics as PM
import mammodissect_torch.train.losses as PL
from mammodissect.models.classifier import frozen_param_labels as jax_frozen_labels
from mammodissect.models.efficientnet import EfficientNet as JaxEfficientNet
from mammodissect.train.schedule import linear_warmup_cosine_annealing as jax_schedule
from mammodissect.train.trainer import make_optimizer as jax_make_optimizer
from mammodissect_torch.convert import efficientnet_from_jax
from mammodissect_torch.models.classifier import frozen_param_labels
from mammodissect_torch.models.efficientnet import EfficientNet
from mammodissect_torch.train.experiments import FinetuneConfig, warmup_steps_of
from mammodissect_torch.train.trainer import make_optimizer

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)  # float32 sums in another order


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("pos_weight", [None, 15.573306370070778])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_logits", [1, 3])
def test_bce_matches_jax(pos_weight, masked, n_logits):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(8, n_logits)) * 3).astype(np.float32)
    labels = (rng.random((8, n_logits)) > 0.5).astype(np.float32)
    weights = (np.arange(8) < 5).astype(np.float32) if masked else None
    want = JL.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels), pos_weight,
                              None if weights is None else jnp.asarray(weights))
    got = PL.bce_with_logits(_t(logits), _t(labels), pos_weight,
                             None if weights is None else _t(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(smoothing, masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(8, 4)) * 2).astype(np.float32)
    labels = rng.integers(0, 4, 8)
    weights = (np.arange(8) < 6).astype(np.float32) if masked else None
    want = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing,
                                    None if weights is None else jnp.asarray(weights))
    got = PL.softmax_cross_entropy(_t(logits), _t(labels), smoothing,
                                   None if weights is None else _t(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize("views", ["none", "i2i", "t2t", "both"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_clip_contrastive_loss_matches_jax(views, smoothing):
    rng = np.random.default_rng(2)

    def emb():
        e = rng.normal(size=(6, 16)).astype(np.float32)
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    img, txt, img2, txt2 = emb(), emb(), emb(), emb()
    kw = dict(label_smoothing=smoothing, i2i_weight=0.5 if views in ("i2i", "both") else 0.0,
              t2t_weight=0.3 if views in ("t2t", "both") else 0.0)
    want = JL.clip_contrastive_loss(jnp.asarray(img), jnp.asarray(txt), 1 / 0.07,
                                    image_view_embeddings=jnp.asarray(img2),
                                    text_embeddings2=jnp.asarray(txt2), **kw)
    got = PL.clip_contrastive_loss(_t(img), _t(txt), 1 / 0.07, image_view_embeddings=_t(img2),
                                   text_embeddings2=_t(txt2), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("warmup_epochs,epochs,steps_per_epoch", [
    (0.0, 3, 4),   # no warmup rule: 10 steps (longer than the run)
    (1.0, 3, 4),   # one epoch of warmup
    (0.1, 3, 4),   # the 0.1 rule: warmup = the number of epochs
    (1.0, 2, 1),   # one step an epoch
])
def test_schedule_lr_of_every_update_matches_optax(warmup_epochs, epochs, steps_per_epoch):
    """lr of update i (0-based) == optax's schedule(i), through LambdaLR stepped after
    each optimizer.step(). optax computes in float32: rtol 1e-6, and atol 1e-6 of the
    base lr for the cosine's tail, where 1 + cos(pi t / T) cancels in float32."""
    cfg = FinetuneConfig(warmup_epochs=warmup_epochs, epochs=epochs)
    warmup = warmup_steps_of(cfg, steps_per_epoch)
    assert warmup == {0.0: 10, 1.0: steps_per_epoch, 0.1: epochs}[warmup_epochs]
    total = steps_per_epoch * epochs
    model = torch.nn.Linear(2, 1)
    optimizer, scheduler = make_optimizer(model, 5e-5, 1e-4, warmup, total)
    want = jax_schedule(5e-5, warmup, total)
    for i in range(total + 2):
        lr = optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(want(i)), rtol=1e-6, atol=1e-6 * 5e-5,
                                   err_msg=f"update {i}")
        optimizer.step()
        scheduler.step()
    if warmup:
        assert jax_schedule(5e-5, warmup, total)(0) == 0.0


class _Probe(torch.nn.Module):
    """An 'image encoder' and a head, named as the classifier's."""

    def __init__(self, params):
        super().__init__()
        self.image_encoder = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(_t(v)) for k, v in params["image_encoder"].items()})
        self.classifier = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(_t(v)) for k, v in params["classifier"].items()})


@pytest.mark.parametrize("freeze", [False, True])
def test_adamw_updates_match_optax(freeze):
    """Three AdamW updates with warmup + cosine and weight decay against optax.adamw
    (with multi_transform frozen labels when linear-probing) on the same gradients.
    Frozen parameters get no update and no Adam state. Tolerance: float32 update
    arithmetic in another order."""
    rng = np.random.default_rng(3)
    params = {"image_encoder": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                                "b": rng.normal(size=(4,)).astype(np.float32)},
              "classifier": {"w": rng.normal(size=(1, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
             for _ in range(3)]
    lr, wd, warmup, total = 1e-2, 0.1, 2, 10
    labels = jax_frozen_labels(params, freeze)
    tx = jax_make_optimizer(lr, wd, warmup, total, param_labels=labels)
    j_params, state = params, tx.init(params)
    model = _Probe(params)
    optimizer, scheduler = make_optimizer(model, lr, wd, warmup, total,
                                          param_labels=frozen_param_labels(model, freeze))
    named = dict(model.named_parameters())
    for g in grads:
        updates, state = tx.update(g, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for name, p in named.items():
            top, key = name.split(".")
            p.grad = _t(g[top][key]) if p.requires_grad else None
        optimizer.step()
        scheduler.step()
        for name, p in named.items():
            top, key = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[top][key]),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    for name, p in named.items():
        frozen = freeze and name.startswith("image_encoder.")
        assert p.requires_grad != frozen
        assert (p in optimizer.state) != frozen
        if frozen:
            np.testing.assert_array_equal(p.detach().numpy(), params["image_encoder"][name[-1]])


def _redraw_tower(variables, seed):
    """Unit-preserving random weights and BN affine parameters and statistics (the
    default init shrinks activations by orders of magnitude over the blocks)."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = str(path[-1].key)
        leaf = np.asarray(leaf)
        if name == "kernel":
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)


def test_training_forward_matches_flax():
    """One training-mode forward of the efficientnet-test tower at 32x24, batch 8,
    bn_momentum 0.9: the output and every updated running mean and variance against
    flax (mutable=["batch_stats"]). The deepest blocks pool 1x1 maps over 8 images,
    where the unbiased variance would be 8/7 of flax's biased one. The tower has no
    residual block, so no drop-connect mask is drawn. Tolerance: float32 convolutions
    and statistics summed in another order."""
    jm = JaxEfficientNet(variant="efficientnet-test", in_channels=1, bn_momentum=0.9,
                         pad_mode="same")
    x = np.random.default_rng(4).normal(size=(8, 32, 24, 1)).astype(np.float32)
    variables = _redraw_tower(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), seed=5)
    (features, _), mutated = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                                           mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = EfficientNet("efficientnet-test", in_channels=1, bn_momentum=0.9, pad_mode="same")
    model.load_state_dict(efficientnet_from_jax(variables["params"], variables["batch_stats"]))
    got, _ = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(features),
                               rtol=1e-4, atol=1e-4)
    want = efficientnet_from_jax(variables["params"], mutated["batch_stats"])
    state = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(1 for k in want if k.endswith("running_var"))
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the last block's statistics pool one pixel per image: the biased rule matters
    last = "_blocks.6._bn2.running_var"
    old = efficientnet_from_jax(variables["params"], variables["batch_stats"])[last]
    # flax: new = 0.9 old + 0.1 var; with the unbiased variance: + 0.1 var / 7
    unbiased = want[last] + (want[last] - 0.9 * old) / 7
    assert not np.allclose(state[last].numpy(), unbiased.numpy(), rtol=1e-4, atol=1e-6)


def test_remat_gives_the_gradients_of_no_remat():
    """efficientnet-b0 (blocks with a residual, drop-connect rate up to 0.2 * 15/16) in
    training mode with the same generator seed, with and without remat: the same
    loss, gradients and running statistics. The masks are drawn before each
    checkpointed block, so the recompute applies the same ones, and it leaves the
    running statistics alone. Another seed draws other masks. Tolerance: the
    recompute runs the same float32 operations on the same inputs."""
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 48, 40, 1)).astype(np.float32))
    base = EfficientNet("efficientnet-b0", in_channels=1, pad_mode="same")
    state = base.state_dict()
    runs = {}
    for name, remat, seed in (("plain", False, 7), ("remat", True, 7), ("other", False, 8)):
        model = EfficientNet("efficientnet-b0", in_channels=1, pad_mode="same", remat=remat)
        model.load_state_dict(state)
        features, _ = model.train()(x, generator=torch.Generator().manual_seed(seed))
        loss = features.square().mean()
        loss.backward()
        runs[name] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
                      {k: v for k, v in model.state_dict().items() if "running" in k})
    assert sum(b.residual for b in base._blocks) >= 8
    torch.testing.assert_close(runs["remat"][0], runs["plain"][0])
    for k, g in runs["plain"][1].items():
        torch.testing.assert_close(runs["remat"][1][k], g, msg=k)
    for k, v in runs["plain"][2].items():
        torch.testing.assert_close(runs["remat"][2][k], v, msg=k)
    assert not torch.allclose(runs["other"][0], runs["plain"][0])


@pytest.mark.parametrize("name", ["auroc", "pr_auc", "compute_auprc", "pfbeta",
                                  "pfbeta_binarized", "optimal_roc_threshold"])
def test_binary_metrics_match_jax(name):
    rng = np.random.default_rng(9)
    gt = (rng.random(200) > 0.7).astype(np.float64)
    pred = np.round(rng.random(200) * 0.6 + gt * 0.3, 2)  # ties included
    assert getattr(PM, name)(gt, pred) == getattr(JM, name)(gt, pred)


def test_class_metrics_match_jax():
    rng = np.random.default_rng(10)
    gt, pred = rng.integers(0, 4, 100), rng.integers(0, 4, 100)
    assert PM.f1_macro(gt, pred) == JM.f1_macro(gt, pred)
    assert PM.f1_macro(gt, pred, n_class=5) == JM.f1_macro(gt, pred, n_class=5)
    assert PM.compute_accuracy_np_array(gt, pred) == JM.compute_accuracy_np_array(gt, pred)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """13 grayscale PNGs at 40x30 (resized to 32x24 by the loader), labels 0/1."""
    root = tmp_path_factory.mktemp("torch_train_pngs")
    rng = np.random.default_rng(11)
    rows = []
    for i in range(13):
        arr = (rng.normal(0.4, 0.15, size=(40, 30)).clip(0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / f"p{i}.png")
        rows.append({"image_path": f"p{i}.png", "Mass": int(i % 3 == 0)})
    return pd.DataFrame(rows), str(root)


@pytest.mark.parametrize("train,wire,balanced", [
    (True, "u8", False), (False, "u8", False), (True, "u8", True), (True, "f32", False)])
def test_loader_batches_match_jax(pngs, train, wire, balanced):
    """ClassifierDataset + iter_epoch against the JAX loader, same seed: every batch
    bit-identical (augmentation draws, the uint8 wire, balanced sampling, the
    wrap-padded tail: 13 images in batches of 4)."""
    from mammodissect.train.data import ClassifierDataset as JaxDataset
    from mammodissect.train.data import class_balanced_weights as jax_weights
    from mammodissect.train.data import iter_epoch as jax_iter_epoch
    from mammodissect_torch.train.data import ClassifierDataset, class_balanced_weights, iter_epoch

    df, root = pngs
    kw = dict(label_col="Mass", root=root, size_hw=(32, 24), train=train, seed=3, wire=wire)
    weights = class_balanced_weights(df["Mass"].values) if balanced else None
    if balanced:
        np.testing.assert_array_equal(weights, jax_weights(df["Mass"].values))
    batches = [list(it(ds(df, **kw), 4, shuffle=train, seed=5, balanced_weights=weights))
               for it, ds in ((iter_epoch, ClassifierDataset), (jax_iter_epoch, JaxDataset))]
    assert len(batches[0]) == len(batches[1]) == 4 and batches[0][-1].n_valid == 1
    for got, want in zip(*batches):
        assert got.images.dtype == want.images.dtype == (np.uint8 if wire == "u8" else np.float32)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.n_valid == want.n_valid


def test_resample_balanced_matches_jax(pngs):
    from mammodissect.train.data import resample_balanced as jax_resample
    from mammodissect_torch.train.data import resample_balanced

    df, _ = pngs
    pd.testing.assert_frame_equal(resample_balanced(df, "Mass", 1.5, seed=2),
                                  jax_resample(df, "Mass", 1.5, seed=2))
