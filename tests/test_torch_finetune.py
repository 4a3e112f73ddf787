"""Fine-tuning in the PyTorch port against the JAX package, on the CPU: train steps
and eval predictions of `Trainer` on the same weights (carried across with
`classifier_from_jax`) and uint8 batches, the linear probe, the dtype policy of a
bf16 fine-tune, and `do_experiments` end to end (its checkpoint, the inference
modes, resume, and the `.pth` as the C-dissect target)."""
import os
import re

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mammodissect.models.classifier import BreastClipClassifierModule as JaxClassifier
from mammodissect.train.experiments import FinetuneConfig as JaxFinetuneConfig
from mammodissect.train.experiments import build_model as jax_build_model
from mammodissect.train.trainer import Trainer as JaxTrainer
from mammodissect.train.trainer import make_optimizer as jax_make_optimizer
from mammodissect_torch.convert import classifier_from_jax
from mammodissect_torch.models.classifier import BreastClipClassifierModule, frozen_param_labels
from mammodissect_torch.train.experiments import (
    FinetuneConfig,
    build_model,
    checkpoint_path,
    do_experiments,
)
from mammodissect_torch.train.trainer import Trainer, make_optimizer

HW = (32, 24)
MEAN, STD = 0.3089279, 0.25053555
POS_WEIGHT = 15.573306370070778  # VinDr Mass


def _redraw(variables, seed):
    """Unit-preserving random weights and BN parameters and statistics (the default
    init shrinks activations by orders of magnitude over the blocks, which would
    make any tolerance vacuous)."""
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


@pytest.fixture(scope="module")
def jax_ft():
    """The JAX t_test_ft classifier (efficientnet-test + a linear head) at 32x24,
    true-SAME padding, bn_momentum 0.9, float32, with redrawn weights."""
    module, variables = jax_build_model(JaxFinetuneConfig(
        arch="t_test_ft", img_size=HW, dtype="float32", pad_mode="same", bn_momentum=0.9))
    return module, _redraw(variables, seed=0)


def _port_model(variables, n_class=1):
    model = BreastClipClassifierModule("efficientnet-test", n_class=n_class, bn_momentum=0.9,
                                       pad_mode="same")
    model.load_state_dict(classifier_from_jax(jax.tree.map(np.array, variables)))
    return model


def _batches():
    """Three uint8 batches of 8; the last has 5 real rows and 3 wrap-padded ones."""
    rng = np.random.default_rng(1)
    out = []
    for n_valid in (8, 8, 5):
        u8 = rng.integers(0, 256, size=(8, *HW, 1), dtype=np.uint8)
        labels = (rng.random(8) > 0.6).astype(np.float32)
        u8[n_valid:], labels[n_valid:] = u8[:8 - n_valid], labels[:8 - n_valid]
        out.append((u8, labels, n_valid))
    return out


def test_train_steps_match_jax(jax_ft):
    """Three train steps (BCE with pos-weight, AdamW 1e-3 with two warmup steps, the
    u8 wire normalized on the device, the last batch padded) of JAX's Trainer and
    the port's: the same loss each step, the same parameters and BatchNorm running
    statistics after. efficientnet-test has no residual block, so no drop-connect
    mask is drawn (remat against no remat with masks: test_torch_train.py).
    Tolerance: float32 forward/backward in another summation order; Adam divides by
    sqrt(v), so a relative gradient difference passes to the update as it is.

    Each block's project BatchNorm bias (`_bn2.bias`) is frozen in both (the
    optimizers' frozen labels): the next op is a 1x1 convolution into a
    batch-statistics BatchNorm, which removes any per-channel shift, so its true
    gradient is 0 and the computed one rounding noise (< 1e-4 here, against > 1e-3
    for every other parameter), whose sign Adam would turn into a step of +-lr in any
    implementation, and which would reach the next BatchNorm's running mean."""
    module, variables = jax_ft

    def shift_invariant(name):
        return name.endswith("_bn2.bias")

    jlabels = jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if [k.key for k in path[-2:]] == ["bn2", "bias"] else "train",
        variables["params"])
    jtr = JaxTrainer(module, variables,
                     jax_make_optimizer(1e-3, 1e-4, 2, 10, param_labels=jlabels),
                     loss_kind="bce", pos_weight=POS_WEIGHT, input_wire="u8", norm_mean=MEAN,
                     norm_std=STD)
    model = _port_model(variables)
    labels = {k: "frozen" if shift_invariant(k) else "train" for k, _ in model.named_parameters()}
    assert sum(v == "frozen" for v in labels.values()) == 7
    optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 2, 10, param_labels=labels)
    for k, p in model.named_parameters():  # out of the optimizer, but their gradients
        p.requires_grad_(True)             # are kept to show that they are noise
    tr = Trainer(model, optimizer, scheduler, loss_kind="bce", pos_weight=POS_WEIGHT,
                 input_wire="u8", norm_mean=MEAN, norm_std=STD, device="cpu")
    for u8, y, n_valid in _batches():
        want = jtr.train_batch(u8, y, n_valid)
        got = tr.train_batch(u8, y, n_valid)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        grads = {k: float(p.grad.abs().max()) for k, p in model.named_parameters()}
        assert max(g for k, g in grads.items() if shift_invariant(k)) < 1e-4
        assert min(g for k, g in grads.items() if not shift_invariant(k)) > 1e-3
    assert tr.step == 3
    start = classifier_from_jax(jax.tree.map(np.array, variables))
    final = classifier_from_jax(jax.tree.map(np.array, jtr.variables))
    state = model.state_dict()
    for k in final:
        # every other parameter and statistic moved
        assert torch.equal(final[k], start[k]) == shift_invariant(k), k
        np.testing.assert_allclose(state[k].numpy(), final[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["bce", "ce"])
def test_eval_predictions_match_jax(jax_ft, kind):
    """eval_batch: the sigmoid of the logit (BCE) or the argmax class (CE, a 4-class
    head over the same encoder) and the masked loss, against JAX's."""
    module, variables = jax_ft
    n_class = 4 if kind == "ce" else 1
    if kind == "ce":
        module = JaxClassifier(variant="efficientnet-test", n_class=4, bn_momentum=0.9,
                               pad_mode="same")
        rng = np.random.default_rng(2)
        head = {"kernel": rng.normal(size=(module_width(variables), 4)).astype(np.float32),
                "bias": (rng.normal(size=4) * 0.1).astype(np.float32)}
        variables = {"params": {**variables["params"], "classifier": {"fc": head}},
                     "batch_stats": variables["batch_stats"]}
    jtr = JaxTrainer(module, variables, jax_make_optimizer(1e-3, 0.0, 0, 10), loss_kind=kind,
                     input_wire="u8", norm_mean=MEAN, norm_std=STD)
    model = _port_model(variables, n_class)
    optimizer, _ = make_optimizer(model, 1e-3, 0.0, 0, 10)
    tr = Trainer(model, optimizer, loss_kind=kind, input_wire="u8", norm_mean=MEAN,
                 norm_std=STD, device="cpu")
    u8, labels, n_valid = _batches()[2]
    if kind == "ce":
        labels = np.random.default_rng(3).integers(0, 4, 8).astype(np.int32)
    want_loss, want = jtr.eval_batch(u8, labels, n_valid)
    got_loss, got = tr.eval_batch(u8, labels, n_valid)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    if kind == "ce":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def module_width(variables):
    return variables["params"]["classifier"]["fc"]["kernel"].shape[0]


def _cfg(**kw):
    base = dict(arch="t_test_ft", img_size=HW, dtype="float32", pad_mode="same", seed=1,
                device="cpu")
    base.update(kw)
    return FinetuneConfig(**base)


def test_linear_probe_trains_only_the_head():
    """'*_lp': the encoder's parameters and BatchNorm statistics do not move (no
    update, no Adam state, eval-mode BatchNorm), the head does."""
    cfg = _cfg(arch="t_test_lp")
    model = build_model(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = make_optimizer(model, 1e-2, 1e-4, 0, 10,
                                          param_labels=frozen_param_labels(model, True))
    tr = Trainer(model, optimizer, scheduler, input_wire="u8", norm_mean=MEAN, norm_std=STD,
                 device="cpu")
    for u8, labels, n_valid in _batches()[:2]:
        tr.train_batch(u8, labels, n_valid)
    after = model.state_dict()
    encoder = [k for k in before if k.startswith("image_encoder.")]
    assert any("running_var" in k for k in encoder)
    for k in encoder:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(after["classifier.fc.weight"], before["classifier.fc.weight"])
    assert all(p not in optimizer.state for p in model.image_encoder.parameters())


def test_bf16_fine_tune_keeps_f32_weights_and_evals_through_bf16_kernel(monkeypatch):
    """A bf16 fine-tune: float32 parameters before and after a train step, which
    never reaches kernel 2 (the training forward is unfused); its eval forward
    reaches kernel 2 (here its plain version, the CPU's) in bf16, at every fused
    block, with bf16 weights."""
    from mammodissect_torch.ops import cuda_mbconv

    calls = []
    plain = cuda_mbconv.expand_dw_plain

    def spy(x, w_exp, *rest):
        calls.append((x.dtype, w_exp.dtype, rest[2].dtype))
        return plain(x, w_exp, *rest)

    monkeypatch.setattr(cuda_mbconv, "expand_dw_plain", spy)
    cfg = _cfg(dtype="bfloat16")
    model = build_model(cfg)
    optimizer, scheduler = make_optimizer(model, 1e-3, 1e-4, 0, 10)
    tr = Trainer(model, optimizer, scheduler, input_wire="u8", norm_mean=MEAN, norm_std=STD,
                 device="cpu")
    u8, labels, n_valid = _batches()[0]
    loss = tr.train_batch(u8, labels, n_valid)
    assert np.isfinite(loss) and calls == []
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(s.dtype == torch.float32 for p in model.parameters()
               for s in optimizer.state[p].values() if s.dim())
    _, preds = tr.eval_batch(u8, labels, n_valid)
    n_fused = sum(b.fused_front for b in model.image_encoder._blocks)
    assert n_fused == 2 and calls == [(torch.bfloat16,) * 3] * n_fused
    assert preds.shape == (8,) and np.isfinite(preds).all()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """PNGs where label == a bright blob in the center (as tests/test_finetune_e2e.py)."""
    root = tmp_path_factory.mktemp("torch_ft_imgs")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(48):
        label = i % 2
        arr = rng.normal(0.4, 0.1, size=HW).clip(0, 1)
        if label:
            arr[12:22, 8:16] += 0.5
        Image.fromarray((arr.clip(0, 1) * 255).astype("uint8")).save(root / f"img_{i}.png")
        rows.append({"image_path": f"img_{i}.png", "cancer": label,
                     "split": "training" if i < 32 else "test"})
    pd.DataFrame(rows).to_csv(root / "meta.csv", index=False)
    return str(root / "meta.csv"), str(root)


def _run_cfg(synth, tmp_path, **kw):
    csv, root = synth
    base = dict(csv_file=csv, data_dir=root, label="cancer", batch_size=8, lr=1e-3,
                warmup_epochs=0, bn_momentum=0.7, print_freq=1000,
                checkpoints=str(tmp_path / "ck"), output_path=str(tmp_path / "out"),
                tensorboard_path=str(tmp_path / "tb"))
    base.update(kw)
    return _cfg(**base)


def _epoch_lines(logs):
    return [l for l in logs if re.match(r"epoch \d+: train", l)]


def test_do_experiments_end_to_end(synth, tmp_path):
    """Three epochs on the CPU: the validation loss falls, the best checkpoint is a
    `.pth`, the out-of-fold CSV is written; `inference_mode` "y" rescores the valid
    fold from the checkpoint to its saved predictions, "load" writes the FP/FN
    dumps; and the `.pth` loads as the `breastclip_classifier` C-dissect target with
    the fine-tuned model's logits. Static padding, as the target uses."""
    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.train.checkpoints import load_for_eval

    cfg = _run_cfg(synth, tmp_path, epochs=3, pad_mode="static")
    logs = []
    oof = do_experiments(cfg, log=logs.append)
    valid = [float(l.split(" valid ")[1].split()[0]) for l in _epoch_lines(logs)]
    assert len(valid) == 3 and valid[-1] < valid[0], logs
    assert any(l.startswith("[time] epoch 3: data ") for l in logs)
    ckpt = checkpoint_path(cfg)
    assert ckpt.endswith(".pth") and os.path.exists(ckpt)
    assert os.path.exists(os.path.join(cfg.output_path, "oof_predictions.csv"))
    best = load_for_eval(ckpt)
    np.testing.assert_allclose(oof["prediction"].values, best["predictions"][:16])

    rescored = do_experiments(_run_cfg(synth, tmp_path, pad_mode="static", inference_mode="y",
                                       finetuned_ckpt_path=ckpt), log=lambda *_: None)
    np.testing.assert_allclose(rescored["prediction"].values, best["predictions"][:16],
                               rtol=1e-6, atol=1e-7)
    loaded_logs = []
    do_experiments(_run_cfg(synth, tmp_path, inference_mode="load", finetuned_ckpt_path=ckpt),
                   log=loaded_logs.append)
    assert any("optimal_threshold" in l for l in loaded_logs)
    assert os.path.exists(os.path.join(cfg.output_path, "fold0_false_positives.csv"))

    target = get_target_model("breastclip_classifier", arch="t_test_ft", finetuned_ckpt=ckpt,
                              device="cpu")
    model = build_model(cfg).eval()
    model.load_state_dict(best["model"])
    state = target.model.state_dict()
    for k, v in best["model"].items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0, msg=k)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, *HW, 1)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(target.model(x), model(x), rtol=0, atol=0)


def test_resume_of_one_plus_one_epochs_equals_two(synth, tmp_path, monkeypatch):
    """One epoch, then a resume for the second, against two epochs straight: the
    second epoch's log line (train and valid loss, every metric at full precision,
    the train folds' too) is the same. One epoch of warmup, so the first epoch's
    lrs do not depend on the run's length. The augmentation draws from the
    dataset's own generator, which restarts with each run (as in the JAX package),
    so it is replaced by the identity here: the test holds what the checkpoint
    carries (weights, BatchNorm statistics, Adam moments and counts, the schedule's
    step, the epoch)."""
    from mammodissect_torch.data import transforms

    monkeypatch.setattr(transforms, "augment_train", lambda arr, rng: arr)
    straight, first, resumed = [], [], []
    kw = dict(warmup_epochs=1, train_eval=True)
    do_experiments(_run_cfg(synth, tmp_path / "straight", epochs=2, **kw), log=straight.append)
    cfg1 = _run_cfg(synth, tmp_path / "resume", epochs=1, **kw)
    do_experiments(cfg1, log=first.append)
    do_experiments(_run_cfg(synth, tmp_path / "resume", epochs=2,
                            resume_from=checkpoint_path(cfg1), **kw), log=resumed.append)
    assert "[resume] restored step 4, continuing at epoch 1" in resumed
    assert any(l.startswith("[resume] standing best at ") for l in resumed)
    assert _epoch_lines(first) == _epoch_lines(straight)[:1]
    assert _epoch_lines(resumed) == _epoch_lines(straight)[1:]
