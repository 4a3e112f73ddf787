"""The fused MBConv front half prepares its weights once per block (kernel layout,
folded BatchNorms) and reuses them; a weight change must reach the next forward.
A tower that ran a forward, then got new weights (load_state_dict, an in-place
edit, a module `.to()`), gives the output of a tower built fresh with those
weights. Runs on the CPU (the kernel's plain version)."""
import numpy as np
import pytest
import torch

from mammodissect_torch.models.efficientnet import EfficientNet

VARIANT = "efficientnet-test"


def _random_state(model, seed):
    """Every float tensor of the state dict from numpy: weights and BN affine
    parameters and means ~ N(0, 0.2), running variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            out[name] = t.clone()
            continue
        if name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, tuple(t.shape))
        else:
            a = rng.normal(size=tuple(t.shape)) * 0.2
        out[name] = torch.from_numpy(a.astype(np.float32)).to(t.dtype)
    return out


def _tower(state=None, dtype=torch.float32):
    model = EfficientNet(VARIANT, in_channels=1, dtype=dtype).eval()
    if state is not None:
        model.load_state_dict(state)
    return model


def _forward(model, x):
    with torch.inference_mode():
        features, captured = model(x, capture=range(len(model._blocks)))
    return features, captured


def _input():
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.normal(size=(2, 40, 24, 1)).astype(np.float32))


def _assert_same(a, b):
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert a[1].keys() == b[1].keys()
    for key in a[1]:
        torch.testing.assert_close(a[1][key], b[1][key], rtol=0, atol=0)


def test_the_test_tower_has_fused_blocks():
    assert sum(block.fused_front for block in _tower()._blocks) >= 2


@pytest.mark.parametrize("change", ["load_state_dict", "in-place edit", "conv dtype to()",
                                    "load_state_dict assign", "storage replaced"])
def test_new_weights_reach_the_next_forward(change):
    x = _input()
    model = _tower(_random_state(_tower(), seed=1))
    _forward(model, x)  # prepares and caches the fused blocks' weights
    new_state, dtype = _random_state(model, seed=2), torch.float32
    if change == "load_state_dict":
        model.load_state_dict(new_state)
    elif change == "load_state_dict assign":
        model.load_state_dict(new_state, assign=True)
    elif change == "storage replaced":
        # each tensor gets a new storage, filled through `.data` (no version bump):
        # only the storage tells the change, and a caching allocator may hand a freed
        # address out again, so the cache must not key on addresses alone
        for name, t in model.state_dict(keep_vars=True).items():
            t.data = torch.empty_like(t)
            t.data.copy_(new_state[name])
    elif change == "in-place edit":
        with torch.no_grad():
            for name, t in model.state_dict().items():
                t.copy_(new_state[name])
    else:  # the same weights, the convolutions moved to bf16 as the main path runs them
        new_state, dtype = model.state_dict(), torch.bfloat16
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.to(dtype)
    _assert_same(_forward(model, x), _forward(_tower(new_state, dtype), x))


def test_prepared_weights_are_reused_while_nothing_changes():
    x = _input()
    model = _tower(_random_state(_tower(), seed=3))
    first = _forward(model, x)
    fused = [block for block in model._blocks if block.fused_front]
    prepared = [block.__dict__["_front_cache"][2] for block in fused]
    second = _forward(model, x)
    _assert_same(first, second)
    for block, before in zip(fused, prepared):
        after = block.__dict__["_front_cache"][2]
        assert all(a is b for a, b in zip(after, before))


@pytest.mark.parametrize("mode", ["training", "grad enabled"])
def test_only_inference_caches(mode):
    model = _tower(_random_state(_tower(), seed=4))
    block = next(block for block in model._blocks if block.fused_front)
    x = torch.zeros(1, block.args.input_filters, 5, 5)
    if mode == "training":
        with torch.inference_mode():
            block.train()._front_fused(x)
    else:
        block._front_fused(x)
    assert "_front_cache" not in block.__dict__


def test_fused_front_raises_in_training_mode():
    """The fused front half folds the BatchNorms' running statistics. In training
    mode a block with it takes the unfused path instead, normalizing by batch
    statistics (and updating the running ones), so the fused and the training
    forward differ; eval mode takes the fused front again. The whole tower trains."""
    from mammodissect_torch.ops import cuda_mbconv

    model = _tower(_random_state(_tower(), seed=5))
    fused = next(block for block in model._blocks if block.fused_front)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, fused.args.input_filters, 5, 5)).astype(np.float32))
    p = (fused.args.kernel_size - 1) // 2
    calls = []
    plain = cuda_mbconv.expand_dw_plain
    cuda_mbconv.expand_dw_plain = lambda *a: calls.append(1) or plain(*a)
    try:
        running = fused._bn0.running_mean.clone()
        trained = fused.train()(x, ((p, p), (p, p)))
        assert calls == [] and not torch.equal(fused._bn0.running_mean, running)
        with torch.no_grad():
            evaluated = fused.eval()(x, ((p, p), (p, p)))
        assert calls == [1]
    finally:
        cuda_mbconv.expand_dw_plain = plain
    assert not torch.allclose(trained, evaluated)
    features, _ = model.train()(_input())
    features.sum().backward()
    assert all(p.grad is not None for p in model.parameters())
