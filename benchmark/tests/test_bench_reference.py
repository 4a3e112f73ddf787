"""The plain reference against the program on the CPU in float32 at a small image
size (published widths, one BERT layer): the image tower block by block, the
concept embeddings, soft-WPMI and the fine-tuning steps. The reference imports nothing of the program;
this test imports both to hold the reference to the program's semantics."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.tests import _tiny
from benchmark.images import mammo_pool
from benchmark.reference import bert, efficientnet, scoring
from benchmark.weights import breastclip_spec, calibrate, make_state_dict


@pytest.fixture(scope="module")
def fp32_model():
    from mammodissect_torch.dissect.dissectors import get_dissector

    cfg = _tiny.configs()["mammoclip_b5_bf16"]
    cfg["dtype"] = "float32"
    dev = torch.device("cpu")
    pool = mammo_pool(4, cfg["image_height"], cfg["image_width"], 5, dev)
    sd = make_state_dict(breastclip_spec(cfg), cfg, 3, dev)
    calibrate(sd, cfg, pool)
    program = get_dissector("breastclip", vocab_file=core.bench_path(cfg["vocab_file"]),
                            device=dev, dtype="float32", bert_layers=cfg["num_hidden_layers"],
                            seed=0)
    program.max_length = cfg["max_length"]
    program.module.load_state_dict(sd, strict=True)
    return cfg, sd, pool, program


def test_tower_matches_program_block_by_block(fp32_model):
    from mammodissect_torch.ops.normalize import u8_minmax_meanstd

    cfg, sd, pool, program = fp32_model
    with torch.no_grad():
        x = efficientnet.normalize_u8(pool, cfg["norm_mean"], cfg["norm_std"])
        assert torch.equal(x, u8_minmax_meanstd(pool, cfg["norm_mean"], cfg["norm_std"]))
        feats, pooled = efficientnet.tower(sd, cfg, x, "image_encoder.")
        got_feats, captured = program.module.encode_image(x, capture=tuple(range(39)))
    assert len(pooled) == 39
    for i, want in enumerate(pooled):
        got = captured[f"blocks.{i}"].float()
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * (1 + float(want.abs().max())), i
    assert float((got_feats - feats).abs().max()) <= 1e-4 * (1 + float(feats.abs().max()))


def test_concept_embeddings_match_program(fp32_model):
    cfg, sd, _, program = fp32_model
    got = torch.from_numpy(program.embed_texts(_tiny.CONCEPTS))
    vocab = bert.read_vocab(core.bench_path(cfg["vocab_file"]))
    want = bert.embed_concepts(sd, cfg, _tiny.CONCEPTS, vocab, torch.device("cpu"))
    assert float((got - want).abs().max()) <= 1e-5


def test_tokenizer_is_the_toy_wordpiece():
    """The vocabulary file is the port's toy WordPiece in its first rows, padded to
    the published 28996 rows by pieces that tokenization never produces."""
    from mammodissect_torch.models.tokenizers import WordPieceTokenizer

    cfg = core.load_config("mammoclip_b5_bf16")
    vocab = bert.read_vocab(core.bench_path(cfg["vocab_file"]))
    toy = WordPieceTokenizer.toy().vocab
    assert len(vocab) == cfg["vocab_size"] == 28996
    assert list(vocab)[:len(toy)] == list(toy)
    texts = ["BI-RADS density A", "Australian terrier", "mass (spiculated), 2 cm",
             "[unused0] unused0 [UNK]"]
    want = WordPieceTokenizer.toy()(texts, max_length=32)
    ids, mask = bert.tokenize(texts, vocab, 32)
    assert np.array_equal(ids.numpy(), want["input_ids"])
    assert np.array_equal(mask.numpy(), want["attention_mask"])
    got = WordPieceTokenizer(vocab_file=core.bench_path(cfg["vocab_file"]))(texts, max_length=32)
    assert np.array_equal(got["input_ids"], want["input_ids"])


def test_soft_wpmi_matches_program():
    from mammodissect_torch.ops.similarity import soft_wpmi_segmented

    g = torch.Generator().manual_seed(0)
    img = efficientnet.l2n(torch.randn(40, 16, generator=g))
    txt = efficientnet.l2n(torch.randn(9, 16, generator=g))
    acts = torch.randn(40, 12, generator=g)
    acts[3, 0] = acts[5, 0] = 9.0  # a tie: the lower index first
    widths = [5, 7]
    want = scoring.soft_wpmi(img, txt, acts, widths, top_k=10)
    seg = np.repeat(np.arange(2), widths)
    got = soft_wpmi_segmented(img @ txt.T, acts, seg, 2, top_k=10)
    assert float((got - want).abs().max()) <= 1e-4


def test_training_steps_match_program_with_drop_connect():
    """The fine-tuning cell's checked steps with the program in float32: the
    reference's drop-connect masks, drawn again from the trainer's seed, are the
    program's, so the losses, first gradients and changes agree to rounding."""
    workload = "finetune_b5_steps"
    configs = _tiny.configs()
    assert configs["mammoclip_b5_classifier"]["drop_connect_rate"] == 0.2
    traffic = _tiny.traffic(workload, None)
    traffic["compute_dtype"] = "float32"
    line = core.run(7, workload, 0.1, False, 0.0, device=torch.device("cpu"), configs=configs,
                    traffic=traffic, limits={"loss_gap": 1, "grad_gap": 1, "change_gap": 1})
    checks = {k: c["value"] for k, c in line["checks"].items()}
    assert checks["loss_gap"] <= 2e-4, checks
    assert checks["grad_gap"] <= 1e-3 and checks["change_gap"] <= 1e-3, checks
