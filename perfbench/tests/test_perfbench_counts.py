"""The operation and byte counts against hand counts at small shapes."""

import pytest

from perfbench.counts import kernels, model, peaks, searches

# d 4, FFN 8, one layer each, target vocabulary 10.
SMALL = {"model": {"d_model": 4, "encoder_ffn_dim": 8, "decoder_ffn_dim": 8,
                   "encoder_layers": 1, "decoder_layers": 1},
         "data": {"Smiles": {"target": True, "vocab_size": 10}}}


def test_select_update():
    # B 2, K 3, D 128, H 2 at pos 4: 6 rows; an int8 row and its scales 136
    # bytes; 4 earlier times x 2 planes of one lineage per batch row (2);
    # q and out; the fresh bf16 rows in, their int8 rows and scales out; 5
    # ancestry entries a row.
    flops, nbytes = kernels.select_update(2, 3, 128, 2, 4)
    assert flops == 4 * 6 * 5 * 128
    assert nbytes == 2 * 2 * 4 * 136 + 2 * 6 * 128 * 2 + 2 * 6 * (256 + 136) + 6 * 5 * 4


def test_cross():
    flops, nbytes = kernels.cross(2, 3, 128, 10, 8)
    assert flops == 4 * 3 * 10 * 128
    assert nbytes == (2 * 2 * 3 + 2 * 10) * 128 * 2 + 2 * 8 * 4


def test_bound():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_encoder():
    # rows of 2 and 3 tokens: 5 x (8 d^2 + 4 d f) + 4 d (4 + 9), plus one
    # patch of 3 values: 2 x 3 x d.
    assert model.encoder(SMALL, [2, 3], 1, 3) == 5 * (128 + 128) + 16 * 13 + 24


def test_train_forward():
    # one row, 2 source and 3 target tokens
    encoder = 2 * 256 + 16 * 4
    cross_kv = 2 * 4 * 16
    decoder = 3 * (12 * 16 + 4 * 4 * 8) + 4 * 4 * 6 + 4 * 4 * 6
    lm_head = 3 * 2 * 4 * 10
    assert model.train_forward(SMALL, [2], [3]) == encoder + cross_kv + decoder + lm_head


def test_decode_search():
    # B 1, K 2, 2 valid keys, steps at pos 0 and 1
    encoder, cross_kv = 2 * 256 + 16 * 4, 2 * 4 * 16
    cross_attn = 4 * 4 * 2 * 2
    steps = [2 * 320 + 16 * 2 * (pos + 1) + 2 * 2 * 4 * 10 for pos in (0, 1)]
    assert model.decode_search(SMALL, 1, 2, [2], [0, 1]) == (
        encoder + cross_kv + sum(s + cross_attn for s in steps))


def test_positions():
    assert searches.positions({"steps": 3, "replays": 5}) == [0, 1, 2, 3, 3]
