"""The traffic makers: one seed gives the same inputs, another seed other
values in the same multiset of sizes."""

import numpy as np
import pytest

from perfbench import modality_types
from perfbench.tests.helpers import (NOT_PLAIN_IDS, rle_config, rle_traffic, tiny_config,
                                     traffic)
from perfbench.traffic import inputs
from perfbench.traffic.tokenizer import formula_tokenizer, smiles_tokenizer

BIG_SEED = 2 ** 31 + 12345


def _pool(name, cell, seed):
    return inputs.encoder_pool(tiny_config(name), traffic(cell, batch=8, pool=2), seed)


def test_encoder_pool_by_seed():
    for name, cell in (("ir_patches", "ir_patches.decode"), ("multimodal", "multimodal.decode")):
        a, b, c = (_pool(name, cell, s) for s in (BIG_SEED, BIG_SEED, BIG_SEED + 1))
        for (xa, ma), (xb, mb) in zip(a, b):
            assert np.array_equal(ma, mb)
            assert all(np.array_equal(xa[k], xb[k]) for k in xa)
        assert any(not np.array_equal(xa["IR"], xc["IR"]) for (xa, _), (xc, _) in zip(a, c))
        lengths = [np.sort(np.concatenate([m.sum(1) for _, m in p])) for p in (a, c)]
        assert np.array_equal(*lengths)


def test_token_id_types_are_the_programs():
    from multimodalanalytical_tpu_torch.models.embedding import TEXT_LIKE_TYPES

    assert modality_types.TEXT_LIKE_TYPES == TEXT_LIKE_TYPES


def test_rle_pool():
    """A run-length-encoded IR modality: ids 4..104 on each row's valid
    tokens, tail-padded with 0 to the modality's width; the same inputs for
    one seed, the same multiset of row lengths for another."""
    config, width, low = rle_config(60), 60, 23
    t = rle_traffic(low, width, batch=8, pool=3)
    a, b, c = (inputs.encoder_pool(config, t, s) for s in (BIG_SEED, BIG_SEED, BIG_SEED + 1))
    for (xa, ma), (xb, mb) in zip(a, b):
        assert np.array_equal(ma, mb) and np.array_equal(xa["RLE"], xb["RLE"])
    assert any(not np.array_equal(xa["RLE"], xc["RLE"]) for (xa, _), (xc, _) in zip(a, c))
    lengths = [np.concatenate([m.sum(1) for _, m in p]) for p in (a, c)]
    assert np.array_equal(*(np.sort(n) for n in lengths))
    assert not np.array_equal(*lengths)
    for x, mask in a:
        ids = x["RLE"]
        assert ids.dtype == np.int32 and mask.dtype == np.int32 and ids.shape == (8, width)
        valid = mask.sum(1)
        assert ((low <= valid) & (valid <= width)).all()
        assert np.array_equal(mask, (np.arange(width)[None, :] < valid[:, None]).astype(np.int32))
        assert (ids[mask == 1] >= 4).all() and (ids[mask == 1] < 105).all()
        assert (ids[mask == 0] == 0).all()


@pytest.mark.parametrize("kind", sorted(NOT_PLAIN_IDS))
def test_no_traffic_for_more_than_plain_ids(kind):
    """A token-id modality that the collator sends with its own positions
    or XVal values gets no traffic."""
    config = rle_config(60)
    config["data"]["RLE"].update(NOT_PLAIN_IDS[kind])
    with pytest.raises(ValueError, match="neither the traffic nor the reference"):
        inputs.encoder_pool(config, rle_traffic(23, 60, batch=2, pool=1), BIG_SEED)


def test_targets_by_seed():
    config = tiny_config()
    t = traffic("ir_patches.train", batch=8, pool=2, target_tokens={"low": 5, "high": 16})
    a, b, c = (inputs.target_pool(config, t, s) for s in (7, 7, 8))
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert any(not np.array_equal(x["labels"], y["labels"]) for x, y in zip(a, c))
    assert np.array_equal(*(np.sort(np.concatenate([x["decoder_mask"].sum(1) for x in p]))
                            for p in (a, c)))
    for x in a:
        rows = np.arange(len(x["labels"]))
        last = x["decoder_mask"].sum(1) - 1
        assert (x["labels"][rows, last] == 3).all() and (x["decoder_ids"][:, 0] == 2).all()


def test_arrivals_and_records():
    t = traffic("ir_patches.serve_open", rate_per_s=50)
    a, b, c = (inputs.arrivals(t, 4.0, s) for s in (BIG_SEED, BIG_SEED, 3))
    assert np.array_equal(a, b) and not np.array_equal(a[:len(c)], c[:len(a)])
    assert (np.diff(a) > 0).all() and a[-1] < 4.0
    config = tiny_config()
    formula = formula_tokenizer(32)
    r1, r2 = (inputs.serve_records(config, t, 20, BIG_SEED, formula) for _ in range(2))
    assert r1 == r2
    for record in r1:
        ids = formula.encode(record["Formula"])
        assert 4 <= len(ids) <= 10 and len(record["IR"]) == config["spectrum_points"]


def test_smiles_round_trip():
    tok = smiles_tokenizer(320)
    rows = np.random.default_rng(0).integers(4, 320, (16, 30))
    for row, text in zip(rows, tok.batch_decode(rows)):
        assert tok.ids_of_decoded(text) == row.tolist()
