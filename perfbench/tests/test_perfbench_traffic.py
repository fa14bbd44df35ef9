"""The traffic makers: one seed gives the same inputs, another seed other
values in the same multiset of sizes."""

import numpy as np

from perfbench.tests.helpers import tiny_config, traffic
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
