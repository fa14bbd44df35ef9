"""The plain reference against the program's plain route, at tiny widths on
the CPU and in float32: teacher-forced logits, the scores and the ranks of
the tokens of beams the program's beam search returned (float32 and int8
self caches), three training steps' losses, gradients and changes (dropout
0.1, the trainer's stream)."""

import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench.harness import cell, common
from perfbench.harness import model as model_maker
from perfbench.reference.check import beam_readings, train_gaps, train_readings
from perfbench.reference.model import LOGITS_BUDGET_BYTES, Reference, rows_in_budget
from perfbench.tests.helpers import (NOT_PLAIN_IDS, rle_config, rle_traffic, tiny_config,
                                     traffic)
from perfbench.traffic import inputs

torch.set_num_threads(2)
RLE_WIDTH, RLE_LOW = 48, 17          # tiny RLE rows: 17-48 valid tokens of 48


def _config(name, **model):
    return rle_config(RLE_WIDTH, **model) if name == "rle" else tiny_config(name, **model)


def _batch(config, seed, batch=3):
    t = traffic("ir_patches.train", batch=batch, pool=3, target_tokens={"low": 5, "high": 16})
    if "RLE" in config["data"]:
        t["valid_tokens"] = {"RLE": {"low": RLE_LOW, "high": RLE_WIDTH}}
    enc = inputs.encoder_pool(config, t, seed)
    tgt = inputs.target_pool(config, t, seed)
    return [{"encoder_inputs": x, "encoder_mask": m, **y} for (x, m), y in zip(enc, tgt)]


@pytest.mark.parametrize("name", ["ir_patches", "rle"])
def test_teacher_forced_logits(name):
    config = _config(name, dtype="float32")
    model, weights = model_maker.build(config, 5, "cpu")
    batch = common.to_device(_batch(config, 5)[0], "cpu")
    with torch.no_grad():
        got = model(batch["encoder_inputs"], batch["encoder_mask"], batch["decoder_ids"],
                    batch["decoder_mask"], batch["labels"])["logits"]
        ref = Reference(weights, config)
        memory = ref.encode(batch["encoder_inputs"], batch["encoder_mask"])
        want = ref.decode(batch["decoder_ids"], batch["decoder_mask"], memory,
                          batch["encoder_mask"])
    keep = batch["decoder_mask"].bool()
    assert torch.allclose(got[keep], want[keep], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_cache", ["bfloat16", "int8"])
def test_beam_scores(kv_cache):
    from multimodalanalytical_tpu_torch.generation.beam_search import (BeamDecoder,
                                                                      kv_cache_quantized)

    config = tiny_config(dtype="float32", kv_cache_dtype=kv_cache)
    model, weights = model_maker.build(config, 6, "cpu")
    t = traffic("ir_patches.decode", batch=3, pool=1)
    (x, mask), = inputs.encoder_pool(config, t, 6)
    x, mask = common.to_device(x, "cpu"), torch.as_tensor(mask)
    length = config["model"]["max_target_length"]
    seqs, scores = BeamDecoder(model.eval()).search(x, mask, 4, max_length=length)
    int8 = kv_cache_quantized(model.config, 4, length)
    assert int8 == (kv_cache == "int8")
    want = beam_readings(Reference(weights, config), x, mask, seqs, 3, int8)
    gap = float((scores - want["scores"]).abs().max())
    # float32 both sides; the int8 cache rounds values that lie near a
    # half step differently after sums taken in another order.
    assert gap < (2e-3 if int8 else 1e-5), gap
    # every token as the top K keeps it, to the same rounding
    assert float(want["rank_gap"].max()) < (2e-2 if int8 else 1e-5), want["rank_gap"]


def test_rank_gap_reads_a_token_the_top_k_never_keeps():
    from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder

    config = tiny_config(dtype="float32")
    model, weights = model_maker.build(config, 7, "cpu")
    (x, mask), = inputs.encoder_pool(config, traffic("ir_patches.decode", batch=2, pool=1), 7)
    x, mask = common.to_device(x, "cpu"), torch.as_tensor(mask)
    length = config["model"]["max_target_length"]
    seqs, _ = BeamDecoder(model.eval()).search(x, mask, 4, max_length=length)
    ref = Reference(weights, config)
    logits = ref.decode(seqs[0, :1, :3].long(), None, ref.encode(x, mask)[:1], mask[:1])
    worst = int(logits[0, 2].argmin())                   # the least likely token at step 2
    altered = seqs.clone()
    altered[0, 0, 3] = worst
    low = Reference(weights, config, fp8=True)
    got = beam_readings(ref, x, mask, altered, 3, False, low)
    assert float(got["rank_gap"][0, 0]) > 1.0
    assert float(got["rank_gap"][1].max()) < 1e-5
    assert torch.isfinite(got["control_rank_gap"]).all()
    assert torch.isfinite(got["control_scores"]).all()


def test_three_training_steps():
    from multimodalanalytical_tpu_torch.training import Trainer

    config = tiny_config(dtype="float32")
    m, s = config["model"], config["trainer"]
    model, weights = model_maker.build(config, 8, "cpu")
    trainer = Trainer(model, optimiser=m["optimiser"], lr=m["lr"], num_steps=s["num_steps"],
                      clip_grad=s["clip_grad"], seed=8)
    batches = _batch(config, 8)
    names = [n for n, _ in model.named_parameters()]
    losses = trainer.fit([batches[0]], epochs=1)
    grads = {n: float(mu.norm()) / (1 - m["adam_beta1"])
             for n, mu in zip(names, trainer.optimizer.mu)}
    losses += trainer.fit(batches[1:], epochs=1)
    change = {n: p.detach() - weights[n] for n, p in zip(names, trainer.params)}
    want = train_readings(weights, config, [common.to_device(b, "cpu") for b in batches], 8)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    gaps = train_gaps({"losses": losses, "grad_norms": grads, "change": change}, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["update_gap"] < 1e-3, gaps
    # The dropout masks are the trainer's: another stream's steps differ.
    other = train_readings(weights, config, [common.to_device(b, "cpu") for b in batches], 9)
    assert abs(other["losses"][0] - losses[0]) > 1e-4


def test_rle_embedding():
    """A run_length_encoding modality: its table's rows, then its LayerNorm."""
    config = _config("rle", dtype="float32")
    model, weights = model_maker.build(config, 9, "cpu")
    g = torch.Generator().manual_seed(9)
    for part in ("weight", "bias"):            # the norm's scale and shift away from 1 and 0
        weights[f"embedding.norm_RLE.{part}"] += torch.randn(128, generator=g)
    model.load_state_dict(weights)
    ids = torch.as_tensor(_batch(config, 9)[0]["encoder_inputs"]["RLE"])
    got = Reference(weights, config).embed("RLE", ids)
    want = F.layer_norm(weights["embedding.embed_RLE.weight"][ids.long()], (128,),
                        weights["embedding.norm_RLE.weight"], weights["embedding.norm_RLE.bias"],
                        1e-5)
    assert torch.equal(got, want)
    with torch.no_grad():
        program = model.embedding.embed_modality("RLE", ids)[0]
    assert torch.allclose(got, program, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(NOT_PLAIN_IDS))
def test_embed_refuses_more_than_plain_ids(kind):
    """A token-id modality that the collator sends with its own positions
    or XVal values has no reference embedding."""
    config = _config("rle", dtype="float32")
    _, weights = model_maker.build(config, 9, "cpu")
    config["data"]["RLE"].update(NOT_PLAIN_IDS[kind])
    ids = torch.full((2, RLE_WIDTH), 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="neither the traffic nor the reference"):
        Reference(weights, config).embed("RLE", ids)


def test_rows_in_budget():
    """At B 128, H 8 the whole batch at the decoding cells' Ls 26 and 279,
    and in their decode (160 beams, 127 queries); 4 rows at the RLE
    recipe's Ls 4090; never fewer than one row."""
    assert rows_in_budget(128, 8, 26, 26) == 128
    assert rows_in_budget(128, 8, 279, 279) == 128
    assert rows_in_budget(160, 8, 127, 279) == 160
    assert rows_in_budget(128, 8, 4090, 4090) == 4
    assert rows_in_budget(128, 8, 4090, 4090, budget=1) == 1


def _rle_case(rows: int = 5):
    config = _config("rle", dtype="float32")
    _, weights = model_maker.build(config, 10, "cpu")
    (x, mask), = inputs.encoder_pool(config, rle_traffic(RLE_LOW, RLE_WIDTH, batch=rows,
                                                         pool=1), 10)
    return config, weights, common.to_device(x, "cpu"), torch.as_tensor(mask)


def _two_rows(heads: int) -> int:
    """A budget of two rows' encoder logits at the tiny RLE width."""
    budget = 2 * heads * RLE_WIDTH ** 2 * 4
    assert rows_in_budget(5, heads, RLE_WIDTH, RLE_WIDTH, budget) == 2
    return budget


@pytest.mark.parametrize("fp8", [False, True], ids=["reference", "control"])
def test_blocked_encode(fp8):
    """Self-attention in blocks of 2 of 5 rows (the last block 1 row) gives
    the whole-batch encode, for the reference and the float8 control."""
    config, weights, x, mask = _rle_case()
    whole = Reference(weights, config, fp8=fp8)
    blocked = Reference(weights, config, fp8=fp8, logits_budget=_two_rows(whole.heads))
    with torch.no_grad():
        want, got = whole.encode(x, mask), blocked.encode(x, mask)
    assert torch.allclose(got, want, atol=1e-6, rtol=0), (got - want).abs().max()


def test_blocked_beam_readings():
    """The beam readings, of the reference and of the control, under a
    budget of two encoder rows (the cross-attention of the decode in blocks
    too) are those of the whole batch."""
    config, weights, x, mask = _rle_case()
    heads = config["model"]["encoder_attention_heads"]
    length = config["model"]["max_target_length"]
    seqs = torch.randint(4, 320, (5, 4, length), generator=torch.Generator().manual_seed(10))
    seqs[:, :, 0] = 2
    found = [beam_readings(Reference(weights, config, logits_budget=budget), x, mask, seqs, 3,
                           True, Reference(weights, config, fp8=True, logits_budget=budget))
             for budget in (_two_rows(heads), LOGITS_BUDGET_BYTES)]
    for key in found[1]:
        assert torch.allclose(found[0][key], found[1][key], atol=1e-6, rtol=0), key


def test_decode_backlog_on_an_rle_config():
    """A whole decode-backlog run on the CPU (the look for a card skipped)
    on an RLE configuration: beams decoded from RLE rows, checked against
    the reference, correct."""
    driver = cell.load_module("drivers", "decode_backlog")
    config = _config("rle")
    t = rle_traffic(RLE_LOW, RLE_WIDTH, batch=4, pool=2, warm_s=0)
    ctx = cell.Context(config, t, 2 ** 31 + 41, 0.3, False, "cpu", time.perf_counter())
    record = driver.run(ctx, lambda s: None)
    assert record["attempted"] >= 1 and record["spectra"] == 4 * record["attempted"]
    assert all(np.isfinite(v) and v <= limit for v, limit in record["checks"].values()), \
        record["checks"]
