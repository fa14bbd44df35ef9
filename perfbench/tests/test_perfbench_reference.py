"""The plain reference against the program's plain route, at tiny widths on
the CPU and in float32: teacher-forced logits, the scores and the ranks of
the tokens of beams the program's beam search returned (float32 and int8
self caches), three training steps' losses, gradients and changes (dropout
0.1, the trainer's stream)."""

import numpy as np
import pytest
import torch

from perfbench.harness import common
from perfbench.harness import model as model_maker
from perfbench.reference.check import beam_readings, train_gaps, train_readings
from perfbench.reference.model import Reference
from perfbench.tests.helpers import tiny_config, traffic
from perfbench.traffic import inputs

torch.set_num_threads(2)


def _batch(config, seed, batch=3):
    t = traffic("ir_patches.train", batch=batch, pool=3, target_tokens={"low": 5, "high": 16})
    enc = inputs.encoder_pool(config, t, seed)
    tgt = inputs.target_pool(config, t, seed)
    return [{"encoder_inputs": x, "encoder_mask": m, **y} for (x, m), y in zip(enc, tgt)]


def test_teacher_forced_logits():
    config = tiny_config(dtype="float32")
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
