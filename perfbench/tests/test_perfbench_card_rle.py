"""On the card: the reference's check of one decoded batch of the RLE IR
recipe at its own size fits and finishes.

The recipe (``chip_smoke.py``'s RLE model): CustomModel d 512, 6 + 6
layers, 8 heads, FFN 2048, bf16, int8 self cache, positions to 4096; one
run-length-encoded IR modality of 4090 tokens (vocabulary 105), rows of
2173-4090 valid tokens, an assumed upper range (the repository's IR
spectra give 1532-2166 tokens at their own 1791 points and 2174-3490 at
4000; the preprocessor caps a row at 4090); SMILES 320. One B 128 batch from the traffic maker
is decoded at K 10 through ``InferenceEngine.decode_batch``, as the decode
backlog does; the program is freed, and ``common.reference_checks`` runs on
the batch, without and with the float8 control, each from a reset of the
device's peak. Each prints its peak, seconds and readings.

    python -m pytest -m cuda -s perfbench/tests/test_perfbench_card_rle.py
"""

import json
import math
import time

import pytest
import torch

from perfbench.harness import cell, common
from perfbench.harness import model as model_maker
from perfbench.tests.helpers import with_rle
from perfbench.traffic import inputs
from perfbench.traffic.tokenizer import EOS_ID

RLE_LENGTH, RLE_LOW = 4090, 2173
SEED = 2 ** 31 + 4090
PEAK_LIMIT = 24 * 2 ** 30


def _rle_recipe() -> dict:
    """The IR-patches configuration's model (the recipe's widths) and target,
    with positions to 4096 and the RLE modality in place of its inputs."""
    config = with_rle(cell.load_json("configs", "ir_patches"), RLE_LENGTH)
    config["model"]["max_position_embeddings"] = 4096
    return config


@pytest.mark.cuda
def test_rle_check_fits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.generation.beam_search import kv_cache_quantized

    config = _rle_recipe()
    traffic = {"batch": 128, "beams": 10, "pool": 1, "sizes_seed": 4090,
               "valid_tokens": {"RLE": {"low": RLE_LOW, "high": RLE_LENGTH}}}
    model, weights = model_maker.build(config, SEED, "cuda")
    weights = common.host_weights(weights)
    engine = InferenceEngine(model, n_beams=traffic["beams"], batch_size=traffic["batch"])
    (x, mask), = inputs.encoder_pool(config, traffic, SEED)
    t0 = time.perf_counter()
    seqs, scores = engine.decode_batch(x, mask)
    decode_s = time.perf_counter() - t0
    cfg = engine.model.config
    int8 = kv_cache_quantized(cfg, traffic["beams"], cfg.max_target_length)
    program_peak = torch.cuda.max_memory_allocated()
    del engine, model
    common.free("cuda")
    case = {"inputs": x, "mask": mask, "seqs": seqs, "scores": scores}
    for control in (False, True):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        found = common.reference_checks(config, weights, "cuda", [case], EOS_ID, int8, control)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        print(json.dumps({"control": control, "check_s": seconds, "check_peak_bytes": peak,
                          "decode_s": decode_s, "program_peak_bytes": program_peak,
                          "int8": int8, "valid_keys": int(mask.sum()),
                          "card": torch.cuda.get_device_name(), "found": found}), flush=True)
        assert peak <= PEAK_LIMIT, peak
        assert found["beam_order_gap"][0] == 0.0, found
        assert math.isfinite(found["beam_gap_mean"][0]), found
        if control:
            assert math.isfinite(found["beam_gap_mean"][1]), found
