"""The port's inference engine and HTTP handler at tiny size (CPU).

Preprocessors are fitted on the IR fixture (tests/make_fixture.py) and saved
as a serving artifact; the model has seeded random weights. Mirrors the
checks of tests/test_serve.py (which trains a JAX model first)."""

import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

TEST_DATA = Path(__file__).parent / "test_data" / "ir_dataset"
BATCH_SIZE, BEAMS = 8, 2
DATA_CONFIG = {
    "Formula": {"type": "text", "column": "molecular_formula", "target": False,
                "preprocessor_arguments": {"tokenizer_regex": "([A-Z]{1}[a-z]?[0-9]*)"}},
    "IR": {"type": "1D_patches", "column": "ir_spectra", "target": False,
           "preprocessor_arguments": {"patch_size": 125, "interpolation": False,
                                      "masking": False}},
    "Smiles": {"type": "text", "column": "smiles", "target": True,
               "preprocessor_arguments": {"tokenizer_regex": (
                   r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\|\/|:"
                   r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")}},
}


@pytest.fixture(scope="module")
def records():
    if not (TEST_DATA / "ir_data.parquet").exists():
        sys.path.insert(0, str(Path(__file__).parent))
        from make_fixture import main

        main(TEST_DATA)
    import pyarrow.parquet as pq

    table = pq.read_table(TEST_DATA / "ir_data.parquet")
    return {"molecular_formula": table.column("molecular_formula").to_pylist(),
            "ir_spectra": table.column("ir_spectra").to_pylist(),
            "smiles": table.column("smiles").to_pylist()}


@pytest.fixture(scope="module")
def server(records, tmp_path_factory):
    import copy

    from multimodalanalytical_tpu.data.collator import MultiModalCollator
    from multimodalanalytical_tpu.data.data_utils import (
        fit_preprocessors,
        save_collator_lengths,
        save_preprocessors,
    )
    from multimodalanalytical_tpu_torch.cli import serve
    from multimodalanalytical_tpu_torch.models.config import resolve_model_config
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    columns = {"Formula": records["molecular_formula"], "IR": records["ir_spectra"],
               "Smiles": records["smiles"]}
    data_config, preprocessors = fit_preprocessors(columns, copy.deepcopy(DATA_CONFIG))
    fitted = MultiModalCollator(preprocessors, data_config)
    fitted.fit_lengths(columns)
    artifact = tmp_path_factory.mktemp("serve") / "preprocessor.json"
    save_preprocessors(artifact, data_config, preprocessors)
    save_collator_lengths(artifact, fitted.max_source_length, fitted.max_target_length)

    collator, tokenizer = serve.collator_from_artifact(artifact, BATCH_SIZE)
    cfg = resolve_model_config(
        {"model_type": "CustomModel", "d_model": 64, "encoder_layers": 1,
         "decoder_layers": 1, "encoder_attention_heads": 4, "decoder_attention_heads": 4,
         "encoder_ffn_dim": 128, "decoder_ffn_dim": 128, "dtype": "float32",
         "max_target_length": 12},
        vocab_size=tokenizer.vocab_size, pad_token_id=tokenizer.pad_token_id,
        bos_token_id=tokenizer.bos_token_id, eos_token_id=tokenizer.eos_token_id)
    model = Seq2SeqModel(cfg, collator.data_config, collator.target_modality,
                         generator=torch.Generator().manual_seed(0))
    engine = serve.InferenceEngine(model, n_beams=BEAMS, batch_size=BATCH_SIZE,
                                   collator=collator, tokenizer=tokenizer, max_wait_ms=5)
    httpd = serve.make_server(engine, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd
    httpd.shutdown()
    engine.close()
    thread.join(timeout=60)
    assert not thread.is_alive()


def _post(base, records):
    req = urllib.request.Request(f"{base}/predict", data=json.dumps({"records": records}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_healthz_roundtrip_and_oversized(server, records):
    base = f"http://127.0.0.1:{server.server_address[1]}"
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["batch_size"] == BATCH_SIZE
    assert health["n_beams"] == BEAMS

    record = {"IR": records["ir_spectra"][0], "Formula": records["molecular_formula"][0]}
    results = _post(base, [record, record])["results"]
    assert len(results) == 2
    for res in results:
        assert len(res["smiles"]) == BEAMS and len(res["scores"]) == BEAMS
        assert all(isinstance(s, str) for s in res["smiles"])
        assert all(np.isfinite(res["scores"]))
    # Both callers sent the same record through one batched decode.
    assert results[0] == results[1]

    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, [record] * (BATCH_SIZE + 1))
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, [{"IR": "not-a-spectrum", "Formula": 42}])
    assert err.value.code == 400


def test_decode_batch_needs_no_collator(server):
    """The decode core takes collated arrays directly and reports its steps."""
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine

    engine = server.engine
    bare = InferenceEngine(engine.model, n_beams=BEAMS, batch_size=BATCH_SIZE)
    batch = engine.collator({"Formula": ["C2H6O"], "IR": [[0.0] * 1791], "Smiles": [""]})
    seqs, scores = bare.decode_batch(batch["encoder_inputs"], batch["encoder_mask"])
    assert seqs.shape == (BATCH_SIZE, BEAMS, engine.max_length)
    assert scores.shape == (BATCH_SIZE, BEAMS)
    assert (seqs[:, :, 0] == engine.model.config.bos_token_id).all()
    assert 1 <= bare.last_stats["steps"] <= engine.max_length - 1


def test_warm_batch_is_decoded_before_the_first_request(server, records):
    """The constructor decodes a warm batch shaped as a real request (the
    JAX engine's ``_warm_batch``, padded to batch_size as the batching loop
    pads), so the first request reuses that decode's entry in the decoder
    (on a CUDA device, its captured graphs) and adds none."""
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine

    engine = server.engine
    fresh = InferenceEngine(engine.decoder.model, n_beams=BEAMS, batch_size=BATCH_SIZE,
                            collator=engine.collator, tokenizer=engine.tokenizer,
                            max_wait_ms=5)
    record = {"IR": records["ir_spectra"][3], "Formula": records["molecular_formula"][3]}
    warm, real = fresh._warm_batch(), fresh._collate([record])

    def layout(tree):
        if isinstance(tree, dict):
            return {key: layout(value) for key, value in tree.items()}
        array = np.asarray(tree)
        return (array.shape, array.dtype)

    assert set(warm["encoder_inputs"]) == set(real["encoder_inputs"]) == {"Formula", "IR"}
    assert layout(warm["encoder_inputs"]) == layout(real["encoder_inputs"])
    assert layout(warm["encoder_mask"]) == layout(real["encoder_mask"])
    assert np.asarray(warm["encoder_mask"]).shape[0] == BATCH_SIZE

    assert len(fresh.decoder._decodes) == 1
    warm_key = next(iter(fresh.decoder._decodes))
    assert fresh.warm_stats["steps"] >= 1
    fresh.start()
    try:
        pending = fresh.submit(record)
        assert pending.event.wait(timeout=120) and pending.error is None
    finally:
        fresh.close()
    assert list(fresh.decoder._decodes) == [warm_key]
    assert len(pending.result["smiles"]) == BEAMS
