"""The port's spans and counters on the CPU (``tracing.py`` and its call sites).

The recorder records nothing while it is off; on, its spans nest by parent
per thread, share their unit's id, lie on ``time.perf_counter_ns()`` and
show up in a ``torch.profiler`` trace; it keeps only the newest spans. At
the call sites: the engine's record path stamps each request and logs each
batch, the beam loop's spans follow its dispatch runs and ``done`` reads,
and the trainer counts its host seconds every step and traces its steps
inside ``profile_dir``'s window. The device's event times are card tests
(``tests/test_torch_cuda.py``).
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

from multimodalanalytical_tpu_torch import tracing  # noqa: E402
from multimodalanalytical_tpu_torch.generation.beam_search import (  # noqa: E402
    BeamDecoder,
    read_device_times,
)
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.training.trainer import Trainer  # noqa: E402

TARGET_VOCAB = 40
DATA_CONFIG = {
    "Formula": {"type": "text", "vocab_size": 32, "target": False},
    "IR": {"type": "1D_patches", "target": False, "preprocessor_arguments": {"patch_size": 125}},
    "Smiles": {"type": "text", "vocab_size": TARGET_VOCAB, "target": True},
}
SMILES_REGEX = r"(Cl?|Br?|N|O|S|c|n|o|\(|\)|=|[0-9])"
MODEL = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4,
             encoder_ffn_dim=128, decoder_ffn_dim=128, encoder_layers=1, decoder_layers=1,
             vocab_size=TARGET_VOCAB, dtype="float32")


@pytest.fixture
def recording():
    """The program's recorder, on for the test and emptied after it."""
    tracing.RECORDER.take()
    tracing.RECORDER.enabled = True
    try:
        yield tracing.RECORDER
    finally:
        tracing.RECORDER.enabled = False
        tracing.RECORDER.take()


def _model(dropout=0.0):
    return Seq2SeqModel(ModelConfig(dropout=dropout, max_target_length=12, **MODEL),
                        DATA_CONFIG, "Smiles", generator=torch.Generator().manual_seed(0))


def _encoder_batch(batch, seed):
    rng = np.random.default_rng(seed)
    enc = {"Formula": rng.integers(1, 32, (batch, 12)).astype(np.int32),
           "IR": rng.random((batch, 14, 125)).astype(np.float32)}
    mask = np.ones((batch, 26), np.int32)
    mask[-1, 20:] = 0
    return enc, mask


def _train_batches(steps, batch=2, target_len=12):
    out = []
    for step in range(steps):
        enc, mask = _encoder_batch(batch, 100 + step)
        rng = np.random.default_rng(200 + step)
        labels = rng.integers(4, TARGET_VOCAB, (batch, target_len)).astype(np.int32)
        labels[0, 8:] = -100
        out.append({"encoder_inputs": enc, "encoder_mask": mask,
                    "decoder_ids": rng.integers(4, TARGET_VOCAB, (batch, target_len))
                    .astype(np.int32),
                    "decoder_mask": np.ones((batch, target_len), np.int32), "labels": labels,
                    "n_valid": batch})
    return out


# ------------------------------------------------------------- recorder
def test_off_recorder_records_nothing():
    recorder = tracing.Recorder()
    with recorder.span("engine.decode", 3):
        with recorder.span("beam.prologue"):
            pass
    assert not recorder.enabled and recorder.take() == []


def test_spans_nest_by_parent_and_share_their_unit_id():
    recorder = tracing.Recorder()
    recorder.enabled = True
    with recorder.span("engine.decode", 7):
        with recorder.span("beam.dispatch"):
            pass
        with recorder.span("beam.done_wait"):
            pass
    with recorder.span("train.plan", 8):
        pass
    spans = {s.name: s for s in recorder.take()}
    assert spans["engine.decode"].parent is None and spans["engine.decode"].id == 7
    for name in ("beam.dispatch", "beam.done_wait"):
        assert spans[name].parent == "engine.decode" and spans[name].id == 7
    assert spans["train.plan"].parent is None and spans["train.plan"].id == 8
    assert recorder.take() == []


def test_each_span_lies_between_clock_reads_around_it():
    recorder = tracing.Recorder()
    recorder.enabled = True
    before = time.perf_counter_ns()
    with recorder.span("engine.collate", 1):
        time.sleep(0.002)
    after = time.perf_counter_ns()
    (span,) = recorder.take()
    assert before <= span.start_ns < span.end_ns <= after
    assert span.end_ns - span.start_ns >= 2_000_000


def test_recorder_keeps_the_newest_spans_only():
    recorder = tracing.Recorder(capacity=5)
    recorder.enabled = True
    for i in range(12):
        with recorder.span("train.fetch", i):
            pass
    assert [s.id for s in recorder.take()] == [7, 8, 9, 10, 11]


def test_threads_nest_their_own_spans():
    recorder = tracing.Recorder()
    recorder.enabled = True
    inside = threading.Event()
    release = threading.Event()

    def worker():
        with recorder.span("engine.fill", 2):
            inside.set()
            release.wait(timeout=30)

    thread = threading.Thread(target=worker)
    thread.start()
    assert inside.wait(timeout=30)
    with recorder.span("train.plan", 5):     # opened while the worker's span is open
        pass
    release.set()
    thread.join(timeout=30)
    assert not thread.is_alive()
    spans = {s.name: s for s in recorder.take()}
    assert spans["train.plan"].parent is None and spans["train.plan"].id == 5
    assert spans["engine.fill"].parent is None and spans["engine.fill"].id == 2


def test_profiler_trace_shows_the_span_names():
    recorder = tracing.Recorder()
    recorder.enabled = True
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("beam.prologue"):
            torch.ones(4).add_(1)
    names = {event.key for event in prof.key_averages()}
    assert "beam.prologue" in names


# ------------------------------------------------------------- beam loop
@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_beam_loop_spans_follow_its_runs_and_reads(recording, check_every):
    """One ``beam.dispatch`` per run of up to ``check_every`` steps, one
    ``beam.done_wait`` per full run; the result is the untraced search's;
    off a CUDA device the stats carry no device times."""
    model = _model()
    enc, mask = _encoder_batch(3, 5)
    inputs = {k: torch.as_tensor(v) for k, v in enc.items()}
    decoder = BeamDecoder(model)
    stats = {}
    seqs, scores = decoder.search(inputs, torch.as_tensor(mask), 2, max_length=12,
                                  stage_size=4, check_every=check_every, stats=stats)
    spans = recording.take()
    recording.enabled = False
    plain = decoder.search(inputs, torch.as_tensor(mask), 2, max_length=12, stage_size=4,
                           check_every=check_every)
    assert torch.equal(seqs, plain[0]) and torch.equal(scores, plain[1])

    names = [s.name for s in spans]
    replays = stats["replays"]
    assert names.count("beam.dispatch") == -(-replays // check_every)
    assert names.count("beam.done_wait") == replays // check_every
    for name in ("beam.load", "beam.prologue", "beam.epilogue"):
        assert names.count(name) == 1
    assert "beam.capture" not in names and "events" not in stats
    read_device_times(stats)
    assert "prologue_ms" not in stats and "steps_ms" not in stats


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engine():
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator
    from multimodalanalytical_tpu_torch.data.data_utils import fit_preprocessors

    rng = np.random.default_rng(0)
    config = {
        "Formula": {"type": "text", "column": "formula", "target": False,
                    "preprocessor_arguments": {"tokenizer_regex": "([A-Z]{1}[a-z]?[0-9]*)"}},
        "IR": {"type": "1D_patches", "column": "ir", "target": False,
               "preprocessor_arguments": {"patch_size": 125, "interpolation": False,
                                          "masking": False}},
        "Smiles": {"type": "text", "column": "smiles", "target": True,
                   "preprocessor_arguments": {"tokenizer_regex": SMILES_REGEX}},
    }
    columns = {"Formula": ["C6H6O", "C2H6O", "CH4N2O", "C7H8"] * 4,
               "IR": [rng.random(1750).tolist() for _ in range(16)],
               "Smiles": ["Oc1ccccc1", "CCO", "NC(N)=O", "Cc1ccccc1"] * 4}
    data_config, preprocessors = fit_preprocessors(columns, config)
    collator = MultiModalCollator(preprocessors, data_config, pad_to_batch_size=4)
    collator.fit_lengths(columns)
    target = preprocessors["Smiles"]
    cfg = ModelConfig(dropout=0.0, max_target_length=10, **dict(
        MODEL, vocab_size=target.vocab_size), pad_token_id=target.pad_token_id,
        bos_token_id=target.bos_token_id, eos_token_id=target.eos_token_id)
    model = Seq2SeqModel(cfg, data_config, "Smiles", generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, n_beams=2, batch_size=4, collator=collator,
                             tokenizer=target, max_wait_ms=50)
    engine.columns = columns
    return engine


def test_engine_record_path_logs_each_batch_and_stamps_each_request(engine, recording):
    columns = engine.columns
    engine.start()
    try:
        pendings = [engine.submit({"Formula": columns["Formula"][i], "IR": columns["IR"][i]})
                    for i in range(3)]
        for pending in pendings:
            assert pending.event.wait(timeout=120) and pending.error is None
    finally:
        engine.close()
    entries = list(engine.batch_log)
    assert sum(e["rows"] for e in entries) == 3
    for e in entries:
        assert e["collate_s"] > 0 and e["decode_s"] > 0 and e["detokenise_s"] > 0
        assert e["deliver_s"] > 0 and e["opened"] <= e["closed"]
    for pending in pendings:
        assert pending.submitted <= pending.started
        assert any(e["opened"] <= pending.started for e in entries)

    spans = recording.take()
    ids = {e["id"] for e in entries}
    for name in ("engine.fill", "engine.collate", "engine.decode", "engine.copy_out",
                 "engine.detokenise", "engine.deliver", "beam.prologue", "beam.dispatch"):
        assert {s.id for s in spans if s.name == name} == ids, name
    assert {s.parent for s in spans if s.name.startswith("beam.")} == {"engine.decode"}
    assert {s.parent for s in spans if s.name == "engine.copy_out"} == {"engine.decode"}
    assert any(s.name == "engine.queue_get" for s in spans)


def test_decode_batch_called_directly_takes_ids_of_its_own(engine, recording):
    enc, mask = engine._warm_batch()["encoder_inputs"], engine._warm_batch()["encoder_mask"]
    engine.decode_batch(enc, mask)
    engine.decode_batch(enc, mask)
    decodes = [s for s in recording.take() if s.name == "engine.decode"]
    assert len(decodes) == 2 and decodes[0].id != decodes[1].id
    assert "events" not in engine.last_stats and engine.last_stats["steps"] >= 1


# --------------------------------------------------------------- trainer
def test_fit_counts_host_seconds_every_step_and_traces_its_loop(recording):
    trainer = Trainer(_model(), optimiser="adamw", lr=1e-3, num_steps=4, seed=1)
    seen = []

    def loader():
        for batch in _train_batches(4):
            seen.append(trainer.step_stats["host_s"])
            yield batch

    trainer.fit(loader(), epochs=1, log_every=2)
    seen.append(trainer.step_stats["host_s"])
    assert seen[0] == 0.0 and all(b > a for a, b in zip(seen, seen[1:]))
    spans = recording.take()
    for name, steps in (("train.plan", {0, 1, 2, 3}), ("train.eager", {0, 1, 2, 3}),
                        ("train.fetch", {0, 1, 2, 3, 4}), ("train.log", {0, 2})):
        assert {s.id for s in spans if s.name == name} == steps, name
    assert "train.replay" not in {s.name for s in spans}


def test_profile_window_traces_the_trainers_spans(tmp_path):
    trainer = Trainer(_model(), optimiser="adamw", lr=1e-3, num_steps=7, seed=1)
    trainer.fit(_train_batches(7), epochs=1, profile_dir=str(tmp_path))
    (path,) = tmp_path.glob("train_steps_*.json")
    names = {event.get("name") for event in json.loads(path.read_text())["traceEvents"]}
    assert {"train.plan", "train.eager", "train.fetch"} <= names
    assert not tracing.RECORDER.enabled and tracing.RECORDER.take() == []
