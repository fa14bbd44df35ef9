"""The port's overlap of host work with the device (CPU): asynchronous
checkpoint saves, pipelined ``validate`` / ``predict`` and asynchronous
train-metric logging.

The manager tests are ``tests/test_trainer.py``'s async tests on the port's
``CheckpointManager``: ``save_async`` then ``wait`` restores what ``save``
would, a wedged saver is abandoned by a bounded ``wait`` (and an earlier
background error is not lost), and the end of ``fit`` drops a pinned best
that a wedged saver could never write. Beyond them: a snapshot taken before
an in-place optimizer step saves the earlier weights (and an uncopied
"snapshot" is shown to fail that check), a fit with asynchronous saves
leaves the files and index of the synchronous route, tensor for tensor, a
wedged saver does not hang ``fit``, and ``validate`` / ``predict`` at
pipeline depths 1 and 8 over 4 batches equal depth 0 and the JAX
``Trainer`` (as ``tests/test_torch_evaluate.py`` holds depth 8 on 2), each
batch scored after the next batch's search has started, in pieces run by
the search between its reads of ``done``.
"""

import dataclasses
import json
import logging
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")

from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.parallel.mesh import make_mesh  # noqa: E402
from multimodalanalytical_tpu.training import trainer as jax_trainer  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.training import Trainer  # noqa: E402
from multimodalanalytical_tpu_torch.training import trainer as trainer_module  # noqa: E402
from multimodalanalytical_tpu_torch.training.checkpoint import (  # noqa: E402
    STATE_FILE,
    CheckpointManager,
    Snapshot,
    to_cpu,
)
from test_torch_checkpoint import _loader, _trainer, setup  # noqa: E402,F401
from test_torch_evaluate import MAX_LENGTH, VOCAB, Tokenizer  # noqa: E402
from test_torch_model import data_config, example_batch, random_params  # noqa: E402

WAIT_S = 30.0   # bound on every wait of a test that should take well under a second


class _SyncSaves(CheckpointManager):
    """The synchronous route behind the asynchronous protocol: each request
    drains the queue, then saves at once."""

    def save_async(self, step, tree, metrics, fresh=()):
        self.wait()
        self.save(step, tree, metrics)


def _tree(scale=1.0, step=3):
    return {"params": {"w": torch.arange(8, dtype=torch.float32) * scale}, "step": step}


# ------------------------------------------------------------------ manager


def test_async_checkpoint_save(tmp_path):
    """``save_async`` writes what ``save`` writes, and ``wait`` drains the
    saving thread; a second request while the first may be in flight wins."""
    mgr = CheckpointManager(tmp_path / "ck")
    tree = _tree()
    mgr.save_async(3, tree, {"val_molecular_accuracy": 0.5})
    tree["params"]["w"].mul_(0)   # the live tensor changes after the request
    mgr.save_async(4, _tree(2.0, 4), {"val_molecular_accuracy": 0.7})
    assert mgr.wait(timeout_s=WAIT_S) is True
    restored = mgr.restore("last")
    assert restored["step"] == 4
    torch.testing.assert_close(restored["params"]["w"], torch.arange(8.0) * 2, rtol=0, atol=0)
    assert mgr.best_step == 4
    if (tmp_path / "ck" / "step_3").exists():   # written unless the second request replaced it
        torch.testing.assert_close(mgr.restore("step_3")["params"]["w"], torch.arange(8.0),
                                   rtol=0, atol=0)
    on_disk = json.loads((tmp_path / "ck" / "index.json").read_text())
    assert on_disk == mgr._index and on_disk["last"]["step"] == 4


def test_wait_timeout_abandons_wedged_save(tmp_path, caplog):
    """A saver stuck in its writes does not block ``wait`` past its bound:
    the save is abandoned, what survives on disk is logged, False comes
    back; once unstuck, a clean ``wait`` succeeds and the save lands."""
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, _tree(step=1), {"val_molecular_accuracy": 0.5})
    release = threading.Event()
    real_write = mgr._write

    def wedged_write(step, host_tree, metrics):
        release.wait(WAIT_S)
        real_write(step, host_tree, metrics)

    mgr._write = wedged_write
    mgr.save_async(2, _tree(step=2), {"val_molecular_accuracy": 0.9})
    t0 = time.monotonic()
    with caplog.at_level(logging.ERROR):
        assert mgr.wait(timeout_s=0.5) is False
    assert time.monotonic() - t0 < 10.0
    assert "Abandoning in-flight checkpoint save" in caplog.text
    assert "last=step 1" in caplog.text
    release.set()
    assert mgr.wait(timeout_s=WAIT_S) is True
    assert mgr.restore("last")["step"] == 2


def test_wait_timeout_keeps_an_earlier_error(tmp_path, caplog):
    """A save that failed before the saver wedged is logged by the timed-out
    ``wait`` and raised by the next one."""
    mgr = CheckpointManager(tmp_path / "ck")
    release = threading.Event()
    failed = threading.Event()

    def write(step, host_tree, metrics):
        if step == 1:
            failed.set()
            raise OSError("disk full")
        release.wait(WAIT_S)

    mgr._write = write
    mgr.save_async(1, _tree(step=1), {})
    assert failed.wait(WAIT_S)
    mgr.save_async(2, _tree(step=2), {})
    with caplog.at_level(logging.ERROR):
        assert mgr.wait(timeout_s=0.5) is False
    assert "A previous asynchronous save had already failed" in caplog.text
    release.set()
    with pytest.raises(OSError, match="disk full"):
        mgr.wait(timeout_s=WAIT_S)
    assert mgr.wait(timeout_s=WAIT_S) is True


def test_synchronous_save_waits_for_the_queue(tmp_path):
    """``save`` drains a running asynchronous save before it writes, so an
    older queued state never lands over a newer synchronous one."""
    mgr = CheckpointManager(tmp_path / "ck")
    release = threading.Event()
    real_write = mgr._write
    order = []

    def slow_write(step, host_tree, metrics):
        if step == 1:
            release.wait(WAIT_S)
        order.append(step)
        real_write(step, host_tree, metrics)

    mgr._write = slow_write
    mgr.save_async(1, _tree(step=1), {})
    threading.Timer(0.2, release.set).start()
    mgr.save(2, _tree(step=2), {})
    assert order == [1, 2] and mgr.restore("last")["step"] == 2


@pytest.mark.parametrize("snapshot", ["device copy", "planted: live tensors"])
def test_snapshot_before_an_optimizer_step_saves_the_earlier_weights(setup, tmp_path, snapshot):
    """The state requested before an in-place AdamW step is what lands on
    disk, while the saving thread writes only after the step. The planted
    fault (a snapshot that hands over the live tensors uncopied) publishes
    the later weights, and the same check rejects it."""
    trainer = _trainer(setup)
    batch = next(iter(_loader(setup)))
    trainer.train_step(batch)
    mgr = CheckpointManager(tmp_path / "ck")
    if snapshot != "device copy":
        mgr.snapshot = lambda tree, fresh=(): Snapshot(tree)
    stepped = threading.Event()
    real_write = mgr._write

    def write_after_the_step(step, host_tree, metrics):
        assert stepped.wait(WAIT_S)
        real_write(step, host_tree, metrics)

    mgr._write = write_after_the_step
    requested = to_cpu(trainer.state_tree())
    trainer._save_state(mgr, {})
    trainer.train_step(batch)
    stepped.set()
    assert mgr.wait(timeout_s=WAIT_S) is True
    saved = mgr.restore("last")
    assert saved["step"] == requested["step"] == 1
    same = all(torch.equal(saved["params"][k], requested["params"][k])
               for k in requested["params"])
    same_moments = all(torch.equal(a, b) for a, b in zip(saved["opt_state"]["mu"],
                                                         requested["opt_state"]["mu"]))
    assert (same and same_moments) == (snapshot == "device copy")


# ------------------------------------------------------------------ trainer


def _files(directory):
    """{checkpoint name: its state} and the index, as written."""
    states = {p.name: torch.load(p / STATE_FILE, map_location="cpu", weights_only=True)
              for p in sorted(directory.iterdir()) if (p / STATE_FILE).exists()}
    return states, json.loads((directory / "index.json").read_text())


def _assert_trees_equal(got, want, where):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{where}/{i}")
    else:
        assert got == want, where


@pytest.mark.parametrize("every,epochs", [
    (1, 3),   # a save at every validation
    (3, 2),   # validation 2's improvement is pinned and flushed at the end of the fit
])
def test_fit_with_async_saves_writes_the_synchronous_routes_files(setup, tmp_path, every,
                                                                  epochs):
    runs = {}
    for route, manager in (("async", CheckpointManager), ("sync", _SyncSaves)):
        trainer = _trainer(setup, checkpoint_every_n_vals=every, monitor="val_loss")
        ckpts = manager(tmp_path / route, monitor="val_loss", mode="min")
        pinned = []
        flush = trainer._flush_pending_best

        def recording(checkpoints, trainer=trainer, flush=flush, pinned=pinned):
            if trainer._pending_best is not None:
                pinned.append(trainer._pending_best[0])
            flush(checkpoints)

        trainer._flush_pending_best = recording
        losses = trainer.fit(_loader(setup), _loader(setup, shuffle=False), epochs=epochs,
                             checkpoints=ckpts)
        runs[route] = (losses, pinned, *_files(tmp_path / route))
    (losses, pinned, states, index), (want_losses, want_pinned, want_states, want_index) = (
        runs["async"], runs["sync"])
    assert losses == want_losses
    assert pinned == want_pinned == ([] if every == 1 else [4])
    assert index == want_index
    names = {"last", "best"} | {e["name"] for e in want_index["checkpoints"]}
    assert set(states) == set(want_states) == names
    for name in names:
        _assert_trees_equal(states[name], want_states[name], name)
    assert states["last"]["step"] == 2 * epochs


def test_fit_returns_while_the_saver_is_wedged(setup, tmp_path, caplog):
    """A saver stuck in its writes holds ``fit`` no longer than
    ``checkpoint_wait_timeout_s``."""
    trainer = _trainer(setup, checkpoint_wait_timeout_s=0.5)
    ckpts = CheckpointManager(tmp_path / "ck")
    release = threading.Event()
    ckpts._write = lambda *args: release.wait(WAIT_S)
    t0 = time.monotonic()
    with caplog.at_level(logging.ERROR):
        trainer.fit(_loader(setup), _loader(setup, shuffle=False), epochs=1, checkpoints=ckpts)
    release.set()
    assert time.monotonic() - t0 < 20.0
    assert "Abandoning in-flight checkpoint save" in caplog.text


def test_fit_end_drops_pending_best_when_saver_wedged(setup, caplog):
    """The end of ``fit`` with a wedged saver: the first drain returns, the
    pinned best is dropped with an error, and nothing is queued."""
    trainer = _trainer(setup, checkpoint_wait_timeout_s=0.5)
    enqueued = []

    class _WedgedCkpts:
        def save_async(self, step, tree, metrics, fresh=()):
            enqueued.append(step)

        def snapshot(self, tree, fresh=()):
            return tree

        def wait(self, timeout_s=None):
            return False

    trainer._pending_best = (7, {"params": {}}, {"val_molecular_accuracy": 0.9})
    with caplog.at_level(logging.ERROR):
        trainer._flush_pending_best(_WedgedCkpts())
    assert trainer._pending_best is None and enqueued == []
    assert "Dropping rate-suppressed best" in caplog.text


def test_train_metrics_are_logged_off_the_loop(setup, caplog):
    """Every ``log_every``-th step's line, written by the log thread and
    drained before ``fit`` returns; the main thread never formats one."""
    trainer = _trainer(setup)
    threads = []
    log_train = trainer._log_train

    def recording(*args):
        threads.append(threading.current_thread().name)
        log_train(*args)

    trainer._log_train = recording
    with caplog.at_level(logging.INFO):
        losses = trainer.fit(_loader(setup), None, epochs=2, log_every=1)
    lines = [r.getMessage() for r in caplog.records if "train_loss" in r.getMessage()]
    assert [line.split(" train_loss")[0] for line in lines] == [
        "epoch 0 step 0", "epoch 0 step 1", "epoch 1 step 2", "epoch 1 step 3"]
    assert [float(line.split("train_loss ")[1].split()[0]) for line in lines] == [
        pytest.approx(loss, abs=5e-5) for loss in losses]
    assert threads == ["train-metrics-log"] * 4


def test_a_stuck_log_thread_turns_logging_off(setup, monkeypatch, caplog):
    """A full queue and a drain past its bound each turn logging off with a
    warning, and neither blocks."""
    monkeypatch.setattr(trainer_module, "LOG_QUEUE_SIZE", 2)
    trainer = _trainer(setup)
    release = threading.Event()
    trainer._log_train = lambda *args: release.wait(WAIT_S)
    metrics = {"loss": torch.tensor(1.0)}
    with caplog.at_level(logging.WARNING):
        trainer._drain_logs()                    # nothing queued yet: returns
        for step in range(2):
            trainer._log_async(None, 0, step, metrics)
        t0 = time.monotonic()
        trainer._drain_logs(timeout_s=0.3)
        assert time.monotonic() - t0 < 10.0 and trainer._log_dead
        assert "drain timed out" in caplog.text
        trainer._log_dead = False
        for step in range(2, 6):
            trainer._log_async(None, 0, step, metrics)
    assert trainer._log_dead and "queue full" in caplog.text
    release.set()


# ------------------------------------------------------------------ pipeline


@pytest.fixture(scope="module")
def pair4():
    """``tests/test_torch_evaluate.py``'s model pair on 4 batches of 3 rows
    (the last two with padding rows); half the targets are greedy
    predictions, so the molecular accuracy counts real matches."""
    from multimodalanalytical_tpu_torch.generation.beam_search import greedy_decode
    from test_torch_model import to_torch

    cfg = JaxConfig(d_model=64, encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
                    vocab_size=VOCAB, dtype="float32", max_target_length=MAX_LENGTH, dropout=0.0)
    jmodel = JaxModel(config=cfg, data_config=data_config(VOCAB), target_modality="Smiles")
    sample = example_batch()
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, sample["encoder_inputs"], sample["encoder_mask"], sample["decoder_ids"],
        sample["decoder_mask"], sample["labels"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed=3)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), data_config(VOCAB), "Smiles")
    load_flax_params(model, params)

    tokenizer = Tokenizer()
    batches = []
    for seed, n_valid in ((0, 3), (1, 3), (2, 2), (3, 1)):
        batch = example_batch(batch=3, seed=seed)
        if n_valid < 3:                       # collator padding rows
            batch["encoder_mask"][n_valid:] = 0
            batch["labels"][n_valid:] = -100
        greedy = greedy_decode(model, to_torch(batch["encoder_inputs"]),
                               torch.as_tensor(batch["encoder_mask"]), max_length=MAX_LENGTH)
        decoded = tokenizer.batch_decode(greedy.numpy())
        batch["target_strings"] = [d if i % 2 == 0 else "t5 t6" for i, d in enumerate(decoded)]
        batch["sample_id"] = [f"s{seed}_{i}" for i in range(3)]   # an extra column
        batch["n_valid"] = n_valid
        batches.append(batch)
    jt = jax_trainer.Trainer(jmodel, tokenizer, mesh=make_mesh(devices=jax.devices()[:1]),
                             seed=0)
    state = jt.state_with_params(jax.jit(jt.init_state)(sample), params)
    return jt, state, Trainer(model, tokenizer), batches


def _at_depth(monkeypatch, trainer, depth, run):
    """``run()`` at pipeline ``depth``, and the order of the beam searches
    ("search") and the detokenising ("decode", or "decode in search" where
    the search ran it between its reads of ``done``)."""
    monkeypatch.setattr(trainer_module, "PIPELINE_DEPTH", depth)
    events, searching = [], []
    tokenizer, decode, search = trainer.tokenizer, trainer.tokenizer.batch_decode, trainer._decode

    def recording_decode(ids, skip_special_tokens=True):
        events.append("decode in search" if searching else "decode")
        return decode(ids, skip_special_tokens=skip_special_tokens)

    def recording_search(*args, **kwargs):
        events.append("search")
        searching.append(True)
        try:
            return search(*args, **kwargs)
        finally:
            searching.pop()

    tokenizer.batch_decode, trainer._decode = recording_decode, recording_search
    try:
        return run(), events
    finally:
        del tokenizer.batch_decode, trainer._decode


def _assert_pipelined(events, depth, batches=4):
    """Each batch, scored in one piece here, is detokenised after the next
    batch's search has started and before the search ``depth`` + 1 batches
    on; at depth 0 before the next search."""
    searches = [i for i, e in enumerate(events) if e == "search"]
    decodes = [i for i, e in enumerate(events) if e.startswith("decode")]
    assert len(searches) == len(decodes) == batches
    if depth == 0:
        assert events == ["search", "decode"] * batches
        return
    for k, at in enumerate(decodes):
        assert searches[k + 1] < at if k + 1 < batches else searches[-1] < at
        if k + depth + 1 < batches:
            assert at < searches[k + depth + 1]
    assert "decode in search" in events


@pytest.mark.parametrize("depth", [1, 8])
def test_pipelined_validate_equals_depth_zero_and_jax(pair4, monkeypatch, depth):
    jt, state, trainer, batches = pair4
    want = jt.validate(state, batches, jt._build_eval_step())
    serial, events0 = _at_depth(monkeypatch, trainer, 0, lambda: trainer.validate(batches))
    got, events = _at_depth(monkeypatch, trainer, depth, lambda: trainer.validate(batches))
    assert got == serial
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert got["val_token_acc"] == want["val_token_acc"]
    assert got["val_molecular_accuracy"] == want["val_molecular_accuracy"] == 6 / 9
    _assert_pipelined(events0, 0)
    _assert_pipelined(events, depth)


@pytest.mark.parametrize("depth", [1, 8])
def test_pipelined_predict_equals_depth_zero_and_jax(pair4, monkeypatch, depth):
    jt, state, trainer, batches = pair4
    want = jt.predict(state, batches, n_beams=4)
    serial, _ = _at_depth(monkeypatch, trainer, 0, lambda: trainer.predict(batches, n_beams=4))
    got, events = _at_depth(monkeypatch, trainer, depth,
                            lambda: trainer.predict(batches, n_beams=4))
    assert got == serial
    assert got.keys() == want.keys()
    assert len(got["predictions"]) == 9 and all(len(p) == 4 for p in got["predictions"])
    assert got["predictions"] == want["predictions"]
    assert got["targets"] == want["targets"]
    assert got["sample_id"] == want["sample_id"] == ["s0_0", "s0_1", "s0_2", "s1_0", "s1_1",
                                                     "s1_2", "s2_0", "s2_1", "s3_0"]
    np.testing.assert_allclose(got["avg_loss"], want["avg_loss"], rtol=1e-5)
    _assert_pipelined(events, depth)


def test_scoring_is_split_into_pieces_of_score_rows(pair4, monkeypatch):
    """At SCORE_ROWS 2, a batch's 12 beam rows (3 rows x K 4) are
    detokenised in 6 pieces, the results unchanged."""
    _, _, trainer, batches = pair4
    want, _ = _at_depth(monkeypatch, trainer, 8, lambda: trainer.predict(batches, n_beams=4))
    monkeypatch.setattr(trainer_module, "SCORE_ROWS", 2)
    got, events = _at_depth(monkeypatch, trainer, 8, lambda: trainer.predict(batches, n_beams=4))
    assert got == want
    assert sum(e.startswith("decode") for e in events) == 6 + 6 + 4 + 2


def test_a_scoring_error_is_raised_from_predict(pair4, monkeypatch):
    _, _, trainer, batches = pair4
    monkeypatch.setattr(trainer_module, "PIPELINE_DEPTH", 8)

    def broken(ids, skip_special_tokens=True):
        raise ValueError("bad token")

    trainer.tokenizer.batch_decode = broken
    try:
        with pytest.raises(ValueError, match="bad token"):
            trainer.predict(batches, n_beams=2)
    finally:
        del trainer.tokenizer.batch_decode
