"""Batch inference: spectra in, ranked SMILES out (counterpart of ``cli/serve.py``).

:class:`InferenceEngine` owns a model and its beam-search decode.
:meth:`InferenceEngine.decode_batch` is the decode core: collated encoder
inputs in, (sequences, scores) out; it needs no collator. The record path
(HTTP JSON records -> collation -> decode -> tokenizer) adds dynamic
batching: requests arriving within ``max_wait_ms`` are collated into one
batch padded to ``batch_size`` and decoded together. Collation uses the JAX
package's framework-free data layer (``data.collator``, ``data.data_utils``),
imported only where the record path needs it.

Each request is stamped when it is submitted and when its batch's
collating starts; each batch of the record path leaves one entry in the
bounded ``batch_log`` (its rows, the seconds it spent collating, decoding,
detokenising and delivering, and when its group opened and closed). With
the recorder of ``tracing`` on, the worker's waits and each batch's stages
are spans carrying the batch's id: ``engine.queue_get`` (waiting for a
first request), ``engine.fill`` (collecting up to ``max_wait_ms``),
``engine.collate``, ``engine.decode`` with ``engine.copy_out`` inside,
``engine.detokenise`` and ``engine.deliver``; the beam loop's spans nest in
``engine.decode``.

API (as in the JAX package): ``GET /healthz`` and ``POST /predict`` with
body ``{"records": [{<column>: <value>, ...}, ...]}``, answered with
``{"results": [{"smiles": [...], "scores": [...]}, ...]}``.

The entry point builds the engine from a config (a checkpoint of this
package or an ``.npz`` of a JAX param tree, plus the preprocessor artifact,
which carries the collator's fitted lengths)::

    python -m multimodalanalytical_tpu_torch.cli.serve \
        preprocessor_path=runs/train/preprocessor.json model=custom_model \
        model.model_checkpoint_path=runs/train/checkpoints/best serve.port=8000

It serves from the CUDA device unless the override ``+device=cpu`` asks
for the CPU.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..generation.beam_search import BeamDecoder, read_device_times
from ..models.seq2seq import Seq2SeqModel
from ..ops._cuda import to_device

logger = logging.getLogger(__name__)
# Entries kept in ``InferenceEngine.batch_log``: the newest batches.
BATCH_LOG_SIZE = 4096


def collator_from_artifact(artifact: Path, batch_size: int):
    """(collator, tokenizer) from a preprocessor artifact that embeds the
    collator's fitted lengths."""
    from ..data.collator import MultiModalCollator
    from ..data.data_utils import (
        load_collator_lengths,
        load_preprocessors_artifact,
    )

    data_config, preprocessors = load_preprocessors_artifact(Path(artifact))
    lengths = load_collator_lengths(Path(artifact))
    if lengths is None:
        raise ValueError(f"{artifact} has no collator_lengths; re-run training to refresh it")
    collator = MultiModalCollator(
        preprocessors=preprocessors, data_config=data_config,
        max_source_length=lengths["max_source_length"],
        max_target_length=lengths["max_target_length"],
        pad_to_batch_size=batch_size,
    )
    return collator, preprocessors[collator.target_modality]


class _Pending:
    """One request's slot: raw record in, decoded beams (or error) out;
    ``submitted`` and ``started`` (its batch's collating began) on
    ``time.perf_counter()``."""

    __slots__ = ("record", "event", "result", "error", "submitted", "started")

    def __init__(self, record: Dict[str, Any]):
        self.record = record
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.submitted = time.perf_counter()
        self.started: Optional[float] = None


class InferenceEngine:
    """Owns the model, the decode, and (after :meth:`start`) the batching loop."""

    def __init__(self, model: Seq2SeqModel, *, n_beams: int = 10, batch_size: int,
                 collator=None, tokenizer=None, max_wait_ms: float = 20.0):
        # bf16 models keep their decode weights pre-cast for every request
        # (encoding with them gives the same results: Dense casts anyway).
        # On a CUDA device the decoder captures each request shape's decode
        # steps once, for the engine's life.
        self.decoder = BeamDecoder(model.eval())
        self.model = self.decoder.dmodel
        self.device = next(model.parameters()).device
        self.n_beams = n_beams
        self.batch_size = batch_size
        self.max_length = model.config.max_target_length
        self.collator = collator
        self.tokenizer = tokenizer
        self.max_wait_s = max_wait_ms / 1e3
        self.last_stats: Dict[str, Any] = {}
        self.batch_log: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=BATCH_LOG_SIZE)
        self._batch_ids = itertools.count()
        self._group_id: Optional[int] = None     # the record path's batch being decoded
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        # As the JAX engine's __init__: one decode of a warm batch before any
        # request can be taken, so that the first request finds its decode
        # (on a CUDA device, its captured graphs) ready. An engine without a
        # collator has no request shape to warm.
        self.warm_stats: Dict[str, Any] = {}
        if collator is not None:
            warm = self._warm_batch()
            self.decode_batch(warm["encoder_inputs"], warm["encoder_mask"])
            self.warm_stats = self.last_stats

    # ---------------------------------------------------------- decode core
    def decode_batch(self, encoder_inputs: Dict[str, Any],
                     encoder_mask) -> Tuple[np.ndarray, np.ndarray]:
        """Beam-decode one collated batch (a modality's input may be a dict
        payload: XVal values, peak indices); returns (sequences (B, K, L) int64,
        scores (B, K) fp32) as numpy. ``last_stats`` records the beam
        search's ``stats``, on a CUDA device with its ``prologue_ms`` and
        ``steps_ms`` (``read_device_times``, once the copy-out has waited
        for the device)."""
        batch_id = self._group_id if self._group_id is not None else next(self._batch_ids)
        with tracing.span("engine.decode", batch_id):
            inputs = to_device(encoder_inputs, self.device)
            mask = torch.as_tensor(encoder_mask, device=self.device)
            stats: Dict[str, Any] = {}
            seqs, scores = self.decoder.search(inputs, mask, self.n_beams,
                                               max_length=self.max_length, stats=stats)
            with tracing.span("engine.copy_out"):
                seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
        read_device_times(stats)
        self.last_stats = stats
        return seqs, scores

    # --------------------------------------------------------- record path
    @property
    def input_columns(self) -> List[str]:
        return list(self.collator.input_modalities)

    def _collate(self, records: List[Dict[str, Any]]) -> Dict[str, Any]:
        target = self.collator.target_modality
        columns = {col: [r.get(col, "" if col == target else None) for r in records]
                   for col in self.input_columns + [target]}
        return self.collator(columns)

    def _warm_batch(self) -> Dict[str, Any]:
        """A one-record batch with the shapes a real request has, collated
        and padded to ``batch_size`` as :meth:`_batch_loop` pads a real one
        (the JAX engine's ``_warm_batch``): text gets a minimal token,
        patches zero spectra at the fitted length (max_source_length x
        patch_size), every other modality None (a fully masked segment of
        the real shape), and the target is empty."""
        record: Dict[str, Any] = {}
        for modality in self.input_columns:
            mtype = self.collator.data_config[modality]["type"]
            if mtype == "text":
                record[modality] = "C"
            elif mtype == "1D_patches":
                patch_size = self.collator.preprocessors[modality].patch_size
                record[modality] = [0.0] * (self.collator.max_source_length[modality]
                                            * patch_size)
            else:
                record[modality] = None
        record[self.collator.target_modality] = ""
        return self._collate([record])

    def validate_record(self, record: Dict[str, Any]) -> None:
        """Collate the record alone (no decode) so a malformed record is
        rejected at intake instead of failing a whole batch. Raises."""
        self._collate([record])

    def submit(self, record: Dict[str, Any]) -> _Pending:
        pending = _Pending(record)
        self._queue.put(pending)
        return pending

    def start(self) -> None:
        """Start the batching worker (the record path needs a collator)."""
        if self.collator is None or self.tokenizer is None:
            raise ValueError("the record path needs a collator and a tokenizer")
        self._worker = threading.Thread(target=self._batch_loop, daemon=True)
        self._worker.start()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the batching worker after the requests already queued."""
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout)
            self._worker = None

    def _batch_loop(self) -> None:
        while True:
            batch_id = next(self._batch_ids)
            with tracing.span("engine.queue_get", batch_id):
                first = self._queue.get()
            if first is None:
                return
            group = [first]
            opened = time.perf_counter()
            deadline = opened + self.max_wait_s
            stop = False
            with tracing.span("engine.fill", batch_id):
                while len(group) < self.batch_size:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        item = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if item is None:
                        stop = True
                        break
                    group.append(item)
            entry = {"id": batch_id, "opened": opened, "closed": time.perf_counter()}
            try:
                self._run_group(group, entry)
            except Exception:  # noqa: BLE001 - isolated per request below
                logger.exception("Batch failed; isolating per record")
                for pending in group:
                    try:
                        self._run_group([pending], dict(entry))
                    except Exception as exc:  # noqa: BLE001
                        pending.error = str(exc)
                        pending.event.set()
            if stop:
                return

    def _run_group(self, group: List[_Pending], entry: Dict[str, Any]) -> None:
        """Collate, decode, detokenise and deliver ``group``; ``entry`` (the
        batch's id and when its group opened and closed) goes to
        ``batch_log`` with its rows and each stage's seconds."""
        batch_id = entry["id"]
        start = time.perf_counter()
        for pending in group:
            pending.started = start
        with tracing.span("engine.collate", batch_id):
            batch = self._collate([p.record for p in group])
        collated = time.perf_counter()
        self._group_id = batch_id
        try:
            seqs, scores = self.decode_batch(batch["encoder_inputs"], batch["encoder_mask"])
        finally:
            self._group_id = None
        decoded_at = time.perf_counter()
        seqs, scores = seqs[: len(group)], scores[: len(group)]
        with tracing.span("engine.detokenise", batch_id):
            decoded = self.tokenizer.batch_decode(seqs.reshape(-1, seqs.shape[-1]),
                                                  skip_special_tokens=True)
        detokenised = time.perf_counter()
        with tracing.span("engine.deliver", batch_id):
            for i, pending in enumerate(group):
                pending.result = {
                    "smiles": decoded[i * self.n_beams: (i + 1) * self.n_beams],
                    "scores": [float(s) for s in scores[i]],
                }
                pending.event.set()
        entry.update(rows=len(group), collate_s=collated - start, decode_s=decoded_at - collated,
                     detokenise_s=detokenised - decoded_at,
                     deliver_s=time.perf_counter() - detokenised)
        self.batch_log.append(entry)


def make_handler(engine: InferenceEngine, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_name,
                                 "batch_size": engine.batch_size, "n_beams": engine.n_beams})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 - http.server API
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                records = json.loads(self.rfile.read(length))["records"]
                if not isinstance(records, list) or not records:
                    raise ValueError("records must be a non-empty list")
                if len(records) > engine.batch_size:
                    raise ValueError(f"at most {engine.batch_size} records per request")
                for i, record in enumerate(records):
                    try:
                        engine.validate_record(record)
                    except Exception as exc:  # noqa: BLE001 - client error
                        raise ValueError(f"record {i} invalid: {exc}") from exc
            except Exception as exc:  # noqa: BLE001 - client error
                self._send(400, {"error": str(exc)})
                return
            pendings = [engine.submit(r) for r in records]
            results = []
            timeout_s = max(60.0, engine.max_wait_s * 10)
            for pending in pendings:
                if not pending.event.wait(timeout=timeout_s):
                    logger.error("Inference timed out after %.0fs", timeout_s)
                    self._send(503, {"error": "inference timed out"})
                    return
                if pending.error is not None:
                    logger.error("Inference failed: %s", pending.error)
                    self._send(500, {"error": "inference failed"})
                    return
                results.append(pending.result)
            self._send(200, {"results": results})

    return Handler


class _Server(ThreadingHTTPServer):
    request_queue_size = 512
    daemon_threads = True


def make_server(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 8000,
                model_name: str = "CustomModel") -> ThreadingHTTPServer:
    """Start the engine's batching worker and bind the HTTP server (without
    entering ``serve_forever``)."""
    engine.start()
    server = _Server((host, port), make_handler(engine, model_name))
    server.engine = engine
    return server


def engine_from_config(config: Dict[str, Any]) -> InferenceEngine:
    """The engine of a serve config: the model of ``config["model"]`` with
    the checkpoint ``model.model_checkpoint_path``, and the collator and
    tokenizer of the artifact ``preprocessor_path``."""
    from ..training.checkpoint import load_params
    from .common import build_model, config_device, seed_everything

    device = config_device(config)
    model_config: Dict[str, Any] = dict(config["model"])
    if not model_config.get("model_checkpoint_path"):
        raise ValueError("Please supply model_checkpoint_path with model.model_checkpoint_path=...")
    if not config.get("preprocessor_path"):
        raise ValueError("Please supply preprocessor_path=...")
    batch_size = int((config.get("serve") or {}).get("batch_size") or model_config["batch_size"])
    collator, tokenizer = collator_from_artifact(Path(config["preprocessor_path"]), batch_size)
    model, _ = build_model(model_config, collator.data_config, collator.target_modality,
                           tokenizer, device, seed_everything())
    load_params(model_config["model_checkpoint_path"], model)
    return InferenceEngine(model, n_beams=int(model_config.get("n_beams", 10)),
                           batch_size=batch_size, collator=collator, tokenizer=tokenizer,
                           max_wait_ms=float((config.get("serve") or {}).get("max_wait_ms", 20)))


def build_server(config: Dict[str, Any]) -> ThreadingHTTPServer:
    """The engine and HTTP server of a serve config, without entering
    ``serve_forever`` (tests drive this directly)."""
    serve_cfg = config.get("serve") or {}
    return make_server(engine_from_config(config), serve_cfg.get("host", "127.0.0.1"),
                       int(serve_cfg.get("port", 8000)),
                       config["model"].get("model_type", "CustomModel"))


def run(config: Dict[str, Any]) -> None:
    from .common import setup_logging

    work_dir = Path(config.get("working_dir", ".")) / config.get("job_name", "serve")
    work_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(work_dir / "serve.log")
    server = build_server(config)
    host, port = server.server_address[:2]
    logger.info("Serving on http://%s:%s (POST /predict)", host, port)
    try:
        server.serve_forever()
    finally:
        server.engine.close()


def main(argv: List[str] | None = None) -> None:
    from .common import compose

    run(compose("config_serve", sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
