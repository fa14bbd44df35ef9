"""Batch inference: spectra in, ranked SMILES out (counterpart of ``cli/serve.py``).

:class:`InferenceEngine` owns a model and its beam-search decode.
:meth:`InferenceEngine.decode_batch` is the decode core: collated encoder
inputs in, (sequences, scores) out; it needs no collator. The record path
(HTTP JSON records -> collation -> decode -> tokenizer) adds dynamic
batching: requests arriving within ``max_wait_ms`` are collated into one
batch padded to ``batch_size`` and decoded together. Collation uses the JAX
package's framework-free data layer (``data.collator``, ``data.data_utils``),
imported only where the record path needs it.

API (as in the JAX package): ``GET /healthz`` and ``POST /predict`` with
body ``{"records": [{<column>: <value>, ...}, ...]}``, answered with
``{"results": [{"smiles": [...], "scores": [...]}, ...]}``.

The entry point builds the engine from a config (a checkpoint of this
package or an ``.npz`` of a JAX param tree, plus the preprocessor artifact,
which carries the collator's fitted lengths)::

    python -m multimodalanalytical_tpu_torch.cli.serve \
        preprocessor_path=runs/train/preprocessor.json model=custom_model \
        model.model_checkpoint_path=runs/train/checkpoints/best serve.port=8000
"""

from __future__ import annotations

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

from ..generation.beam_search import beam_search, decode_model
from ..models.seq2seq import Seq2SeqModel

logger = logging.getLogger(__name__)


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
    """One request's slot: raw record in, decoded beams (or error) out."""

    __slots__ = ("record", "event", "result", "error")

    def __init__(self, record: Dict[str, Any]):
        self.record = record
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None


class InferenceEngine:
    """Owns the model, the decode, and (after :meth:`start`) the batching loop."""

    def __init__(self, model: Seq2SeqModel, *, n_beams: int = 10, batch_size: int,
                 collator=None, tokenizer=None, max_wait_ms: float = 20.0):
        # bf16 models keep their decode weights pre-cast for every request
        # (encoding with them gives the same results: Dense casts anyway).
        self.model = decode_model(model.eval())
        self.device = next(model.parameters()).device
        self.n_beams = n_beams
        self.batch_size = batch_size
        self.max_length = model.config.max_target_length
        self.collator = collator
        self.tokenizer = tokenizer
        self.max_wait_s = max_wait_ms / 1e3
        self.last_steps = 0
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None

    # ---------------------------------------------------------- decode core
    def decode_batch(self, encoder_inputs: Dict[str, Any],
                     encoder_mask) -> Tuple[np.ndarray, np.ndarray]:
        """Beam-decode one collated batch; returns (sequences (B, K, L) int64,
        scores (B, K) fp32) as numpy. ``last_steps`` records the steps run."""
        inputs = {m: torch.as_tensor(v, device=self.device) for m, v in encoder_inputs.items()}
        mask = torch.as_tensor(encoder_mask, device=self.device)
        stats: Dict[str, Any] = {}
        seqs, scores = beam_search(self.model, inputs, mask, num_beams=self.n_beams,
                                   max_length=self.max_length, stats=stats)
        self.last_steps = stats["steps"]
        return seqs.cpu().numpy(), scores.cpu().numpy()

    # --------------------------------------------------------- record path
    @property
    def input_columns(self) -> List[str]:
        return list(self.collator.input_modalities)

    def _collate(self, records: List[Dict[str, Any]]) -> Dict[str, Any]:
        target = self.collator.target_modality
        columns = {col: [r.get(col, "" if col == target else None) for r in records]
                   for col in self.input_columns + [target]}
        return self.collator(columns)

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
            first = self._queue.get()
            if first is None:
                return
            group = [first]
            deadline = time.monotonic() + self.max_wait_s
            stop = False
            while len(group) < self.batch_size:
                remaining = deadline - time.monotonic()
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
            try:
                self._run_group(group)
            except Exception:  # noqa: BLE001 - isolated per request below
                logger.exception("Batch failed; isolating per record")
                for pending in group:
                    try:
                        self._run_group([pending])
                    except Exception as exc:  # noqa: BLE001
                        pending.error = str(exc)
                        pending.event.set()
            if stop:
                return

    def _run_group(self, group: List[_Pending]) -> None:
        batch = self._collate([p.record for p in group])
        seqs, scores = self.decode_batch(batch["encoder_inputs"], batch["encoder_mask"])
        seqs, scores = seqs[: len(group)], scores[: len(group)]
        decoded = self.tokenizer.batch_decode(seqs.reshape(-1, seqs.shape[-1]),
                                              skip_special_tokens=True)
        for i, pending in enumerate(group):
            pending.result = {
                "smiles": decoded[i * self.n_beams: (i + 1) * self.n_beams],
                "scores": [float(s) for s in scores[i]],
            }
            pending.event.set()


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
    from ..training.checkpoint import restore_params
    from .common import build_model, default_device, seed_everything

    model_config: Dict[str, Any] = dict(config["model"])
    if not model_config.get("model_checkpoint_path"):
        raise ValueError("Please supply model_checkpoint_path with model.model_checkpoint_path=...")
    if not config.get("preprocessor_path"):
        raise ValueError("Please supply preprocessor_path=...")
    batch_size = int((config.get("serve") or {}).get("batch_size") or model_config["batch_size"])
    collator, tokenizer = collator_from_artifact(Path(config["preprocessor_path"]), batch_size)
    model, _ = build_model(model_config, collator.data_config, collator.target_modality,
                           tokenizer, default_device(), seed_everything())
    model.load_state_dict(restore_params(model_config["model_checkpoint_path"]))
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
