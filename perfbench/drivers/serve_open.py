"""One-spectrum records offered open-loop to the engine's record path.

The engine is built as the serve CLI builds it: a collator of the recipe's
preprocessors (a patch preprocessor fitted on seeded spectra, and the
fixed-vocabulary stand-ins for the formula and SMILES tokenizers), padding
to ``batch`` rows, ``max_wait_ms`` of dynamic batching, K ``beams``; its
constructor decodes a warm batch, which captures the decode's graphs; set-up
then offers the stream's first second again and again for ``warm_s``
(``common.warm_up``). A generator thread submits each record at its due
time (Poisson arrivals at ``rate_per_s``). Each request is timed from when
it was due until its batch's detokenising ended, after which the worker
sets the results (the stand-in tokenizer stamps the end of every call and
the size of its batch; batches are taken first in, first out). A request
that fails, or has no result ``drain_s`` after the window, counts as
failed. A traced run then offers ``trace_seconds`` more of the same stream
under the profiler. The check: the beams of ``check_requests`` answered
requests, drawn from the seed, their SMILES turned back into ids, against
the reference (``common.reference_checks``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

import numpy as np

from ..harness import common
from ..harness.spans import Spans
from ..harness.trace import Stretch
from ..reference.preprocess import standardized_patches
from ..traffic import inputs
from ..traffic.tokenizer import BOS_ID, EOS_ID, PAD_ID, formula_tokenizer, smiles_tokenizer


class _Spanned:
    """The collator, with a span around each call."""

    def __init__(self, inner, spans: Spans):
        self._inner = inner
        self._call = spans.wrap("collate", inner.__call__)

    def __call__(self, columns):
        return self._call(columns)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _offer(engine, records: List[Dict[str, Any]], due: np.ndarray, t0: float):
    """Submit ``records[i]`` at ``t0 + due[i]`` from a thread of its own;
    returns the thread, the pendings and each submit's lateness (s)."""
    pendings: List[Any] = [None] * len(due)
    late: List[float] = []

    def generate():
        for i, d in enumerate(due):
            wait = t0 + d - common.now()
            if wait > 0:
                time.sleep(wait)
            late.append(common.now() - (t0 + d))
            pendings[i] = engine.submit(records[i % len(records)])

    thread = threading.Thread(target=generate, daemon=True)
    thread.start()
    return thread, pendings, late


def _latencies(pendings, due, t0, stamps, first_stamp, deadline) -> np.ndarray:
    """Seconds from due to result per request, matching requests to batches
    in arrival order; a request that failed or was not done by ``deadline``
    gets the time from due to the deadline (it missed any limit), and is
    counted in ``failed``."""
    for p in pendings:
        p.event.wait(timeout=max(0.0, deadline - common.now()))
    ends, sizes = zip(*stamps[first_stamp:]) if len(stamps) > first_stamp else ((), ())
    owner = np.repeat(np.arange(len(sizes)), sizes)
    out = deadline - (t0 + np.asarray(due, dtype=np.float64))
    answered = np.zeros(len(pendings), bool)
    for i, p in enumerate(pendings):
        if p.event.is_set() and p.error is None and i < len(owner):
            out[i] = ends[owner[i]] - (t0 + due[i])
            answered[i] = True
    return out, answered


def run(ctx, log: Callable[[str], None]) -> Dict[str, Any]:
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator
    from multimodalanalytical_tpu_torch.data.preprocessing import PatchPreprocessor

    from ..harness import model as model_maker

    config, traffic = ctx.config, ctx.traffic
    data = config["data"]
    text = next(m for m, s in data.items() if s["type"] == "text" and not s["target"])
    patches = next(m for m, s in data.items() if s["type"] == "1D_patches")
    target = next(m for m, s in data.items() if s["target"])
    beams, max_length = traffic["beams"], config["model"]["max_target_length"]
    model, weights = model_maker.build(config, ctx.seed, ctx.device)
    weights = common.host_weights(weights)
    formula = formula_tokenizer(data[text]["vocab_size"])
    smiles = smiles_tokenizer(data[target]["vocab_size"])
    spans = Spans(enabled=False)
    stamps: List[tuple] = []
    detokenise = smiles.batch_decode

    def stamped(ids, skip_special_tokens=True):
        out = detokenise(ids, skip_special_tokens)
        stamps.append((common.now(), len(ids) // beams))
        return out

    smiles.batch_decode = spans.wrap("detokenise", stamped)
    patch = data[patches]["preprocessor_arguments"]["patch_size"]
    fit = inputs.fit_spectra(config, traffic, ctx.seed)
    prep = PatchPreprocessor(patch_size=patch)
    prep.fit(list(fit))
    collator = MultiModalCollator({text: formula, patches: prep, target: smiles}, data,
                                  max_source_length=dict(config["lengths"]),
                                  max_target_length=max_length,
                                  pad_to_batch_size=traffic["batch"])
    engine = InferenceEngine(model, n_beams=beams, batch_size=traffic["batch"],
                             collator=_Spanned(collator, spans), tokenizer=smiles,
                             max_wait_ms=traffic["max_wait_ms"])
    decode = engine.decode_batch

    def decode_batch(encoder_inputs, encoder_mask):
        seqs, scores = decode(encoder_inputs, encoder_mask)
        if ctx.fault == "token_altered":
            seqs = seqs.copy()
            seqs[:, :, 5] = (seqs[:, :, 5] + 1) % engine.model.config.vocab_size
        elif ctx.fault == "half_batch":
            # the second half of the batch's requests get other rows' answers
            # (a lone request gets a padding row's)
            real = int((np.asarray(encoder_mask).sum(axis=1) > 0).sum())
            rows = np.arange(real // 2, real)
            seqs, scores = seqs.copy(), scores.copy()
            source = rows - real // 2 if real > 1 else rows + 1
            seqs[rows], scores[rows] = seqs[source], scores[source]
        return seqs, scores

    engine.decode_batch = spans.wrap("decode_batch", decode_batch)
    due = inputs.arrivals(traffic, ctx.seconds, ctx.seed)
    records = inputs.serve_records(config, traffic, len(due), ctx.seed, formula)
    engine.start()

    def warm_stream(i: int) -> None:
        """One second of the stream, offered and answered."""
        more = due[due < 1.0]
        t1 = common.now()
        thread, extra, _ = _offer(engine, records, more, t1)
        thread.join()
        _latencies(extra, more, t1, stamps, len(stamps), t1 + 1.0 + traffic["drain_s"])

    warm = common.warm_up(traffic, warm_stream)
    setup_s = common.now() - ctx.t_start
    log(f"set-up {setup_s:.3f} s: {len(due)} requests due in {ctx.seconds} s at "
        f"{traffic['rate_per_s']} /s; warm decode captured in "
        f"{engine.warm_stats.get('capture_s', 0.0):.3f} s; {warm}")

    first = len(stamps)
    t0 = common.now()
    thread, pendings, late = _offer(engine, records, due, t0)
    thread.join()
    latencies, answered = _latencies(pendings, due, t0, stamps, first,
                                     t0 + ctx.seconds + traffic["drain_s"])
    window_s = common.now() - t0
    summary = None
    if ctx.trace:
        spans.enabled = True
        first = len(stamps)
        more = due[due < traffic["trace_seconds"]]
        with Stretch(spans) as stretch:
            t1 = common.now()
            thread, extra, _ = _offer(engine, records, more, t1)
            thread.join()
            _latencies(extra, more, t1, stamps, first, t1 + traffic["trace_seconds"]
                       + traffic["drain_s"])
        summary = stretch.summary()
    engine.close()
    peak = common.memory_peak(ctx.device)
    del engine, model
    common.free(ctx.device)

    done = [i for i in range(len(pendings)) if answered[i]]
    picked = [done[i] for i in common.sample(ctx.seed, len(done), traffic["check_requests"])]
    ids = formula([records[i][text] for i in picked], max_length=config["lengths"][text])
    seqs = np.full((len(picked), beams, max_length), PAD_ID, np.int64)
    for row, i in enumerate(picked):
        for k, answer in enumerate(pendings[i].result["smiles"]):
            tokens = [BOS_ID] + smiles.ids_of_decoded(answer) + [EOS_ID]
            seqs[row, k, :len(tokens)] = tokens
    case = {"inputs": {text: ids["input_ids"],
                       patches: np.stack([standardized_patches(records[i][patches], fit, patch)
                                          for i in picked])},
            "mask": np.concatenate([ids["attention_mask"],
                                    np.ones((len(picked), config["lengths"][patches]),
                                            np.int32)], axis=1),
            "seqs": seqs,
            "scores": np.asarray([pendings[i].result["scores"] for i in picked], np.float32)}
    found = common.reference_checks(config, weights, ctx.device, [case], EOS_ID, True,
                                    ctx.control)
    late = np.asarray(late)
    log(f"window {window_s:.4f} s: {len(due)} requests, {len(done)} answered; generator "
        f"lateness p50 {np.median(late):.6f} s, p99 {np.percentile(late, 99):.6f} s, "
        f"max {late.max():.6f} s; batches {len(stamps)}")
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": len(due),
        "failed": len(due) - len(done), "latencies": latencies, "due": due, "trace": summary,
        "memory_peak_bytes": peak, "config": config, "traffic": traffic,
        **common.compared(found, traffic["limits"]),
    }
