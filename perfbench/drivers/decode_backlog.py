"""A backlog of collated batches, decoded closed-loop through the engine.

``InferenceEngine.decode_batch`` (built without a collator) takes one batch
at a time from a pool of ``pool`` seeded batches, cycled; each returns its
K ranked sequences and scores as host arrays before the next starts. Set-up
decodes the pool's first batch, which captures the decode's graphs, then
goes on decoding for ``warm_s`` (``common.warm_up``). The
window counts the spectra of every batch that started in it, over the time
until the last one returned. A traced run then profiles ``trace_units``
more batches. The check: the beams of ``check_units`` batches of the
window, drawn from the seed, against the reference
(``common.reference_checks``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from ..harness import common
from ..harness.spans import Spans
from ..harness.trace import Stretch
from ..traffic import inputs
from ..traffic.tokenizer import EOS_ID


def run(ctx, log: Callable[[str], None]) -> Dict[str, Any]:
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.generation.beam_search import kv_cache_quantized

    from ..harness import model as model_maker

    traffic, config = ctx.traffic, ctx.config
    model, weights = model_maker.build(config, ctx.seed, ctx.device)
    weights = common.host_weights(weights)
    engine = InferenceEngine(model, n_beams=traffic["beams"], batch_size=traffic["batch"])
    pool = inputs.encoder_pool(config, traffic, ctx.seed)
    spans = Spans(enabled=ctx.trace)
    engine.decode_batch = spans.wrap("decode_batch", engine.decode_batch)
    engine.decoder.search = spans.wrap("search", engine.decoder.search)

    def unit(i: int):
        seqs, scores = engine.decode_batch(*pool[i % len(pool)])
        if ctx.fault == "token_altered":
            seqs = seqs.copy()
            seqs[:, :, 5] = (seqs[:, :, 5] + 1) % engine.model.config.vocab_size
        elif ctx.fault == "half_batch":
            half = len(seqs) // 2
            seqs, scores = seqs.copy(), scores.copy()
            seqs[half:], scores[half:] = seqs[:half], scores[:half]
        return seqs, scores, dict(engine.last_stats)

    unit(0)
    capture_s = engine.last_stats.get("capture_s", 0.0)
    warm = common.warm_up(traffic, lambda i: unit(i + 1))
    common.sync(ctx.device)
    setup_s = common.now() - ctx.t_start
    log(f"set-up {setup_s:.3f} s: decode graphs captured in {capture_s:.3f} s; {warm}")

    outputs, stats, ends = [], [], []
    t0 = common.now()
    deadline = t0 + ctx.seconds
    while True:
        seqs, scores, st = unit(len(outputs))
        outputs.append((seqs, scores))
        stats.append(st)
        ends.append(common.now())
        if ends[-1] >= deadline:
            break
    window_s = ends[-1] - t0

    summary, traced = None, []
    if ctx.trace:
        spans.enabled = True
        with Stretch(spans) as stretch:
            for j in range(traffic["trace_units"]):
                traced.append(unit(len(outputs) + j)[2])
        summary = stretch.summary()
    peak = common.memory_peak(ctx.device)
    cfg = engine.model.config
    int8 = kv_cache_quantized(cfg, traffic["beams"], cfg.max_target_length)
    del engine, model
    common.free(ctx.device)

    picked = common.sample(ctx.seed, len(outputs), traffic["check_units"])
    cases = [{"inputs": pool[i % len(pool)][0], "mask": pool[i % len(pool)][1],
              "seqs": outputs[i][0], "scores": outputs[i][1]} for i in picked]
    found = common.reference_checks(config, weights, ctx.device, cases, EOS_ID, int8,
                                    ctx.control)
    batch = traffic["batch"]
    each = np.diff([t0] + ends)
    log(f"window {window_s:.4f} s: {len(outputs)} batches of {batch}; s a batch: min "
        f"{each.min():.5f}, median {np.median(each):.5f}, max {each.max():.5f}; first half "
        f"{np.median(each[:len(each) // 2]):.5f}, second {np.median(each[len(each) // 2:]):.5f}; "
        f"checked batches {picked}; every 10th: {[round(float(x), 4) for x in each[::10]]}")
    units = len(outputs)
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": units, "failed": 0,
        "spectra": units * batch, "searches": stats, "traced_searches": traced,
        "pool_masks": [p[1] for p in pool],
        "unit_pool_index": [i % len(pool) for i in range(units)],
        "traced_pool_index": [(units + j) % len(pool) for j in range(len(traced))],
        "config": config, "traffic": traffic, "trace": summary, "memory_peak_bytes": peak,
        **common.compared(found, traffic["limits"]),
    }
