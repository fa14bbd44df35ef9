"""A traced run of one cell with the program's own spans labelling its stretch.

    python3 perfbench/tools/program_spans.py --workload <cell> --seed <n> [--seconds 30]
        [--recorder 0|1] [--stretch N]
    python3 perfbench/tools/program_spans.py --span-cost

Runs the cell as ``perfbench/run.py --trace 1`` does, with the program's
recorder (``multimodalanalytical_tpu_torch.tracing``) on for the traced
stretch only, and the program's spans added to the benchmark's before the
stretch is summarised: each idle gap is labelled by the innermost of
either. The device-side annotations that the spans' ``record_function``
ranges add to the trace are left out of the device's busy time.
``--recorder 0`` runs the same stretch with the recorder off (the
benchmark's spans alone), for the recorder's cost. ``--stretch`` sets the
stretch's length (the traffic's ``trace_units``, ``trace_steps`` or
``trace_seconds``). Prints one JSON object: ``correct``, the per-layer
metrics, ``device`` and ``breakdown`` of the result line; the program's
spans in the stretch by name (count, seconds); and what the engine's and
the trainer's counters give over the window: the 95th percentile of each
answered request's wait from its submit to its batch's collating
(``queue_wait_p95_s``) and the mean host ms a batch spends collating,
detokenising and delivering (``host_ms_per_batch``), or the host ms a
train step spends in ``train_step`` (``train_host_ms_per_step``).

``--span-cost`` prints the host ns a span costs with the recorder off, on,
and on under a running ``torch.profiler``, each over 200,000 spans.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

STRETCH_KEYS = ("trace_units", "trace_steps", "trace_seconds")
OFFER_GAP_S = 0.1      # submits further apart than this belong to different offers


def span_cost(count: int = 200_000) -> dict:
    import torch

    from multimodalanalytical_tpu_torch import tracing

    recorder = tracing.Recorder(capacity=1024)

    def ns_per_span() -> float:
        t0 = time.perf_counter_ns()
        for i in range(count):
            with recorder.span("beam.dispatch", i):
                pass
        return (time.perf_counter_ns() - t0) / count

    out = {"off": ns_per_span()}
    recorder.enabled = True
    out["on"] = ns_per_span()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["on_profiled"] = ns_per_span()
    return out


def window_of(pendings: list) -> list:
    """The largest run of requests submitted within OFFER_GAP_S of each
    other: the window's offer (the warm-up's and the stretch's are shorter)."""
    runs, current = [], []
    for p in pendings:
        if current and p.submitted - current[-1].submitted > OFFER_GAP_S:
            runs.append(current)
            current = []
        current.append(p)
    runs.append(current)
    return max(runs, key=len)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    parser.add_argument("--stretch", type=float)
    parser.add_argument("--span-cost", action="store_true")
    args = parser.parse_args()
    if args.span_cost:
        print(json.dumps({"span_ns": span_cost()}), flush=True)
        return 0
    t_start = time.perf_counter()

    from multimodalanalytical_tpu_torch import tracing
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.training import Trainer
    from perfbench.harness import cell, trace

    by_name: dict = {}

    class ProgramStretch(trace.Stretch):
        def __enter__(self):
            tracing.RECORDER.take()
            tracing.RECORDER.enabled = bool(args.recorder)
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            tracing.RECORDER.enabled = False

        def summary(self):
            for s in tracing.RECORDER.take():
                self.spans.items.append((s.name, s.start_ns, s.end_ns))
                entry = by_name.setdefault(s.name, [0, 0.0])
                entry[0] += 1
                entry[1] += (s.end_ns - s.start_ns) / 1e9
            # Each span's record_function also gives the device timeline an
            # annotation from its first kernel to its last: not device work.
            events = [e for e in self.prof.profiler.kineto_results.events()
                      if not (e.name() in by_name and str(e.device_type()).endswith("CUDA"))]
            prof = self.prof
            self.prof = SimpleNamespace(profiler=SimpleNamespace(
                kineto_results=SimpleNamespace(events=lambda: events)))
            try:
                return super().summary()
            finally:
                self.prof = prof

    trace.Stretch = ProgramStretch
    pendings, engines, fits = [], [], []
    submit, start, fit = InferenceEngine.submit, InferenceEngine.start, Trainer.fit

    def recorded_submit(self, record):
        pendings.append(submit(self, record))
        return pendings[-1]

    def recorded_start(self):
        engines.append(self)
        start(self)

    def recorded_fit(self, *a, **k):
        before = (self.step_stats["host_s"], self.global_step)
        out = fit(self, *a, **k)
        fits.append((self.step_stats["host_s"] - before[0], self.global_step - before[1]))
        return out

    InferenceEngine.submit, InferenceEngine.start = recorded_submit, recorded_start
    Trainer.fit = recorded_fit

    traffic = cell.load_json("workloads", args.workload)["traffic"]
    overrides = {"traffic": {k: args.stretch for k in STRETCH_KEYS
                             if k in traffic and args.stretch is not None}}
    for k in ("trace_units", "trace_steps"):
        if k in overrides["traffic"]:
            overrides["traffic"][k] = int(overrides["traffic"][k])
    result, _ = cell.run(args.workload, args.seed, args.seconds, True, t_start,
                         overrides=overrides)
    out = {"workload": args.workload, "seed": args.seed, "recorder": args.recorder,
           "correct": result["correct"], "metrics": result["metrics"],
           "device": result["device"], "breakdown": result["breakdown"],
           "program_spans": by_name}
    if engines and pendings:
        window = window_of(pendings)
        waits = [p.started - p.submitted for p in window
                 if p.error is None and p.started is not None]
        lo, hi = window[0].submitted, max(p.started for p in window if p.started is not None)
        batches = [e for e in engines[0].batch_log if lo <= e["opened"] <= hi]
        out["engine"] = {
            "requests": len(window), "batches": len(batches),
            "rows_per_batch": float(np.mean([e["rows"] for e in batches])),
            "queue_wait_p50_s": float(np.median(waits)),
            "queue_wait_p95_s": float(np.percentile(waits, 95)),
            "host_ms_per_batch": 1e3 * float(np.mean(
                [e["collate_s"] + e["detokenise_s"] + e["deliver_s"] for e in batches])),
            **{f"{k}_ms_per_batch": 1e3 * float(np.mean([e[f"{k}_s"] for e in batches]))
               for k in ("collate", "decode", "detokenise", "deliver")},
            "fill_ms_per_batch": 1e3 * float(np.mean([e["closed"] - e["opened"]
                                                      for e in batches]))}
    if fits:
        host_s, steps = max(fits, key=lambda f: f[1])
        out["trainer"] = {"steps": steps, "train_host_ms_per_step": 1e3 * host_s / steps}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
