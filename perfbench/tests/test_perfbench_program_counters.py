"""The readers of the beam search's own device times, on synthetic records
and on records a CPU run of each decode cell makes: each new reader reads
what the program reports and None where it reports nothing (the program
before it timed its decodes, or the CPU), and every other reader reads the
same with the new keys as without them."""

import copy
import json
import time

import pytest

from perfbench.harness import cell
from perfbench.tests.helpers import TINY_MODEL

NEW = ("decode_prologue_ms", "decode_step_ms")
DECODE_CELLS = ("ir_patches.decode", "multimodal.decode")


def _search(replays, prologue_ms=None, steps_ms=None):
    stats = {"steps": replays - 3, "replays": replays, "dispatch_s": 1e-5 * replays,
             "capture_s": 0.0, "graph": True}
    if prologue_ms is not None:
        stats.update(prologue_ms=prologue_ms, steps_ms=steps_ms)
    return stats


def test_readers_on_a_synthetic_record():
    record = {"searches": [_search(120, 0.5, 150.0), _search(128, 1.5, 170.0)]}
    assert cell.reader("decode_prologue_ms").read(record) == pytest.approx(1.0)
    assert cell.reader("decode_step_ms").read(record) == pytest.approx(320.0 / 248)


@pytest.mark.parametrize("record", [{}, {"searches": []},
                                    {"searches": [_search(120), _search(128)]}],
                         ids=["no_searches", "empty", "untimed"])
def test_readers_give_none_without_device_times(record):
    for name in NEW:
        assert cell.reader(name).read(record) is None


def _driver_record(workload):
    """What the cell's driver hands its readers, from a CPU run at a tiny size."""
    driver = cell.load_module("drivers", cell.load_json("workloads", workload)["driver"])
    config = cell.load_json("configs", cell.load_json("workloads", workload)["config"])
    config["model"].update(TINY_MODEL)
    traffic = dict(cell.load_json("workloads", workload)["traffic"], batch=4, pool=2, warm_s=0)
    ctx = cell.Context(config, traffic, 2 ** 31 + 41, 0.5, False, "cpu", time.perf_counter())
    return driver.run(ctx, lambda s: None)


@pytest.mark.parametrize("workload", DECODE_CELLS)
def test_other_readers_read_the_same_with_the_new_keys(workload):
    record = _driver_record(workload)
    assert record["searches"] and all("prologue_ms" not in s for s in record["searches"])
    timed = copy.deepcopy(record)
    for key in ("searches", "traced_searches"):
        for s in timed[key]:
            s.update(prologue_ms=0.7, steps_ms=0.01 * s["replays"])
    with open(cell.REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    names = {m["name"] for m in bench["per_layer"] + bench["end_to_end"]
             if workload in m.get("workloads", [workload])} - set(NEW)
    for name in sorted(names):
        reader = cell.reader(name)
        assert reader.read(timed) == reader.read(record), name
    assert cell.reader("decode_prologue_ms").read(timed) == pytest.approx(0.7)
    assert cell.reader("decode_step_ms").read(timed) == pytest.approx(0.01)
    for name in NEW:
        assert cell.reader(name).read(record) is None
