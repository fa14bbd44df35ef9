"""Each fault a cell can have, planted underneath the timed path of a whole
run on the CPU (the harness's look for a chip skipped), at a tiny size.

The cells' limits hold at the cells' own sizes, where the card test
(``test_perfbench_card.py::test_fault_not_correct``) sees each fault make
``correct`` false; a tiny model's readings are smaller throughout, so here
each fault must raise one of the compared numbers to at least
``FAULT_FACTOR`` times what the sound program reads on the same seed and
size, and the sound program must come out correct where its readings at
this size are the cell's."""

import json
import time

import pytest

from perfbench.harness import cell
from perfbench.tests.helpers import TINY_MODEL

FAULT_FACTOR = 5.0
TRAFFIC = {
    "ir_patches.decode": {"batch": 4, "pool": 2, "warm_s": 0},
    "multimodal.decode": {"batch": 4, "pool": 2, "warm_s": 0},
    "ir_patches.train": {"batch": 16, "pool": 3, "target_tokens": {"low": 5, "high": 16}},
    "ir_patches.serve_open": {"batch": 8, "rate_per_s": 20, "check_requests": 8,
                              "spectra_pool": 8, "warm_s": 0},
}
FAULTS = [(c, f) for c in ("ir_patches.decode", "multimodal.decode", "ir_patches.serve_open")
          for f in ("token_altered", "half_batch", "topk_not_best")]
FAULTS += [("ir_patches.train", "state_unchanged"), ("ir_patches.train", "half_batch")]
SEED = 2 ** 31 + 5


def _run(workload, fault):
    overrides = {"model": dict(TINY_MODEL), "traffic": json.loads(json.dumps(TRAFFIC[workload]))}
    seconds = 2.0 if workload.endswith("serve_open") else 0.5
    result, _ = cell.run(workload, SEED, seconds, False, time.perf_counter(),
                         require_device=False, fault=fault, overrides=overrides,
                         log=lambda s: None)
    return result


@pytest.mark.parametrize("workload,fault", FAULTS, ids=lambda x: x)
def test_fault_raises_a_compared_number(workload, fault):
    sound = _run(workload, None)["checks"]
    faulty = _run(workload, fault)["checks"]
    ratios = {n: faulty[n]["value"] / max(sound[n]["value"], 1e-9) for n in sound}
    assert max(ratios.values()) >= FAULT_FACTOR, (sound, faulty)


# The training cell's limits sit closer to its sound readings than a tiny
# model's norms allow (fewer elements a parameter: noisier norms); its sound
# runs are checked at the cell's size on the card.
@pytest.mark.parametrize("workload", [w for w in TRAFFIC if not w.endswith("train")])
def test_sound_program_is_correct(workload):
    result = _run(workload, None)
    assert result["correct"] is True, result["checks"]
