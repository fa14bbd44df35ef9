"""The RLE IR cell on the CPU: flash #5's count against a hand count; its
roofline's reader on synthetic records; and ``rle_ir.decode`` run whole at
a tiny model (its own 4090-token width, a batch of 4), where the sound
program is correct and each fault planted underneath the timed path
raises a compared number to at least ``FAULT_FACTOR`` times the sound
program's reading on the same seed (the card test
``test_perfbench_card.py`` holds the faults to the limits at the cell's
own size)."""

import time

import numpy as np
import pytest

from perfbench.counts import flash, peaks
from perfbench.harness import cell
from perfbench.tests.helpers import TINY_MODEL

CELL = "rle_ir.decode"
FAULT_FACTOR = 5.0
SEED = 2 ** 31 + 5
CONFIG = {"model": {"d_model": 128, "encoder_attention_heads": 2}}
KERNEL = "void mmt::wg::flash_fwd_wgmma_kernel<64>(CUtensorMap_st, ...)"


def test_forward_count():
    # Ls 4 queries against 5 valid keys, 2 heads of 64: Q.K and P.V, 2 x 64
    # operations a pair each; the valid keys' bf16 K and V rows.
    flops, nbytes = flash.forward(4, 5, 2, 64)
    assert flops == 2 * (2 * 64) * 2 * 4 * 5
    assert nbytes == 2 * 5 * 2 * 64 * 2


def test_prologue_bound():
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.int32)
    bound = peaks.bound_s(*flash.forward(4, 5, 2, 64))
    assert flash.prologue_bound_s(CONFIG, mask, 3) == pytest.approx(3 * bound)


def _record(counted, launches, seconds=1e-3):
    masks = [np.ones((2, 4), np.int32), np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.int32)]
    traced = [{"replays": 10} if n is None else {"replays": 10, "prologue_flash_launches": n}
              for n in counted]
    ops = {KERNEL: (seconds, launches), "cross_stats_kernel": (5e-3, 60)}
    return {"config": CONFIG, "trace": {"ops": ops}, "traced_searches": traced,
            "pool_masks": masks, "traced_pool_index": [1, 0]}


def test_roofline_reads_the_counted_launches():
    want = 100.0 * (2 * peaks.bound_s(*flash.forward(4, 5, 2, 64))
                    + 2 * peaks.bound_s(*flash.forward(4, 8, 2, 64))) / 1e-3
    read = cell.reader("flash_prologue_roofline").read
    assert read(_record([2, 2], 4)) == pytest.approx(want)


@pytest.mark.parametrize("counted,launches", [([None, None], 4), ([2, 2], 3), ([0, 0], 0),
                                              ([2, 2], 0)],
                         ids=["no_counter", "launches_disagree", "plain_route", "no_kernel"])
def test_roofline_none(counted, launches):
    assert cell.reader("flash_prologue_roofline").read(_record(counted, launches)) is None


def test_roofline_none_untraced():
    read = cell.reader("flash_prologue_roofline").read
    assert read({"trace": None, "traced_searches": []}) is None


def _run(fault):
    overrides = {"model": dict(TINY_MODEL), "traffic": {"batch": 4, "pool": 2, "warm_s": 0}}
    result, _ = cell.run(CELL, SEED, 0.5, False, time.perf_counter(), require_device=False,
                         fault=fault, overrides=overrides, log=lambda s: None)
    return result


@pytest.fixture(scope="module")
def sound():
    return _run(None)


def test_sound_program_is_correct(sound):
    assert sound["correct"] is True, sound["checks"]


@pytest.mark.parametrize("fault", ["token_altered", "half_batch", "topk_not_best"])
def test_fault_raises_a_compared_number(sound, fault):
    faulty = _run(fault)["checks"]
    ratios = {n: faulty[n]["value"] / max(c["value"], 1e-9) for n, c in sound["checks"].items()}
    assert max(ratios.values()) >= FAULT_FACTOR, (sound["checks"], faulty)
