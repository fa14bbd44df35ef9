"""The port's train step against the JAX ``Trainer`` on a long RLE source.

A run-length-encoded IR source (vocabulary 105) at L 2100 >= 2048 with
head_dim 64: the encoder self-attention goes through flash attention in
both packages (the Pallas kernels in interpret mode, the port's CUDA
kernels' plain versions), so these steps run the flash forward and
backward. One and three steps from the same params on the same batches,
fp32, dropout 0, held as ``tests/test_torch_train.py`` holds the patch case.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
pytest.importorskip("jax")

from multimodalanalytical_tpu_torch.ops import flash_attention  # noqa: E402
from test_torch_train import _check, _rle_case, _run_both  # noqa: E402


@pytest.fixture(scope="module")
def rle_run():
    calls = []
    original = flash_attention.flash_attention_fwd_plain

    def counting(*args):
        calls.append(args[0].shape)
        return original(*args)

    flash_attention.flash_attention_fwd_plain = counting
    try:
        result = _run_both(_rle_case)
    finally:
        flash_attention.flash_attention_fwd_plain = original
    return result, calls


@pytest.mark.parametrize("steps", [1, 3])
def test_rle_trainer_matches_jax_trainer(rle_run, steps):
    """RLE source at L 2100: the encoder self-attention goes through flash
    attention in both packages (the port's CPU path counted here, padded to
    2304), so these steps run the flash forward and backward."""
    run, flash_calls = rle_run
    assert flash_calls and all(shape[2] == 2304 for shape in flash_calls)
    _check(run, steps)
