"""The port's decode FFN (plain version, CPU) vs the JAX Pallas kernel run
in interpret mode, at the shape tests/test_beam_kernel.py uses; a plain
model of the CUDA kernel's split-K arithmetic against the same; and the
split plan of its down product."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.ops.decode_ffn import geglu_ffn as jax_geglu_ffn  # noqa: E402
from multimodalanalytical_tpu_torch.ops import decode_ffn  # noqa: E402

M, D, F = 256, 128, 256
SMS = 132            # an H100 SXM's streaming multiprocessors
RMS_TOL = 1e-2       # chip_smoke.py's FFN_RMS_TOL: |got - want|_2 / |want|_2


@functools.lru_cache(maxsize=None)
def _case(gated):
    """Seeded inputs (numpy, the JAX layout (in, out)) and the Pallas
    kernel's output in interpret mode."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, D)).astype(np.float32)
    w1, wg = (rng.normal(0, D ** -0.5, (D, F)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(0, F ** -0.5, (F, D)).astype(np.float32)
    b1, bg, b2 = (0.1 * rng.normal(size=n).astype(np.float32) for n in (F, F, D))
    if not gated:
        wg = bg = None
    want = jax_geglu_ffn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1),
        None if wg is None else jnp.asarray(wg), None if bg is None else jnp.asarray(bg),
        jnp.asarray(w2), jnp.asarray(b2))
    return (x, w1, b1, wg, bg, w2, b2), np.asarray(want, np.float32)


def _torch_args(args):
    """The inputs as the port takes them: PyTorch's Linear layout (out, in)."""
    x, w1, b1, wg, bg, w2, b2 = args
    t = torch.from_numpy
    return (t(x).to(torch.bfloat16), t(w1.T.copy()), t(b1), None if wg is None else t(wg.T.copy()),
            None if bg is None else t(bg), t(w2.T.copy()), t(b2))


@pytest.mark.parametrize("gated", [False, True])
def test_geglu_ffn_matches_pallas_interpret(gated):
    args, want = _case(gated)
    got = decode_ffn.geglu_ffn(*_torch_args(args))
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    # bf16 rounding after each product and bias add on both sides; the
    # products accumulate in another order (tests/test_beam_kernel.py:393-395).
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < 0.02, rel
    assert decode_ffn.geglu_ffn.launches == 0     # CPU tensors never launch


def _split_model(x, w1, b1, wg, bg, w2, b2, splits):
    """csrc/decode_ffn.cu's arithmetic in plain torch: the up product
    rounded as its epilogue rounds (product, + bias, GELU, gate), then the
    down product as fp32 partials over each split's 64-deep stages of F,
    added in split order, rounded once, + b2, rounded."""
    def r(t):
        return t.to(torch.bfloat16).float()

    f = w1.shape[0]
    x = r(x)
    act = r(torch.nn.functional.gelu(r(r(x @ r(w1).t()) + r(b1))))
    if wg is not None:
        act = r(act * r(r(x @ r(wg).t()) + r(bg)))
    total = None
    for first, last in decode_ffn.split_stages(f, splits):
        cols = slice(decode_ffn.STAGE_K * first, min(decode_ffn.STAGE_K * last, f))
        part = act[:, cols] @ r(w2)[:, cols].t()
        total = part if total is None else total + part
    return r(r(total) + r(b2))


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("gated", [False, True])
def test_split_k_arithmetic_matches_pallas_interpret(gated, splits):
    """The kernel's split-K arithmetic against the Pallas kernel: max error
    within 2% of the peak, as the plain version, and error norm within
    RMS_TOL (bf16 roundings after fp32 sums in another order)."""
    args, want = _case(gated)
    got = _split_model(*_torch_args(args), splits).numpy()
    diff = got - want
    assert np.abs(diff).max() / np.abs(want).max() < 0.02
    assert np.linalg.norm(diff) / np.linalg.norm(want) < RMS_TOL


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("gated", [False, True])
def test_partial_mode_summed_over_shards_matches_pallas_interpret(gated, shards):
    """Partial mode, as tensor parallelism runs it: each shard's (M, D) fp32
    down product over its F / n columns (no b2, no rounding), summed over
    the shards, rounded, + b2, rounded, against the Pallas kernel within
    the full mode's tolerances."""
    args, want = _case(gated)
    x, w1, b1, wg, bg, w2, b2 = _torch_args(args)
    width = F // shards
    total = None
    for z in range(shards):
        cols = slice(z * width, (z + 1) * width)
        part = decode_ffn.geglu_ffn(x, w1[cols], b1[cols], None if wg is None else wg[cols],
                                    None if bg is None else bg[cols], w2[:, cols], None,
                                    partial=True)
        assert part.dtype == torch.float32 and part.shape == (M, D)
        total = part if total is None else total + part
    got = (total.to(torch.bfloat16) + b2.to(torch.bfloat16)).float().numpy()
    diff = got - want
    assert np.abs(diff).max() / np.abs(want).max() < 0.02
    assert np.linalg.norm(diff) / np.linalg.norm(want) < RMS_TOL


@pytest.mark.parametrize("m,want", [(128, (1, 64, 9)), (1280, (2, 128, 2)), (3840, (2, 128, 1))])
def test_split_plan_fills_the_card_at_the_decode_shapes(m, want):
    """M = B K at validation (K 1), serving (K 10) and predict (K 30), D 512,
    F 2048: the down product's tiles times the splits give at least one
    block per SM, with no split more than that needs; the up product takes
    turns (ping-pong) once it has two 64 x 64 tiles per SM."""
    plan = decode_ffn.ffn_plan(m, 512, 2048, SMS)
    tiles = -(-m // decode_ffn.TILE_M) * -(-512 // plan.down_tile_n)
    assert tuple(plan) == want
    assert tiles * plan.splits >= SMS and (plan.splits == 1 or tiles * (plan.splits - 1) < SMS)
    up_tiles = -(-m // decode_ffn.TILE_M) * -(-2048 // decode_ffn.UP_TILE_N)
    assert (plan.up_groups == 2) == (up_tiles >= 2 * SMS)


@pytest.mark.parametrize("f", [2048, 40, 2056])
def test_split_plan_covers_f_exactly_once(f):
    """Every split count the plan can pick (1 to ceil(F / 64)) gives each
    split at least one 64-deep stage, and the stages cover F once, in order."""
    stages = -(-f // decode_ffn.STAGE_K)
    picks = {decode_ffn.ffn_plan(m, 512, f, SMS).splits
             for m in (1, 12, 128, 129, 1280, 3840, 3841)}
    assert picks <= set(range(1, stages + 1))
    for splits in range(1, stages + 1):
        bounds = decode_ffn.split_stages(f, splits)
        assert all(last > first for first, last in bounds)
        assert [b for bound in bounds for b in range(*bound)] == list(range(stages))
        assert stages * decode_ffn.STAGE_K >= f > (stages - 1) * decode_ffn.STAGE_K
