"""The port's decode FFN (plain version, CPU) vs the JAX Pallas kernel run
in interpret mode, at the shape tests/test_beam_kernel.py uses."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.ops.decode_ffn import geglu_ffn as jax_geglu_ffn  # noqa: E402
from multimodalanalytical_tpu_torch.ops import decode_ffn  # noqa: E402

M, D, F = 256, 128, 256


@pytest.mark.parametrize("gated", [False, True])
def test_geglu_ffn_matches_pallas_interpret(gated):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, D)).astype(np.float32)
    # JAX kernels are (in, out); the port takes PyTorch's (out, in).
    w1, wg = (rng.normal(0, D ** -0.5, (D, F)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(0, F ** -0.5, (F, D)).astype(np.float32)
    b1, bg, b2 = (0.1 * rng.normal(size=n).astype(np.float32) for n in (F, F, D))
    want = jax_geglu_ffn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(wg) if gated else None, jnp.asarray(bg) if gated else None,
        jnp.asarray(w2), jnp.asarray(b2))
    t = torch.from_numpy
    got = decode_ffn.geglu_ffn(
        t(x).to(torch.bfloat16), t(w1.T.copy()), t(b1), t(wg.T.copy()) if gated else None,
        t(bg) if gated else None, t(w2.T.copy()), t(b2))
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    # bf16 rounding after each product and bias add on both sides; the
    # products accumulate in another order (tests/test_beam_kernel.py:393-395).
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < 0.02, rel
    assert decode_ffn.geglu_ffn.launches == 0     # CPU tensors never launch
