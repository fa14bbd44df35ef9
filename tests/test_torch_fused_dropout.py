"""The port's fused dropout (plain version, CPU) against its contract and the
JAX ``pallas_dropout``.

The two packages draw their bits from different generators (Philox4x32-10
here, the TPU core's PRNG or, on the CPU, ``jax.random`` there), so masks
cannot match: the JAX comparison holds the values both keep (equal, rtol 0)
and both keep fractions. The bits themselves are held to Random123's
published known-answer vectors; the CUDA kernel is held to this plain
version bit for bit on the card (``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.ops.fused_dropout import pallas_dropout  # noqa: E402
from multimodalanalytical_tpu_torch.ops import fused_dropout as fd  # noqa: E402

# Random123 kat_vectors, philox4x32 with 10 rounds: counter, key -> output.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _seed(value):
    return torch.tensor([value], dtype=torch.int64)


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    words = fd.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter],
                             tuple(torch.tensor(k, dtype=torch.int64) for k in key))
    assert tuple(int(w) for w in words) == want


def test_mulhilo_matches_python_integers():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.int64)
    b[:3] = [0, 1, 2 ** 32 - 1]
    for a in fd.PHILOX_M:
        hi, lo = fd._mulhilo32(a, torch.from_numpy(b))
        full = [a * int(v) for v in b]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]


def test_bits_of_an_element_are_its_counters_word():
    """Element i takes word i % 4 of counter i // 4 under the seed's two
    32-bit halves (a negative seed included)."""
    seed = -(2 ** 40) - 12345
    bits = fd.dropout_bits(_seed(seed), 10)
    key = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
    for group in range(3):
        words = fd.philox4x32_10([torch.tensor([group]), torch.tensor([0]), torch.tensor([0]),
                                  torch.tensor([0])],
                                 (torch.tensor(key[0]), torch.tensor(key[1])))
        for j in range(4):
            if 4 * group + j < 10:
                assert int(bits[4 * group + j]) == int(words[j])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_contract(dtype, rate):
    """Deterministic per seed, different seeds differ, the keep fraction
    within 5 sigma of 1 - rate, kept values float32(x) * float32(1/(1-rate))
    rounded once to x's dtype, dropped ones 0."""
    x = (torch.randn(64, 257, generator=torch.Generator().manual_seed(1)) + 3.0).to(dtype)
    out = fd.fused_dropout(x, _seed(7), rate)
    assert fd.fused_dropout.launches == 0            # CPU: the plain version
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, fd.fused_dropout(x, _seed(7), rate))
    assert not torch.equal(out, fd.fused_dropout(x, _seed(8), rate))
    kept = out != 0
    sigma = math.sqrt(rate * (1 - rate) / x.numel())
    assert abs(kept.float().mean().item() - (1 - rate)) <= 5 * sigma
    inv = torch.tensor(np.float32(1.0 / (1.0 - rate)))
    assert torch.equal(out[kept], (x.float() * inv).to(dtype)[kept])
    # The mask is the bits' comparison with the threshold.
    keep = fd.dropout_bits(_seed(7), x.numel()) >= fd.drop_threshold(rate)
    assert torch.equal(kept.reshape(-1), keep)


def test_gradient_reuses_the_mask_and_keeps_only_the_seed():
    x = (torch.randn(33, 65, generator=torch.Generator().manual_seed(2)) + 3.0).requires_grad_()
    generator = torch.Generator().manual_seed(3)
    out = fd.dropout(x, 0.25, generator)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.int64 and saved[0].numel() == 1
    weight = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    (out * weight).sum().backward()
    kept = out != 0
    assert torch.equal(x.grad != 0, kept)
    np.testing.assert_array_equal(x.grad[kept].numpy(),
                                  (weight * np.float32(1 / 0.75))[kept].numpy())


def test_rate_zero_and_guards():
    x = torch.randn(5, 7)
    assert torch.equal(fd.fused_dropout(x, _seed(1), 0.0), x)
    g = torch.Generator().manual_seed(0)
    assert fd.dropout(x, 0.0, g) is x and fd.dropout(x, 0.1, None) is x
    assert torch.equal(fd.dropout(x, 1.0, g), torch.zeros_like(x))
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="rate"):
            fd.fused_dropout_plain(x, _seed(1), rate)
    assert fd.drop_threshold(0.1) == round(0.1 * 2 ** 32)
    assert fd.drop_threshold(1 - 2 ** -40) == 2 ** 32 - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_against_pallas_dropout(dtype, rate):
    """On the elements both keep the values are equal (rtol 0); both keep
    fractions lie within 5 sigma of 1 - rate."""
    x = np.random.default_rng(5).normal(size=(48, 512)).astype(np.float32) + 4.0
    want = np.asarray(pallas_dropout(jnp.asarray(x, dtype), jax.random.PRNGKey(11), rate),
                      np.float32)
    got = fd.fused_dropout(torch.from_numpy(x).to(getattr(torch, dtype)), _seed(11),
                           rate).float().numpy()
    sigma = math.sqrt(rate * (1 - rate) / x.size)
    for out in (want, got):
        assert abs((out != 0).mean() - (1 - rate)) <= 5 * sigma
    both = (want != 0) & (got != 0)
    assert both.mean() > (1 - rate) ** 2 - 5 * sigma
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=0)
