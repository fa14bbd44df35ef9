"""The port's flash attention against the JAX package's Pallas kernels.

The JAX kernels run in interpret mode on the CPU, as
``tests/test_flash_attention.py`` runs them; the port takes the plain
versions of its CUDA kernels there, through the same autograd Function that
launches the kernels on a CUDA tensor. Inputs are seeded numpy arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.ops import attention as jax_attention  # noqa: E402
from multimodalanalytical_tpu.ops import flash_attention as jax_flash  # noqa: E402
from multimodalanalytical_tpu_torch.ops import attention  # noqa: E402
from multimodalanalytical_tpu_torch.ops import flash_attention as flash  # noqa: E402

NEG_INF = -1e9


def _inputs(b, h, length, d, masked_from=None, seed=0, dead_row=None):
    """q, k, v (B, H, L, Dh) fp32 and a (B, L) bias row; row ``dead_row`` of
    the batch has every key masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, length, d)).astype(np.float32) for _ in range(3))
    bias = np.zeros((b, length), np.float32)
    if masked_from is not None:
        bias[:, masked_from:] = NEG_INF
    if dead_row is not None:
        bias[dead_row] = NEG_INF
    return q, k, v, bias


def _t(*arrays, dtype=torch.float32, grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("dead_row", [None, 1])
def test_forward_matches_pallas_fwd(dead_row):
    """Out and lse of the plain forward vs the Pallas ``_fwd`` on padded
    operands, fp32, within 1e-4 (summation order only). A fully masked batch
    row (``dead_row``) averages over its keys in both."""
    q, k, v, bias = _inputs(2, 2, 512, 64, masked_from=400, dead_row=dead_row)
    out, lse = jax.jit(lambda *a: jax_flash._fwd(*a, 256, 256))(q, k, v, bias)
    got_out, got_lse = flash.flash_attention_fwd(*_t(q, k, v, bias))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=1e-6, atol=1e-4)


def test_backward_matches_jax_grad_of_flash():
    """dq, dk, dv through torch.autograd (the Function's CPU path) vs
    ``jax.grad`` of the custom-VJP ``_flash``, fp32, within 1e-3."""
    q, k, v, bias = _inputs(1, 2, 512, 64, masked_from=300)
    rng = np.random.default_rng(1)
    weight = rng.standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_flash._flash(q, k, v, jnp.asarray(bias), 256, 256) * weight)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = flash.FlashAttentionFunction.apply(tq, tk, tv, torch.as_tensor(bias))
    (out * torch.as_tensor(weight)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


@pytest.mark.parametrize("dead_row", [None, 0])
def test_flash_attention_ragged_length_matches_jax(dead_row):
    """The public entry at a ragged length (2100, padded to 2304 inside, as
    ``tests/test_flash_attention.py`` pins for the JAX wrapper), with a
    masked tail and optionally a batch row whose keys are all masked:
    output and gradients vs ``jax_flash.flash_attention``, fp32."""
    q, k, v, bias_row = _inputs(2, 1, 2100, 64, masked_from=2050, dead_row=dead_row, seed=2)
    bias = bias_row[:, None, None, :]
    rng = np.random.default_rng(3)
    weight = rng.standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, jnp.asarray(bias))
        return jnp.sum(out * weight), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    got = attention.dot_product_attention(tq, tk, tv, torch.as_tensor(bias), use_flash=True)
    (got * torch.as_tensor(weight)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for g, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_bf16_forward_and_backward_match_pallas():
    """bf16 operands: both sides upcast to fp32 and round once, so outputs
    differ at most where the summation order flips that rounding, by one
    bf16 ulp (2**-7 of the value), and gradients by one ulp of the largest."""
    q, k, v, bias = _inputs(1, 2, 512, 64, masked_from=450, seed=4)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    out, lse = jax.jit(lambda *a: jax_flash._fwd(*a, 256, 256))(qb, kb, vb, bias)
    tq, tk, tv = (t.detach().requires_grad_() for t in _t(q, k, v, dtype=torch.bfloat16))
    got = flash.FlashAttentionFunction.apply(tq, tk, tv, torch.as_tensor(bias))
    want = np.asarray(out.astype(jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=2 ** -7, atol=1e-6)
    _, got_lse = flash.flash_attention_fwd(tq.detach(), tk.detach(), tv.detach(),
                                           torch.as_tensor(bias))
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=1e-6, atol=1e-4)

    rng = np.random.default_rng(5)
    dout = jnp.asarray(rng.standard_normal(q.shape), jnp.bfloat16)
    grads = jax.jit(lambda q, k, v: jax.vjp(
        lambda *a: jax_flash._flash(*a, jnp.asarray(bias), 256, 256), q, k, v)[1](dout))(
        qb, kb, vb)
    got.backward(torch.tensor(np.asarray(dout.astype(jnp.float32))).bfloat16())
    for g, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0,
                                   atol=2 ** -7 * np.abs(ref).max())


def test_qualifies_is_the_jax_gate():
    x = torch.zeros(1, 1, 2048, 64)
    row_bias = torch.zeros(1, 1, 1, 2048)
    assert flash.flash_qualifies(x, x, None, None)
    assert flash.flash_qualifies(x, x, row_bias, None)
    assert not flash.flash_qualifies(x, x, None, 1.0)                    # unscaled (T5)
    assert not flash.flash_qualifies(x[:, :, :2047], x[:, :, :2047], None, None)
    assert not flash.flash_qualifies(x, x[:, :, :1024], None, None)      # cross-attention
    assert not flash.flash_qualifies(x, x, torch.zeros(1, 1, 2048, 2048), None)  # causal
    assert not flash.flash_qualifies(x[..., :32], x[..., :32], None, None)


def test_kernel_head_dims_are_what_the_gate_routes_up_to_128():
    """The CUDA wrapper declares exactly the head widths that the gate sends
    to flash attention up to 256, the widest a model config reaches (64 and
    128, and 192 and 256 since the kernels took them)."""
    routed = [d for d in range(1, 257)
              if flash.flash_qualifies(torch.zeros(1, 1, 2048, d), torch.zeros(1, 1, 2048, d),
                                       None, None)]
    assert tuple(d for d in routed if d <= 128) == (64, 128)
    assert tuple(routed) == flash.KERNEL_HEAD_DIMS == (64, 128, 192, 256)


@pytest.mark.parametrize("head_dim, heads", [(192, 2), (256, 1)])
def test_wide_heads_match_jax(head_dim, heads):
    """Head widths 192 and 256 (d_model 768 with 4 heads, 512 with 2): the
    public entry at L 2048 with a masked tail, output and gradients vs
    ``jax_flash.flash_attention`` in interpret mode, fp32, within the
    tolerances of the narrower widths (1e-4 and 1e-3: summation order)."""
    q, k, v, bias_row = _inputs(1, heads, 2048, head_dim, masked_from=1990, seed=7)
    bias = bias_row[:, None, None, :]
    rng = np.random.default_rng(8)
    weight = rng.standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, jnp.asarray(bias))
        return jnp.sum(out * weight), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    got = attention.dot_product_attention(tq, tk, tv, torch.as_tensor(bias), use_flash=True)
    (got * torch.as_tensor(weight)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for g, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_dot_product_attention_takes_flash_math_at_the_gate():
    """Regression for the port's CPU path at flash shapes: at L 2048 in bf16,
    ``dot_product_attention(use_flash=True)`` computes what the JAX package
    computes there (the flash kernel's fp32 math, one rounding), not the
    reference math (q*scale and the probabilities rounded to bf16). The two
    differ in ~40% of the outputs; the same math differs only where the
    summation order flips a rounding."""
    q, k, v, bias_row = _inputs(1, 1, 2048, 64, masked_from=1900, seed=6)
    bias = bias_row[:, None, None, :]
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jax.jit(lambda q, k, v, b: jax_attention.dot_product_attention(
        q, k, v, b, use_flash=True))(*bf, bias)
    want = np.asarray(want.astype(jnp.float32))
    got = attention.dot_product_attention(*_t(q, k, v, dtype=torch.bfloat16),
                                          torch.as_tensor(bias), use_flash=True)
    got = got.float().numpy()
    assert (got != want).mean() < 0.01
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
