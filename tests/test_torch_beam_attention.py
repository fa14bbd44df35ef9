"""The port's beam attention (plain versions, CPU) vs the JAX Pallas kernels
run in interpret mode, at the shapes tests/test_beam_kernel.py uses."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.ops import attention as jax_attention  # noqa: E402
from multimodalanalytical_tpu.ops import beam_attention as jax_beam  # noqa: E402
from multimodalanalytical_tpu_torch.ops import attention as port_attention  # noqa: E402
from multimodalanalytical_tpu_torch.ops import beam_attention as port_beam  # noqa: E402

B, K, L, H, DH = 3, 4, 16, 2, 8
D = H * DH
TOL = 2e-2   # bf16 rounding of q, probabilities and outputs, as in test_beam_kernel.py


def _bf16(x):
    """The same bf16 values in both frameworks (both round to nearest even)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B * K, D))
    cache = rng.normal(size=(2, B, L * K, D))
    k_new = rng.normal(size=(B * K, D))
    v_new = rng.normal(size=(B * K, D))
    ancestry = rng.integers(0, K, (B, K, L)).astype(np.int32)
    return q, cache, k_new, v_new, ancestry


def _jax_fresh_scale_operands(k_s, v_s):
    """The lane-padded scale operands the Pallas update kernel takes
    (built as ops/attention.py builds them)."""
    def one(s):
        s_bkh = s.reshape(B, K, H)
        hk = jnp.pad(jnp.transpose(s_bkh, (0, 2, 1)), ((0, 0), (0, 0), (0, 128 - K)))
        sel = jnp.pad(s_bkh.reshape(B, K * H), ((0, 0), (0, 128 - K * H)))
        return hk, sel

    k_hk, k_sel = one(k_s)
    v_hk, v_sel = one(v_s)
    return jnp.stack([k_hk, v_hk]), jnp.stack([k_sel, v_sel], axis=1)


@pytest.mark.parametrize("position", [0, 5, L - 1])
def test_update_bf16_matches_pallas_interpret(position):
    q, cache, k_new, v_new, ancestry = _inputs(7)
    ancestry[:, :, position] = np.arange(K)
    (qj, qt), (cj, ct), (kj, kt), (vj, vt) = map(_bf16, (q, cache, k_new, v_new))
    want, cache_want, _ = jax_beam.beam_select_attention_update(
        qj, kj, vj, cj, jnp.asarray(ancestry), position, H)
    got = port_beam.beam_select_attention_update(
        qt, kt, vt, ct, torch.from_numpy(ancestry), position, H)
    assert port_beam.beam_select_attention_update.launches == 0   # CPU: the plain version
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(ct.float().numpy(), np.asarray(cache_want, np.float32))


@pytest.mark.parametrize("position", [0, 5, L - 1])
def test_update_int8_matches_pallas_interpret(position):
    q, cache, k_new, v_new, ancestry = _inputs(8)
    ancestry[:, :, position] = np.arange(K)
    (qj, qt), (cj, _), (kj, kt), (vj, vt) = map(_bf16, (q, cache, k_new, v_new))
    data0, scale0 = jax_attention.quantize_kv_heads(cj, H)          # (2,B,F,D), (2,B,F,H)
    scale0 = jnp.pad(scale0.transpose(0, 1, 3, 2), ((0, 0), (0, 0), (0, 0), (0, 128 - L * K)))
    k_q, k_s = jax_attention.quantize_kv_heads(kj, H)
    v_q, v_s = jax_attention.quantize_kv_heads(vj, H)
    hk, sel = _jax_fresh_scale_operands(k_s, v_s)
    want, data_want, scale_want = jax_beam.beam_select_attention_update(
        qj, k_q, v_q, data0, jnp.asarray(ancestry), position, H,
        scales=scale0, fresh_scales=hk, fresh_row_scales=sel)

    # The port's update takes the same bf16 rows un-quantized and quantizes
    # them itself (the fused form of JAX's quantize_kv_heads + update).
    data = torch.from_numpy(np.array(data0))
    scales = torch.from_numpy(np.array(scale0))
    got = port_beam.beam_select_attention_update(
        qt, kt, vt, data, torch.from_numpy(ancestry), position, H, scales=scales)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(data.numpy(), np.asarray(data_want))
    np.testing.assert_allclose(scales.numpy(), np.asarray(scale_want), rtol=1e-6)


def _cross_operands(rng, ls, dtype):
    """q, K, V in both frameworks (bf16 rounded alike, or fp32) and a bias
    over three rows: ragged padding, the last 300 keys masked (every key
    but the first where Ls <= 300), and a fully padded (batch-padding)
    row."""
    def both(x):
        if dtype == "bfloat16":
            return _bf16(x)
        x = np.asarray(x, np.float32)
        return jnp.asarray(x), torch.from_numpy(x)

    (qj, qt), (kj, kt), (vj, vt) = map(both, (rng.normal(size=(B * K, D)),
                                              rng.normal(size=(B, ls, D)),
                                              rng.normal(size=(B, ls, D))))
    keep = rng.random((B, ls)) < 0.8
    keep[:, 0] = True
    keep[1, max(1, ls - 300):] = False
    keep[2] = False
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return (qj, kj, vj), (qt, kt, vt), bias


@pytest.mark.parametrize("masks", ["ragged", "padded tails"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("ls", [11, 256, 257, 279, 300, 600, 1025, 2100, 4090])
def test_cross_matches_pallas_interpret(ls, dtype, masks):
    """The Pallas cross kernel in interpret mode against the port's plain
    version (what the kernels are held to on the card), at the flagship's
    one-pass length and its limit (256), and at split-form lengths (a last
    tile of one key at 257, the multimodal recipe's 279, 300, 600, 1025, an
    RLE encoder's 2100 and 4090), in bf16 and fp32 (products in fp32, sums
    in another order). The masks: :func:`_cross_operands`' ragged rows, or
    a run-length-encoded batch's padding (row 0 at full length, row 1 with
    its valid keys ending at key 10, inside the split form's first tile,
    row 2 fully masked); a fully masked row gives the uniform average."""
    rng = np.random.default_rng(3)
    jax_ops, port_ops, bias = _cross_operands(rng, ls, dtype)
    if masks == "padded tails":
        lengths = np.array([[ls], [min(ls, 10)], [0]])
        bias = np.where(np.arange(ls)[None, :] < lengths, 0.0, -1e9).astype(np.float32)
    want = jax_beam.beam_cross_attention(*jax_ops, jnp.asarray(bias), H, K)
    got = port_beam.beam_cross_attention(*port_ops, torch.from_numpy(bias), H, K)
    assert port_beam.beam_cross_attention.launches == 0       # CPU: the plain version
    tol = TOL if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)
    uniform = port_ops[2][2].float().mean(0).numpy()
    np.testing.assert_allclose(got[2 * K:].float().numpy(),
                               np.broadcast_to(uniform, (K, D)), rtol=0, atol=tol)


def test_quantize_kv_heads_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 8, D)).astype(np.float32)
    want_q, want_s = jax_attention.quantize_kv_heads(jnp.asarray(x), H)
    got_q, got_s = port_attention.quantize_kv_heads(torch.from_numpy(x), H)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    np.testing.assert_array_equal(
        port_attention.dequantize_kv(got_q, got_s.permute(0, 1, 3, 2), H).float().numpy(),
        np.asarray(jax_attention.dequantize_kv(want_q, want_s.transpose(0, 1, 3, 2), H),
                   np.float32))


@pytest.mark.parametrize("beams,d_model,heads,want", [
    (10, 512, 8, True),        # serving
    (30, 512, 8, True),        # predict
    (1, 512, 8, True),         # validation
    (79, 512, 8, True),        # beyond the select kernel's all-in-shared-memory plan at L 128
    (128, 512, 8, True),       # K x head_dim 8192: the largest K at head_dim 64
    (129, 512, 8, False),
    (32, 1024, 4, True),       # the largest K at head_dim 256
    (33, 1024, 4, False),
    (256, 256, 8, True),       # 256 beams at head_dim 32
    (0, 512, 8, False),
    (10, 512, 3, False),       # head_dim not integral
    (10, 36, 3, False),        # head_dim 12
    (10, 2048, 4, False),      # head_dim 512 > 256
    (300, 64, 8, False),       # more than 256 beams
])
def test_kernel_gate(beams, d_model, heads, want):
    """The gate is static: K x head_dim <= 8192 fits both kernels' plans at
    any stage and encoder length (tests/test_torch_cuda.py launches its
    largest plans on the card)."""
    assert port_beam.beam_kernel_supports(beams, d_model, heads) is want


def _read_only_inputs(seed, beams, length, heads, head_dim):
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    q = rng.normal(size=(2, beams, d))
    cache = rng.normal(size=(2, 2, length * beams, d))
    ancestry = rng.integers(0, beams, (2, beams, length)).astype(np.int32)
    return q, cache, ancestry


@pytest.mark.parametrize("beams", [10, 30])
@pytest.mark.parametrize("quantized", [False, True])
def test_read_only_matches_pallas_interpret(beams, quantized):
    """The read-only mode (ancestry[:, :, pos] drawn at random, as
    tests/test_beam30.py draws it) vs the Pallas ``beam_select_attention``
    in interpret mode, at positions 0, mid and last; the int8 cache with
    scales quantized as the decode path quantizes them."""
    length, heads, head_dim = 16, 2, 64
    q, cache, ancestry = _read_only_inputs(9, beams, length, heads, head_dim)
    (qj, qt), (cj, ct) = _bf16(q), _bf16(cache)
    if quantized:
        data, scale = jax_attention.quantize_kv_heads(cj, heads)         # (2,B,F,D), (2,B,F,H)
        cj, scales_j = data, scale.transpose(0, 1, 3, 2)
        ct, scales_t = torch.from_numpy(np.array(data)), torch.from_numpy(np.array(scales_j))
    else:
        scales_j = scales_t = None
    for position in (0, length // 2, length - 1):
        want = jax_beam.beam_select_attention(qj, cj, jnp.asarray(ancestry), position, heads,
                                              scales=scales_j)
        got = port_beam.beam_select_attention(qt, ct, torch.from_numpy(ancestry), position,
                                              heads, scales_t)
        assert port_beam.beam_select_attention.launches == 0    # CPU: the plain version
        assert got.shape == (2, beams, heads * head_dim) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=TOL)


def test_read_only_reads_time_pos_through_ancestry():
    """Where the two modes differ: at ``pos`` the update attends each beam's
    own fresh row, the read-only mode the row its ancestry names. With the
    update's rows already stored and ancestry[:, :, pos] the identity, the
    two agree; with another slot at pos, the read-only result follows it."""
    q, cache, ancestry = _read_only_inputs(10, K, L, H, DH)
    pos = 5
    ancestry[:, :, pos] = np.arange(K)
    qt, ct = torch.from_numpy(q).bfloat16(), torch.from_numpy(cache).bfloat16()
    anc = torch.from_numpy(ancestry)
    rows = ct[:, :, pos * K:(pos + 1) * K].clone()
    upd = port_beam.beam_select_attention_update_plain(
        qt.reshape(-1, D), rows[0].reshape(-1, D), rows[1].reshape(-1, D), ct.clone(), anc,
        pos, H)
    ro = port_beam.beam_select_attention_plain(qt, ct, anc, pos, H)
    assert torch.equal(ro.reshape(-1, D), upd)
    shifted = anc.clone()
    shifted[:, :, pos] = (shifted[:, :, pos] + 1) % K
    other = port_beam.beam_select_attention_plain(qt, ct, shifted, pos, H)
    assert not torch.equal(other, ro)
