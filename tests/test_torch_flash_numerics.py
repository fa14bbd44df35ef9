"""The numerics of the port's bf16 tensor-core flash kernels, modelled on the
CPU and held against the JAX package's Pallas kernels.

The CUDA kernels cannot run here. What they change against the fp32-faithful
plain versions is where they round: P (for P V and P^T dO) and dS (for dS K
and dS^T Q) are rounded to bf16 as tensor-core operands, per key stage of
the forward kernel's online softmax (128 keys at head_dim 64, 64 at 128:
``Layout<HD>::kKeys`` in ``csrc/flash_attention.cu``); every sum stays in
fp32. The model below makes exactly those roundings in plain torch (it lives
here, not in the port) and is held against the Pallas kernels in interpret
mode within the tolerances ``chip_smoke.py`` holds the kernels to on the
card, before any card run: for out and each gradient, max|error| within
FLASH_TOL * max|reference| and the error's norm within FLASH_RMS_TOL of the
reference's; lse elementwise within LSE_REL_TOL of max(1, |lse|). The same
check rejects the model with one key stage left out.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.ops import flash_attention as jax_flash  # noqa: E402

NEG_INF = -1e9
BLK = 256          # the wrappers' padding block
KEY_TILE = {64: 128, 128: 64}   # keys per ring stage of the forward kernel, by head_dim
FLASH_TOL = 2e-2       # chip_smoke.py's: of max|reference|
FLASH_RMS_TOL = 1e-2   # chip_smoke.py's: |error|_2 / |reference|_2
LSE_REL_TOL = 1e-5


def _bf16(x):
    return x.to(torch.bfloat16).float()


def kernel_model_fwd(q, k, v, bias_row):
    """The forward kernel's arithmetic on fp32 copies of bf16 operands:
    S in fp32 scaled after the product, bias added in fp32, the running max
    and the denominator from the fp32 probabilities, P rounded to bf16 for
    P V per key stage, the output rounded once."""
    scale = q.shape[-1] ** -0.5
    tile = KEY_TILE[q.shape[-1]]
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = q.shape[:3]
    m = torch.full(rows, NEG_INF)
    l = torch.zeros(rows)
    o = torch.zeros(q.shape)
    for j in range(0, k.shape[2], tile):
        s = qf @ kf[:, :, j:j + tile].transpose(-1, -2) * scale
        s = s + bias_row[:, None, None, j:j + tile]
        mx = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + _bf16(p) @ vf[:, :, j:j + tile]
        m = mx
    safe = torch.where(l > 0, l, torch.ones_like(l))
    return (o / safe[..., None]).to(q.dtype), m + torch.log(safe)


def kernel_model_bwd(q, k, v, bias_row, out, lse, do):
    """The backward kernels' arithmetic: P recomputed in fp32 from the saved
    lse, dS in fp32, P and dS rounded to bf16 as operands of dV, dK and dQ,
    each gradient summed in fp32 and rounded once."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)
    s = qf @ kf.transpose(-1, -2) * scale + bias_row[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dq = _bf16(ds) @ kf * scale
    dk = _bf16(ds).transpose(-1, -2) @ qf * scale
    dv = _bf16(p).transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _pad(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows))


def _errors(got, ref):
    """max|got - ref| / max|ref| and |got - ref|_2 / |ref|_2 over the
    reference's rows."""
    ref = torch.as_tensor(np.array(ref.astype(jnp.float32)))
    diff = got[:, :, :ref.shape[2]].float() - ref
    assert ref.abs().max() > 0
    return (diff.abs().max() / ref.abs().max()).item(), (diff.norm() / ref.norm()).item()


def _model_vs_pallas(length, head_dim, dropped_keys=None):
    """B 1, H 2, bf16, a masked key tail: the modelled kernel vs
    ``jax_flash.flash_attention`` (Pallas, interpret mode) on the same
    seeded inputs, padded to 256 rows as both wrappers pad them; the keys
    ``dropped_keys`` are masked for the model only. Returns the errors of
    out, dq, dk, dv and the model's and Pallas' lse."""
    rng = np.random.default_rng(length + head_dim)
    shape = (1, 2, length, head_dim)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    bias = np.zeros((1, length), np.float32)
    bias[:, length - 77:] = NEG_INF
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jbias = jnp.asarray(bias[:, None, None, :])

    def fwd(q, k, v):
        return jax_flash.flash_attention(q, k, v, jbias)

    want, vjp = jax.vjp(fwd, jq, jk, jv)
    want_grads = vjp(jdo)
    pad = (-length) % BLK
    padded_bias = torch.nn.functional.pad(torch.as_tensor(bias), (0, pad), value=NEG_INF)
    model_bias = padded_bias.clone()
    if dropped_keys is not None:
        model_bias[:, dropped_keys] = NEG_INF
    tq, tk, tv, tdo = (_pad(torch.tensor(x).bfloat16(), pad) for x in (q, k, v, do))
    out, lse = kernel_model_fwd(tq, tk, tv, model_bias)
    grads = kernel_model_bwd(tq, tk, tv, model_bias, out, lse, tdo)
    errors = [_errors(got, ref) for got, ref in zip((out,) + grads, (want,) + tuple(want_grads))]
    padded = (jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (jq, jk, jv))
    _, jax_lse = jax.jit(lambda *a: jax_flash._fwd(*a, BLK, BLK))(
        *padded, jnp.asarray(padded_bias.numpy()))
    return errors, lse, torch.as_tensor(np.array(jax_lse))


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("length", [2048, 2100])
def test_kernel_roundings_fit_the_tolerance_against_pallas(length, head_dim):
    """The modelled kernel agrees with Pallas: every tensor within FLASH_TOL
    of its own peak and FLASH_RMS_TOL in norm, lse within LSE_REL_TOL."""
    errors, lse, jax_lse = _model_vs_pallas(length, head_dim)
    for peak_err, rms_err in errors:
        assert peak_err <= FLASH_TOL and rms_err <= FLASH_RMS_TOL, (peak_err, rms_err)
    rel = ((lse - jax_lse).abs() / jax_lse.abs().clamp_min(1.0)).max().item()
    assert rel <= LSE_REL_TOL, rel


@pytest.mark.parametrize("head_dim,length", [(64, 2048), (128, 2100)])
def test_the_tolerance_rejects_a_skipped_key_stage(length, head_dim):
    """A kernel that skipped one key stage (the second one), as the model
    with those keys masked: out and every gradient fail both limits."""
    stage = KEY_TILE[head_dim]
    errors, _, _ = _model_vs_pallas(length, head_dim, slice(stage, 2 * stage))
    for peak_err, rms_err in errors:
        assert peak_err > FLASH_TOL and rms_err > FLASH_RMS_TOL, (peak_err, rms_err)
