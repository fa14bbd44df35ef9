"""The port's CUDA kernels against their plain versions at small and ragged
shapes, on the card. Marked ``cuda``: each test skips where no CUDA device
is present. On a machine without JAX run it without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from multimodalanalytical_tpu_torch.ops import beam_attention as ba  # noqa: E402
from multimodalanalytical_tpu_torch.ops import decode_ffn  # noqa: E402
from multimodalanalytical_tpu_torch.ops import flash_attention as flash  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 2e-2   # of max(1, max|plain|), as chip_smoke.py
FLASH_TOL, FLASH_RMS_TOL = 2e-2, 1e-2   # chip_smoke.py's: of max|plain|; in norm


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("head_dim", [8, 64, 256])
@pytest.mark.parametrize("k", [1, 4])   # K 1: validation's greedy decode takes the kernel too
def test_select_attention_update_matches_plain(gen, quantized, head_dim, k):
    b, heads, length = 3, 2, 16
    d = heads * head_dim
    dev = "cuda"
    q = torch.randn(b * k, d, generator=gen, device=dev).bfloat16()
    anc_full = torch.randint(0, k, (b, k, 2 * length), generator=gen, device=dev,
                             dtype=torch.int32)
    if quantized:
        cache0 = torch.randint(-127, 128, (2, b, 2 * length * k, d), generator=gen,
                               device=dev, dtype=torch.int8)
        scales0 = torch.rand(2, b, heads, 128, generator=gen, device=dev)
        k_new, v_new = (torch.randint(-127, 128, (b * k, d), generator=gen, device=dev,
                                      dtype=torch.int8) for _ in range(2))
        k_s, v_s = (torch.rand(b * k, heads, generator=gen, device=dev) for _ in range(2))
    else:
        cache0 = torch.randn(2, b, 2 * length * k, d, generator=gen, device=dev).bfloat16()
        scales0, k_s, v_s = None, None, None
        k_new, v_new = (torch.randn(b * k, d, generator=gen, device=dev).bfloat16()
                        for _ in range(2))
    for pos in (0, 5, length - 1):
        anc_full[:, :, pos] = torch.arange(k, device=dev, dtype=torch.int32)
        anc = anc_full[:, :, :length]
        caches = [cache0.clone() for _ in range(2)]
        scales = [scales0.clone() if quantized else None for _ in range(2)]
        before = ba.beam_select_attention_update.launches
        got = ba.beam_select_attention_update(q, k_new, v_new, caches[0], anc, pos, heads,
                                              scales[0], k_s, v_s)
        assert ba.beam_select_attention_update.launches == before + 1
        want = ba.beam_select_attention_update_plain(q, k_new, v_new, caches[1], anc, pos,
                                                     heads, scales[1], k_s, v_s)
        _close(got, want)
        assert torch.equal(caches[0], caches[1])
        if quantized:
            assert torch.equal(scales[0], scales[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_attention_matches_plain(gen, dtype):
    b, k, heads, head_dim, ls = 3, 4, 2, 16, 11
    d = heads * head_dim
    q = torch.randn(b * k, d, generator=gen, device="cuda").to(dtype)
    kv = [torch.randn(b, ls, d, generator=gen, device="cuda").to(dtype) for _ in range(2)]
    keep = torch.rand(b, ls, generator=gen, device="cuda") < 0.8
    keep[:, 0] = True
    keep[2] = False
    bias = torch.where(keep, 0.0, -1e9).float()
    got = ba.beam_cross_attention(q, *kv, bias, heads, k)
    want = ba.beam_cross_attention_plain(q, *kv, bias, heads, k)
    assert got.dtype == dtype
    _close(got, want, TOL if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("gated", [False, True])
def test_geglu_ffn_ragged_matches_plain(gen, gated):
    m, d, f = 12, 16, 40     # no dimension a multiple of the 64 x 64 tile
    dev = "cuda"
    x = torch.randn(m, d, generator=gen, device=dev).bfloat16()
    w1, wg = (torch.randn(f, d, generator=gen, device=dev) * d ** -0.5 for _ in range(2))
    w2 = torch.randn(d, f, generator=gen, device=dev) * f ** -0.5
    b1, bg, b2 = (torch.randn(n, generator=gen, device=dev) * 0.1 for n in (f, f, d))
    args = (x, w1, b1, wg if gated else None, bg if gated else None, w2, b2)
    got = decode_ffn.geglu_ffn(*args)
    want = decode_ffn.geglu_ffn_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 0.02 * want.float().abs().max().item(), err


def test_wrappers_raise_on_unsupported_shapes(gen):
    x = torch.randn(8, 12, device="cuda").bfloat16()       # d_model 12: not a multiple of 8
    w = torch.randn(16, 12, device="cuda")
    with pytest.raises(ValueError):
        decode_ffn.geglu_ffn(x, w, torch.zeros(16, device="cuda"), None, None,
                             torch.randn(12, 16, device="cuda"), torch.zeros(12, device="cuda"))
    q = torch.randn(4, 12, device="cuda").bfloat16()
    kv = torch.randn(1, 3, 12, device="cuda").bfloat16()
    with pytest.raises(ValueError):
        ba.beam_cross_attention(q, kv, kv, torch.zeros(1, 3, device="cuda"), 2, 4)
    cache = torch.zeros(2, 1, 4 * 4, 12, device="cuda").bfloat16()
    anc = torch.zeros(1, 4, 4, device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError):
        ba.beam_select_attention(q.reshape(1, 4, 12), cache, anc, 0, 2)


def _padded_flash_inputs(gen, b, h, length, d, dtype, dead_row):
    """q, k, v and a (B, L) bias with a masked tail, padded to the 256-row
    blocks as ``flash_attention`` pads them; batch row ``dead_row`` has
    every key masked."""
    dev = "cuda"
    pad = (-length) % flash.BLK
    q, k, v = (torch.nn.functional.pad(
        torch.randn(b, h, length, d, generator=gen, device=dev).to(dtype), (0, 0, 0, pad))
        for _ in range(3))
    bias = torch.zeros(b, length, device=dev)
    bias[:, length - 37:] = flash.NEG_INF
    if dead_row is not None:
        bias[dead_row] = flash.NEG_INF
    return q, k, v, torch.nn.functional.pad(bias, (0, pad), value=flash.NEG_INF)


def _flash_close(got, want):
    """A bf16 flash result: max|got - want| within FLASH_TOL of max|want|
    and |got - want|_2 within FLASH_RMS_TOL of |want|_2, as chip_smoke.py."""
    diff = got.float() - want.float()
    err, peak = diff.abs().max().item(), want.float().abs().max().item()
    rms = (diff.norm() / want.float().norm()).item()
    assert err <= FLASH_TOL * peak and rms <= FLASH_RMS_TOL, (err, peak, rms)


def _rel_close(got, want, rtol):
    """Elementwise |got - want| <= rtol * max(1, |want|)."""
    err = ((got.float() - want.float()).abs() / want.float().abs().clamp_min(1.0)).max().item()
    assert err <= rtol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,length,dead_row", [
    (1, 1, 2048, None), (2, 3, 2100, 1), (1, 2, 2048, 0)])
def test_flash_kernels_match_plain(gen, dtype, b, h, length, dead_row):
    """Forward (out, lse) and backward (dq, dk, dv) kernels vs their plain
    versions on the same card tensors. fp32 results differ only in
    summation order (1e-4 of max(1, |value|)); bf16 ones also by the
    tensor cores' bf16 operands P and dS (``_flash_close``, as chip_smoke.py)."""
    q, k, v, bias = _padded_flash_inputs(gen, b, h, length, 64, dtype, dead_row)

    def close(got, want):
        return _close(got, want, 1e-4) if dtype == torch.float32 else _flash_close(got, want)
    before = (flash.flash_attention_fwd.launches, flash.flash_attention_bwd.launches)
    out, lse = flash.flash_attention_fwd(q, k, v, bias)
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, bias)
    assert out.dtype == dtype and lse.dtype == torch.float32
    close(out, want_out)
    _rel_close(lse, want_lse, 1e-5)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    grads = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    want = flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    torch.cuda.synchronize()
    for got, ref in zip(grads, want):
        assert got.dtype == dtype and ref.abs().max() > 0
        close(got, ref)
    assert (flash.flash_attention_fwd.launches, flash.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_flash_route_on_card_matches_cpu(gen):
    """``dot_product_attention`` at the flash gate on a CUDA tensor launches
    the forward kernel once and, under autograd, the backward once; output
    and gradients match the same call on the CPU (the plain versions)."""
    from multimodalanalytical_tpu_torch.ops.attention import dot_product_attention

    q, k, v = (torch.randn(2, 2, 2100, 64, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    keep = torch.ones(2, 2100, device="cuda")
    keep[1, 2000:] = 0
    bias = torch.where(keep > 0, 0.0, flash.NEG_INF)[:, None, None, :]
    weight = torch.randn(q.shape, generator=gen, device="cuda")
    results = []
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = (flash.flash_attention_fwd.launches, flash.flash_attention_bwd.launches)
        out = dot_product_attention(*leaves, bias.to(dev), use_flash=True)
        (out.float() * weight.to(dev)).sum().backward()
        after = (flash.flash_attention_fwd.launches, flash.flash_attention_bwd.launches)
        assert after == (before if dev == "cpu" else (before[0] + 1, before[1] + 1))
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(results[1], results[0]):
        _close(got, want, 2e-2)


@pytest.mark.parametrize("length,dead_row", [(2048, None), (2100, 1)])
def test_flash_kernels_match_plain_head_dim_128(gen, length, dead_row):
    """The head_dim-128 instantiation, bf16, ragged key mask: forward and
    backward vs the plain versions, as the head_dim-64 cases."""
    q, k, v, bias = _padded_flash_inputs(gen, 2, 2, length, 128, torch.bfloat16, dead_row)
    out, lse = flash.flash_attention_fwd(q, k, v, bias)
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, bias)
    _flash_close(out, want_out)
    _rel_close(lse, want_lse, 1e-5)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    grads = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    want = flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    torch.cuda.synchronize()
    for got, ref in zip(grads, want):
        assert ref.abs().max() > 0
        _flash_close(got, ref)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_flash_bf16_kernels_at_a_64_row_tail(gen, head_dim):
    """bf16 at L 2112, a multiple of 64 but not of 128, called directly (no
    256-row padding): the last 128-row block of every kernel has a 64-row
    tail. Forward and backward vs the plain versions; two backward calls
    give the same bits (no atomics)."""
    b, h, length = 2, 2, 2112
    q, k, v, dout = (torch.randn(b, h, length, head_dim, generator=gen, device="cuda").bfloat16()
                     for _ in range(4))
    bias = torch.zeros(b, length, device="cuda")
    bias[1, 2000:] = flash.NEG_INF
    out, lse = flash.flash_attention_fwd(q, k, v, bias)
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, bias)
    _flash_close(out, want_out)
    _rel_close(lse, want_lse, 1e-5)
    grads = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    again = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    want = flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    torch.cuda.synchronize()
    for got, rerun, ref in zip(grads, again, want):
        assert torch.equal(got, rerun)
        _flash_close(got, ref)


def test_flash_kernel_raises_on_unsupported_head_dim(gen):
    """head_dim 192 passes the JAX gate (a multiple of 64), but the kernels
    take 64 and 128 only: the wrapper raises."""
    q = torch.randn(1, 1, 2048, 192, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_fwd(q, q, q, torch.zeros(1, 2048, device="cuda"))


def _select_inputs(gen, b, k, heads, head_dim, length, quantized):
    dev = "cuda"
    d = heads * head_dim
    q = torch.randn(b, k, d, generator=gen, device=dev).bfloat16()
    anc = torch.randint(0, k, (b, k, length), generator=gen, device=dev, dtype=torch.int32)
    if quantized:
        cache = torch.randint(-127, 128, (2, b, length * k, d), generator=gen, device=dev,
                              dtype=torch.int8)
        scales = torch.rand(2, b, heads, length * k, generator=gen, device=dev) * 0.05 + 1e-3
    else:
        cache = torch.randn(2, b, length * k, d, generator=gen, device=dev).bfloat16()
        scales = None
    return q, cache, anc, scales


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b,k,heads,head_dim,length", [
    (3, 4, 2, 8, 16), (2, 30, 2, 64, 16), (4, 30, 8, 64, 128)])
def test_select_attention_read_only_matches_plain(gen, quantized, b, k, heads, head_dim,
                                                  length):
    """The read-only mode (ancestry[:, :, pos] drawn at random, as
    tests/test_beam30.py draws it) vs its plain version, K 4 and 30, the
    last case at the flagship decode widths (D 512, H 8, L 128); the cache
    and scales are left as they were."""
    q, cache, anc, scales = _select_inputs(gen, b, k, heads, head_dim, length, quantized)
    cache0 = cache.clone()
    for pos in (0, length // 2, length - 1):
        before = ba.beam_select_attention.launches
        got = ba.beam_select_attention(q, cache, anc, pos, heads, scales)
        assert ba.beam_select_attention.launches == before + 1
        want = ba.beam_select_attention_plain(q, cache, anc, pos, heads, scales)
        assert got.shape == (b, k, heads * head_dim)
        _close(got, want)
    assert torch.equal(cache, cache0)


@pytest.mark.parametrize("quantized", [False, True])
def test_select_attention_update_at_beam30(gen, quantized):
    """The update kernel at K 30 and the flagship decode widths (D 512, H 8,
    L 128): output, appended rows and scales vs the plain version."""
    b, k, heads, length = 4, 30, 8, 128
    q, cache0, anc, scales0 = _select_inputs(gen, b, k, heads, 64, length, quantized)
    q = q.reshape(b * k, -1)
    if quantized:
        k_new, v_new = (torch.randint(-127, 128, q.shape, generator=gen, device="cuda",
                                      dtype=torch.int8) for _ in range(2))
        k_s, v_s = (torch.rand(b * k, heads, generator=gen, device="cuda") for _ in range(2))
    else:
        k_new, v_new = (torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
                        for _ in range(2))
        k_s = v_s = None
    for pos in (0, 77, length - 1):
        anc[:, :, pos] = torch.arange(k, device="cuda", dtype=torch.int32)
        caches = [cache0.clone() for _ in range(2)]
        scales = [scales0.clone() if quantized else None for _ in range(2)]
        got = ba.beam_select_attention_update(q, k_new, v_new, caches[0], anc, pos, heads,
                                              scales[0], k_s, v_s)
        want = ba.beam_select_attention_update_plain(q, k_new, v_new, caches[1], anc, pos,
                                                     heads, scales[1], k_s, v_s)
        _close(got, want)
        assert torch.equal(caches[0], caches[1])
        if quantized:
            assert torch.equal(scales[0], scales[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,rate", [((1001,), 0.1), ((3, 37, 129), 0.5), ((64, 512), 0.0)])
def test_fused_dropout_bit_equal_to_plain(gen, dtype, shape, rate):
    """Kernel vs plain version, forward and (through autograd) backward: bit
    for bit, on ragged element counts (not a multiple of 4) too; the
    gradient's mask is the forward's."""
    from multimodalanalytical_tpu_torch.ops import fused_dropout as fd

    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    x[x == 0] = 1.0          # a kept element is then non-zero
    seed = fd.draw_seed(gen, "cuda")
    before = fd.fused_dropout.launches
    got = fd.fused_dropout(x, seed, rate)
    assert fd.fused_dropout.launches == before + 1
    assert torch.equal(got, fd.fused_dropout_plain(x, seed, rate))
    leaf = x.detach().requires_grad_()
    out = fd.FusedDropoutFunction.apply(leaf, seed, rate)
    out.backward(torch.ones_like(out))
    assert torch.equal(out, got)
    assert torch.equal(leaf.grad != 0, got != 0) or rate == 0.0
    assert torch.equal(leaf.grad, fd.fused_dropout_plain(torch.ones_like(x), seed, rate))


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "bfloat16"])
def test_decode_steps_on_card_match_cpu(gen, kv_cache_dtype):
    """A small bf16 model decoded on the card (all three kernels) against
    the same weights on the CPU (their plain versions): teacher-forced
    logits within bf16 tolerance, and each kernel launched once per layer
    per step."""
    from multimodalanalytical_tpu_torch.generation.beam_search import decode_model
    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    data_config = {
        "Formula": {"type": "text", "vocab_size": 32, "target": False},
        "IR": {"type": "1D_patches", "target": False,
               "preprocessor_arguments": {"patch_size": 125}},
        "Smiles": {"type": "text", "vocab_size": 40, "target": True},
    }
    cfg = ModelConfig(d_model=128, encoder_layers=2, decoder_layers=2,
                      encoder_attention_heads=2, decoder_attention_heads=2,
                      encoder_ffn_dim=256, decoder_ffn_dim=256, vocab_size=40,
                      dtype="bfloat16", kv_cache_dtype=kv_cache_dtype)
    cpu = Seq2SeqModel(cfg, data_config, "Smiles", generator=torch.Generator().manual_seed(0))
    card = Seq2SeqModel(cfg, data_config, "Smiles", device="cuda")
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    batch, beams, steps = 3, 4, 6
    inputs = {"Formula": torch.randint(4, 32, (batch, 12), generator=g),
              "IR": torch.rand(batch, 14, 125, generator=g)}
    mask = torch.ones(batch, 26, dtype=torch.int32)
    mask[0, 8:12] = 0
    tokens = torch.randint(4, 40, (batch, beams, steps), generator=g)
    anc = torch.randint(0, beams, (batch, beams, 16), generator=g, dtype=torch.int32)
    counters = (ba.beam_select_attention_update, ba.beam_cross_attention,
                decode_ffn.geglu_ffn)
    logits = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        before = [fn.launches for fn in counters]
        with torch.no_grad():
            hidden = model.encode({k: v.to(dev) for k, v in inputs.items()}, mask.to(dev))
            dm = decode_model(model)
            cache = dm.init_beam_cache(batch, beams, 16, hidden,
                                       quantize=kv_cache_dtype == "int8")
            out = []
            for t in range(steps):
                a = anc.clone()
                a[:, :, t] = torch.arange(beams, dtype=torch.int32)
                out.append(dm.beam_decode_step(tokens[:, :, t].to(dev), t, cache,
                                               a.to(dev), mask.to(dev)).float().cpu())
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        assert launched == ([0, 0, 0] if dev == "cpu" else [cfg.decoder_layers * steps] * 3)
        logits.append(torch.stack(out))
    err = (logits[1] - logits[0]).abs().max().item()
    # bf16 products rounded in other places by cuBLAS and the CPU, carried
    # through 2 + 2 layers.
    assert err <= 5e-2 * max(1.0, logits[0].abs().max().item()), err
