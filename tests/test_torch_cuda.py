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


def _fresh_rows(gen, shape, rows):
    """This step's K/V rows as the projection gives them: bf16, or fp32 in
    an fp32 model (an int8 cache takes either; the update quantizes)."""
    dtype = torch.float32 if rows == "int8-fp32" else torch.bfloat16
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2)]


def _check_update(q, cache0, scales0, anc_full, k_new, v_new, heads, length, positions):
    """Update kernel vs plain version at each position: output within TOL,
    the appended rows and scales bit-equal (the plain version quantizes
    with quantize_kv_heads on the card)."""
    beams = anc_full.shape[1]
    for pos in positions:
        anc_full[:, :, pos] = torch.arange(beams, device="cuda", dtype=torch.int32)
        anc = anc_full[:, :, :length]
        caches = [cache0.clone() for _ in range(2)]
        scales = [None if scales0 is None else scales0.clone() for _ in range(2)]
        before = ba.beam_select_attention_update.launches
        got = ba.beam_select_attention_update(q, k_new, v_new, caches[0], anc, pos, heads,
                                              scales[0])
        assert ba.beam_select_attention_update.launches == before + 1
        want = ba.beam_select_attention_update_plain(q, k_new, v_new, caches[1], anc, pos,
                                                     heads, scales[1])
        _close(got, want)
        assert torch.equal(caches[0], caches[1]), pos
        if scales0 is not None:
            assert torch.equal(scales[0], scales[1]), pos


@pytest.mark.parametrize("rows", ["bf16", "int8-bf16", "int8-fp32"])
@pytest.mark.parametrize("head_dim", [8, 64, 128, 256])
@pytest.mark.parametrize("k", [1, 4, 10, 30])   # K 1: validation's greedy decode takes it too
def test_select_attention_update_matches_plain(gen, rows, head_dim, k):
    """Stages of 16 and 37 times; positions 0, 5, 13 and the stage's last,
    most of them not a multiple of the kernel's times per tile."""
    b, heads = 3, 2
    d = heads * head_dim
    dev = "cuda"
    q = torch.randn(b * k, d, generator=gen, device=dev).bfloat16()
    anc_full = torch.randint(0, k, (b, k, 40), generator=gen, device=dev, dtype=torch.int32)
    if rows == "bf16":
        cache0 = torch.randn(2, b, 40 * k, d, generator=gen, device=dev).bfloat16()
        scales0 = None
    else:
        cache0 = torch.randint(-127, 128, (2, b, 40 * k, d), generator=gen, device=dev,
                               dtype=torch.int8)
        scales0 = torch.rand(2, b, heads, -(-40 * k // 128) * 128, generator=gen, device=dev)
    k_new, v_new = _fresh_rows(gen, (b * k, d), rows)
    assert ba.beam_kernel_supports(k, d, heads)
    for length in (16, 37):
        _check_update(q, cache0, scales0, anc_full, k_new, v_new, heads, length,
                      (0, 5, 13, length - 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,heads,head_dim,ls", [
    (4, 2, 16, 11), (1, 8, 64, 26), (10, 8, 64, 26), (30, 8, 64, 26), (10, 2, 8, 300),
    (10, 2, 64, 2100), (30, 2, 128, 2048)])
def test_cross_attention_matches_plain(gen, dtype, k, heads, head_dim, ls):
    """One pass up to 256 keys (the flagship's Ls 26), the split form
    beyond (an RLE encoder's 2048-4090); batch row 2 is fully masked (the
    uniform average, as the plain version gives)."""
    b = 3
    d = heads * head_dim
    q = torch.randn(b * k, d, generator=gen, device="cuda").to(dtype)
    kv = [torch.randn(b, ls, d, generator=gen, device="cuda").to(dtype) for _ in range(2)]
    keep = torch.rand(b, ls, generator=gen, device="cuda") < 0.8
    keep[:, 0] = True
    keep[2] = False
    bias = torch.where(keep, 0.0, -1e9).float()
    before = ba.beam_cross_attention.launches
    got = ba.beam_cross_attention(q, *kv, bias, heads, k)
    assert ba.beam_cross_attention.launches == before + 1
    want = ba.beam_cross_attention_plain(q, *kv, bias, heads, k)
    assert got.dtype == dtype
    _close(got, want, TOL if dtype == torch.bfloat16 else 1e-5)


def _cross_rows(gen, b, k, ls, d, dtype, tile):
    """q, K, V and a bias over B rows: row 0 fully masked (batch padding),
    row 1 with every key of the first tile masked, row 2 with every key
    past the first tile masked, later rows ragged (whole tiles masked at
    their tails)."""
    q = torch.randn(b * k, d, generator=gen, device="cuda").to(dtype)
    kv = [torch.randn(b, ls, d, generator=gen, device="cuda").to(dtype) for _ in range(2)]
    keep = torch.rand(b, ls, generator=gen, device="cuda") < 0.6
    keep[0] = False
    keep[1, :tile] = False
    keep[1, min(tile, ls - 1)] = True
    keep[2, tile:] = False
    keep[2, 0] = True
    keep[3:, ls // 3:] = False
    return q, kv, torch.where(keep, 0.0, -1e9).float()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 10, 30])
@pytest.mark.parametrize("ls", [257, 271, 279, 300, 511, 1025, 2100, 4090])
def test_cross_attention_two_passes_with_masked_chunks(gen, dtype, k, ls):
    """The split form (its stats and value launches) past the one-pass
    limit: the multimodal recipe's Ls 279, an RLE encoder's 2100 and 4090,
    and lengths whose last tile holds 1-127 keys. Row 0 is fully masked,
    row 1 has its first tile masked, row 2 every tile past the first (their
    blocks skip), later rows ragged: all finite, within chip_smoke.py's
    max-error and error-norm limits of the plain version, and two calls
    bit-equal."""
    b, heads, head_dim = 5, 8, 64
    d = heads * head_dim
    plan = ba.cross_plan(b, k, heads, head_dim, ls, 2 if dtype == torch.bfloat16 else 4)
    assert plan.workspace_bytes > 0
    q, kv, bias = _cross_rows(gen, b, k, ls, d, dtype, plan.tile_keys)
    got = ba.beam_cross_attention(q, *kv, bias, heads, k)
    again = ba.beam_cross_attention(q, *kv, bias, heads, k)
    want = ba.beam_cross_attention_plain(q, *kv, bias, heads, k)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, again)
    _close(got, want, TOL if dtype == torch.bfloat16 else 1e-5)
    rms = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rms <= (1e-3 if dtype == torch.bfloat16 else 1e-6), rms


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("batch,beams,heads,head_dim,ls", [
    (128, 10, 8, 64, 26), (128, 1, 8, 64, 279), (128, 10, 8, 64, 279), (128, 30, 8, 64, 279),
    (128, 10, 8, 64, 4090), (128, 30, 8, 64, 4090), (3, 4, 2, 128, 2100), (2, 128, 8, 64, 300),
    (2, 256, 16, 32, 600), (1, 32, 4, 256, 1025), (4, 10, 8, 64, 256), (4, 10, 8, 64, 257)])
def test_cross_plan_covers_every_key_once(gen, elt, batch, beams, heads, head_dim, ls):
    """The C side's plan: its tiles cover the Ls keys once (a last tile of
    1-tile_keys keys), in multiples of 16 keys; one pass without workspace
    up to 256 keys, the split form with workspace past them."""
    plan = ba.cross_plan(batch, beams, heads, head_dim, ls, elt)
    tiles = -(-ls // plan.tile_keys)
    assert plan.tile_keys % 16 == 0 and (tiles - 1) * plan.tile_keys < ls <= tiles * plan.tile_keys
    assert (tiles == 1 and plan.workspace_bytes == 0) if ls <= 256 else (
        tiles > 1 and plan.workspace_bytes > 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_attention_skips_padded_tails(gen, dtype):
    """Rows of 600, 130, 0 and 10 valid keys at Ls 600: the split form's
    padded tails (whole tiles of -1e9 keys, skipped) add nothing, the
    fully masked row gives the uniform average, and a call on the same
    inputs with the first tile masked differs (a left-out tile shows)."""
    b, k, heads, head_dim, ls = 4, 3, 2, 64, 600
    d = heads * head_dim
    q = torch.randn(b * k, d, generator=gen, device="cuda").to(dtype)
    kv = [torch.randn(b, ls, d, generator=gen, device="cuda").to(dtype) for _ in range(2)]
    lengths = torch.tensor([[600], [130], [0], [10]], device="cuda")
    bias = torch.where(torch.arange(ls, device="cuda")[None, :] < lengths, 0.0, -1e9).float()
    tol = TOL if dtype == torch.bfloat16 else 1e-5
    got = ba.beam_cross_attention(q, *kv, bias, heads, k)
    want = ba.beam_cross_attention_plain(q, *kv, bias, heads, k)
    _close(got, want, tol)
    uniform = kv[1][2].float().mean(0)
    _close(got[2 * k:3 * k].float(), uniform.expand(k, d), tol)
    cut = bias.clone()
    cut[:, :ba.cross_plan(b, k, heads, head_dim, ls, q.element_size()).tile_keys] = -1e9
    dropped = ba.beam_cross_attention(q, *kv, cut, heads, k)
    assert (dropped.float() - want.float()).abs().max().item() > 10 * tol


@pytest.mark.parametrize("ls", [279, 4090])
def test_cross_attention_replays_in_a_cuda_graph(gen, ls):
    """#2 captured in a CUDA graph (its workspace from the graph's pool) and
    replayed on new inputs copied into the captured ones: equal to the eager
    call on those inputs, bit for bit."""
    b, k, heads, head_dim = 4, 10, 8, 64
    d = heads * head_dim
    q, kv, bias = _cross_rows(gen, b, k, ls, d, torch.bfloat16, 128)
    static = [q.clone(), kv[0].clone(), kv[1].clone(), bias.clone()]
    ba.beam_cross_attention(*static[:3], static[3], heads, k)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ba.beam_cross_attention(*static[:3], static[3], heads, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ba.beam_cross_attention(*static[:3], static[3], heads, k)
    for seed in (1, 2):
        gen.manual_seed(seed)
        q2, kv2, bias2 = _cross_rows(gen, b, k, ls, d, torch.bfloat16, 64 * seed)
        for dst, src in zip(static, [q2, *kv2, bias2]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, ba.beam_cross_attention(q2, *kv2, bias2, heads, k))


def _ffn_args(gen, m, d, f, gated, dtype=torch.float32):
    dev = "cuda"
    x = torch.randn(m, d, generator=gen, device=dev).bfloat16()
    w1, wg = ((torch.randn(f, d, generator=gen, device=dev) * d ** -0.5).to(dtype)
              for _ in range(2))
    w2 = (torch.randn(d, f, generator=gen, device=dev) * f ** -0.5).to(dtype)
    b1, bg, b2 = ((torch.randn(n, generator=gen, device=dev) * 0.1).to(dtype) for n in (f, f, d))
    return x, w1, b1, wg if gated else None, bg if gated else None, w2, b2


def _ffn_close(got, want):
    """chip_smoke.py's FFN_REL_TOL (of max|plain|) and FFN_RMS_TOL (in norm)."""
    diff = got.float() - want.float()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    rel = diff.abs().max().item() / want.float().abs().max().item()
    rms = (diff.norm() / want.float().norm()).item()
    assert rel <= 0.02 and rms <= 1e-2, (rel, rms)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("m,d,f", [
    (12, 16, 40),           # no dimension a multiple of the 64 x 128 tile or 64-deep stage
    (1, 136, 200), (129, 520, 2056), (1281, 520, 2056), (3841, 136, 200)])
def test_geglu_ffn_ragged_matches_plain(gen, gated, m, d, f):
    """Ragged M (one row; a tail past each 64-row tile), D and F multiples of
    8 but not of 64, at the split count the plan picks."""
    args = _ffn_args(gen, m, d, f, gated)
    before = decode_ffn.geglu_ffn.launches
    got = decode_ffn.geglu_ffn(*args)
    assert decode_ffn.geglu_ffn.launches == before + 1
    _ffn_close(got, decode_ffn.geglu_ffn_plain(*args))


@pytest.mark.parametrize("splits", range(1, 33))
def test_geglu_ffn_every_split_count(gen, splits):
    """Each split count the plan can pick at the flagship widths (D 512, F
    2048: 1 to 32 splits of F), with either down-tile width, at M 128 and a
    ragged M of 200."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    picks = {decode_ffn.ffn_plan(m, 512, 2048, s).splits for m in range(1, 5000, 37)
             for s in (sms, 132)}
    assert picks <= set(range(1, 33))
    for m in (128, 200):
        args = _ffn_args(gen, m, 512, 2048, gated=False, dtype=torch.bfloat16)
        want = decode_ffn.geglu_ffn_plain(*args)
        for down_tile_n in (64, 128):
            plan = decode_ffn.FfnPlan(1, down_tile_n, splits)
            _ffn_close(decode_ffn._launch(*args, plan=plan), want)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("up_groups,down_tile_n", [(1, 64), (1, 128), (2, 64), (2, 128)])
def test_geglu_ffn_every_plan_layout(gen, gated, up_groups, down_tile_n):
    """Both up-GEMM schedules (one group; two taking turns) and both
    down-tile widths, at ragged M (a lone tile, a tail past a 64-row tile,
    more tiles than SMs) and ragged D / F, one split and several."""
    for m, d, f in ((1, 136, 200), (129, 520, 2056), (1281, 520, 2056)):
        args = _ffn_args(gen, m, d, f, gated)
        want = decode_ffn.geglu_ffn_plain(*args)
        for splits in (1, 3):
            plan = decode_ffn.FfnPlan(up_groups, down_tile_n, splits)
            _ffn_close(decode_ffn._launch(*args, plan=plan), want)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("m,d,f", [(12, 16, 40), (128, 512, 1024), (1280, 512, 1024),
                                   (1281, 520, 2056)])
def test_geglu_ffn_partial_mode_matches_plain(gen, gated, m, d, f):
    """Partial mode (fp32 down product without b2, as a tensor-parallel rank
    takes it) vs the plain version's partial mode, at one split and at
    several, within the full mode's tolerances of max|plain| and in norm;
    two calls bit-equal."""
    x, w1, b1, wg, bg, w2, _ = _ffn_args(gen, m, d, f, gated, dtype=torch.bfloat16)
    args = (x, w1, b1, wg, bg, w2, None)
    want = decode_ffn.geglu_ffn_plain(*args, partial=True)
    for splits in sorted({min(3, -(-f // 64)), 1, decode_ffn.ffn_plan(m, d, f, 132).splits}):
        plan = decode_ffn.FfnPlan(1, 128, splits)
        got = decode_ffn._launch(*args, plan=plan, partial=True)
        assert got.dtype == torch.float32 and got.shape == (m, d)
        assert torch.equal(got, decode_ffn._launch(*args, plan=plan, partial=True))
        diff = got - want
        assert diff.abs().max().item() <= 0.02 * want.abs().max().item()
        assert (diff.norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("m", [128, 1280, 3840])
def test_geglu_ffn_reruns_are_bit_identical(gen, gated, m):
    """At the decode M (9, 2 and 1 split(s) of F on an H100): the split
    partials are added in a fixed order, so two calls give the same bits."""
    args = _ffn_args(gen, m, 512, 2048, gated, dtype=torch.bfloat16)
    first = decode_ffn.geglu_ffn(*args)
    assert torch.equal(first, decode_ffn.geglu_ffn(*args))
    _ffn_close(first, decode_ffn.geglu_ffn_plain(*args))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("m", [128, 1280])
def test_geglu_ffn_graph_capture_equals_eager(gen, gated, m):
    """A call captured in a CUDA graph (as a captured decode step would take
    it) and replayed gives the eager call's bits."""
    args = _ffn_args(gen, m, 512, 2048, gated, dtype=torch.bfloat16)
    eager = decode_ffn.geglu_ffn(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_ffn.geglu_ffn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_ffn.geglu_ffn(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


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


@pytest.mark.parametrize("head_dim", [64, 128, 192, 256])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,heads,length,dead_row", [
    (192, 2, 2048, None), (192, 1, 2100, 0), (256, 2, 2048, 1), (256, 1, 2100, None)])
def test_flash_kernels_match_plain_wide_heads(gen, dtype, head_dim, heads, length, dead_row):
    """The head_dim-192 and -256 instantiations (their own shared-memory and
    register plans, dK and dV in two launches): forward and backward vs the
    plain versions, as the head_dim-64 cases."""
    q, k, v, bias = _padded_flash_inputs(gen, 2, heads, length, head_dim, dtype, dead_row)

    def close(got, want):
        return _close(got, want, 1e-4) if dtype == torch.float32 else _flash_close(got, want)
    out, lse = flash.flash_attention_fwd(q, k, v, bias)
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, bias)
    close(out, want_out)
    _rel_close(lse, want_lse, 1e-5)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    grads = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    want = flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    torch.cuda.synchronize()
    for got, ref in zip(grads, want):
        assert ref.abs().max() > 0
        close(got, ref)


def test_flash_kernel_raises_on_unsupported_head_dim(gen):
    """head_dim 320 passes the JAX gate (a multiple of 64), but the kernels
    take 64, 128, 192 and 256 only: the wrapper raises."""
    q = torch.randn(1, 1, 2048, 320, generator=gen, device="cuda")
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
    (3, 4, 2, 8, 16), (2, 30, 2, 64, 16), (4, 30, 8, 64, 128), (3, 1, 2, 64, 37),
    (3, 10, 2, 128, 37)])
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


@pytest.mark.parametrize("rows", ["bf16", "int8-bf16"])
def test_select_attention_update_at_beam30(gen, rows):
    """The update kernel at K 30 and the flagship decode widths (D 512, H 8,
    L 128): output, appended rows and scales vs the plain version."""
    b, k, heads, length = 4, 30, 8, 128
    q, cache0, anc, scales0 = _select_inputs(gen, b, k, heads, 64, length, rows != "bf16")
    q = q.reshape(b * k, -1)
    k_new, v_new = _fresh_rows(gen, q.shape, rows)
    _check_update(q, cache0, scales0, anc, k_new, v_new, heads, length, (0, 77, length - 1))


@pytest.mark.parametrize("rows", ["bf16", "int8-fp32"])
@pytest.mark.parametrize("head_dim,length", [(64, 300), (256, 600), (32, 200)])
def test_select_attention_at_the_gates_largest_plan(gen, rows, head_dim, length):
    """The largest K the gate admits at head_dim 64, 256 and 32 (K x
    head_dim 8192), at stages long enough that the per-time tables leave
    shared memory for the global workspace: update and read-only modes vs
    their plain versions at a middle and the last position; one beam more
    is refused."""
    heads = 2
    d = heads * head_dim
    k = max(n for n in range(1, 257) if ba.beam_kernel_supports(n, d, heads))
    assert k * head_dim == 8192 and not ba.beam_kernel_supports(k + 1, d, heads)
    q, cache0, anc, scales0 = _select_inputs(gen, 2, k, heads, head_dim, length, rows != "bf16")
    k_new, v_new = _fresh_rows(gen, (2 * k, d), rows)
    _check_update(q.reshape(2 * k, -1), cache0, scales0, anc, k_new, v_new, heads, length,
                  (length // 2, length - 1))
    got = ba.beam_select_attention(q, cache0, anc, length - 1, heads, scales0)
    _close(got, ba.beam_select_attention_plain(q, cache0, anc, length - 1, heads, scales0))
    big = torch.zeros(2, 1, length * (k + 1), d, device="cuda", dtype=cache0.dtype)
    with pytest.raises(ValueError, match="unsupported shape"):
        ba.beam_select_attention(torch.zeros(1, k + 1, d, device="cuda").bfloat16(), big,
                                 torch.zeros(1, k + 1, length, device="cuda", dtype=torch.int32),
                                 0, heads, None if scales0 is None else torch.zeros(
                                     2, 1, heads, length * (k + 1), device="cuda"))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_self_attention_beyond_the_shared_memory_stage(gen, kind):
    """A decode layer at K 30, D 512, H 8 on a 640-time stage, past the
    ~520 times whose tables fit in shared memory: on the card the layer
    launches the update kernel (which moves its tables to a workspace that
    the wrapper allocates) and agrees with the same layer on the CPU. A
    stage beyond the kernel's 65536 (time, slot) rows is refused by the
    wrapper's check of the stage, before any launch."""
    import copy

    from multimodalanalytical_tpu_torch.ops.attention import MultiHeadAttention

    b, k, d, heads, length, pos = 2, 30, 512, 8, 640, 600
    cpu = MultiHeadAttention(heads, d, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    x = torch.randn(b * k, d, generator=gen, device="cuda").bfloat16()
    anc = torch.randint(0, k, (b, k, length), generator=gen, device="cuda", dtype=torch.int32)
    anc[:, :, pos] = torch.arange(k, device="cuda", dtype=torch.int32)

    def cache(dev, steps):
        if kind == "bf16":
            return torch.randn(2, b, steps * k, d, generator=gen, device="cuda").bfloat16().to(dev)
        return {"data": torch.randint(-127, 128, (2, b, steps * k, d), generator=gen,
                                      device="cuda", dtype=torch.int8).to(dev),
                "scale": (torch.rand(2, b, heads, steps * k, generator=gen, device="cuda")
                          * 0.05 + 1e-3).to(dev)}

    store = cache("cuda", length)
    store_cpu = ({n: t.cpu() for n, t in store.items()} if kind == "int8" else store.cpu())
    before = ba.beam_select_attention_update.launches
    got = card.beam_decode_self_attention(x, store, anc, pos)
    assert ba.beam_select_attention_update.launches == before + 1
    want = cpu.beam_decode_self_attention(x.cpu(), store_cpu, anc.cpu(), pos)
    _close(got.cpu(), want, 5e-2)   # bf16 projections rounded by cuBLAS and by the CPU
    steps = 65536 // k + 1
    with pytest.raises(ValueError, match="stage longer than the cache"):
        card.beam_decode_self_attention(
            x, cache("cuda", steps),
            torch.zeros(b, k, steps, device="cuda", dtype=torch.int32), steps - 1)


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
            cache = dm.init_beam_cache(batch, beams, 16, hidden, mask.to(dev),
                                       quantize=kv_cache_dtype == "int8")
            out = []
            for t in range(steps):
                a = anc.clone()
                a[:, :, t] = torch.arange(beams, dtype=torch.int32)
                out.append(dm.beam_decode_step(tokens[:, :, t].to(dev), t, cache,
                                               a.to(dev)).float().cpu())
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        assert launched == ([0, 0, 0] if dev == "cpu" else [cfg.decoder_layers * steps] * 3)
        logits.append(torch.stack(out))
    err = (logits[1] - logits[0]).abs().max().item()
    # bf16 products rounded in other places by cuBLAS and the CPU, carried
    # through 2 + 2 layers.
    assert err <= 5e-2 * max(1.0, logits[0].abs().max().item()), err


@pytest.mark.parametrize("rows", ["bf16", "int8-bf16"])
@pytest.mark.parametrize("k", [1, 10, 30])
def test_select_kernel_reads_the_position_from_the_device(gen, rows, k):
    """One 128-time stage, positions 0, 33, 96 and 127 given as a 0-d int32
    tensor on the card: the update and the read-only kernels give the bits
    of the int-position call (the same launch, its position filled on the
    card) and agree with their plain versions."""
    b, heads, length = 3, 8, 128
    q, cache0, anc, scales0 = _select_inputs(gen, b, k, heads, 64, length, rows != "bf16")
    k_new, v_new = _fresh_rows(gen, (b * k, heads * 64), rows)
    for pos in (0, 33, 96, 127):
        anc[:, :, pos] = torch.arange(k, device="cuda", dtype=torch.int32)
        device_pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
        outs, stores = [], []
        for position in (device_pos, pos):
            cache = cache0.clone()
            scales = None if scales0 is None else scales0.clone()
            outs.append(ba.beam_select_attention_update(q.reshape(b * k, -1), k_new, v_new,
                                                        cache, anc, position, heads, scales))
            stores.append((cache, scales))
        assert torch.equal(outs[0], outs[1]) and torch.equal(stores[0][0], stores[1][0])
        cache = cache0.clone()
        scales = None if scales0 is None else scales0.clone()
        want = ba.beam_select_attention_update_plain(q.reshape(b * k, -1), k_new, v_new, cache,
                                                     anc, pos, heads, scales)
        _close(outs[0], want)
        read = ba.beam_select_attention(q, cache0, anc, device_pos, heads, scales0)
        assert torch.equal(read, ba.beam_select_attention(q, cache0, anc, pos, heads, scales0))
        _close(read, ba.beam_select_attention_plain(q, cache0, anc, pos, heads, scales0))
    bad = torch.tensor(length, dtype=torch.int32, device="cuda")   # outside the stage
    assert torch.isnan(ba.beam_select_attention(q, cache0, anc, bad, heads, scales0)).all()
    with pytest.raises(ValueError, match="0-d int32"):
        ba.beam_select_attention(q, cache0, anc, bad.long(), heads, scales0)


def _small_decode_model(kv_cache_dtype="int8", max_length=32, eos_bias=0.0):
    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    data_config = {
        "Formula": {"type": "text", "vocab_size": 32, "target": False},
        "IR": {"type": "1D_patches", "target": False,
               "preprocessor_arguments": {"patch_size": 125}},
        "Smiles": {"type": "text", "vocab_size": 64, "target": True},
    }
    cfg = ModelConfig(d_model=128, encoder_layers=2, decoder_layers=2,
                      encoder_attention_heads=2, decoder_attention_heads=2,
                      encoder_ffn_dim=256, decoder_ffn_dim=256, vocab_size=64,
                      dtype="bfloat16", kv_cache_dtype=kv_cache_dtype,
                      max_target_length=max_length)
    model = Seq2SeqModel(cfg, data_config, "Smiles", device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        model.lm_head.bias[cfg.eos_token_id] += eos_bias
    return model


def _request(batch, seed):
    g = torch.Generator().manual_seed(seed)
    inputs = {"Formula": torch.randint(4, 32, (batch, 12), generator=g).cuda(),
              "IR": torch.rand(batch, 14, 125, generator=g).cuda()}
    mask = torch.ones(batch, 26, dtype=torch.int32, device="cuda")
    mask[0, 8:12] = 0
    return inputs, mask


def test_replayed_step_equals_eager_steps(gen):
    """One stage's captured decode step replayed 8 times and the same step
    run eagerly 8 times from the same state: every state tensor bit-equal,
    and each replay adds to the launch counts what an eager step launches."""
    from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder

    model = _small_decode_model()
    decoder = BeamDecoder(model)
    inputs, mask = _request(3, 0)
    decoder.search(inputs, mask, 4, max_length=32, stage_size=None)
    (decode,) = decoder._decodes.values()
    graph, launches = decode.graphs[32]
    counters = (ba.beam_select_attention_update, ba.beam_cross_attention, decode_ffn.geglu_ffn)
    assert {fn: launches.get(fn) for fn in counters} == {fn: 2 for fn in counters}
    hidden = decoder.dmodel.encode(inputs, mask)
    states = []
    for replay in (True, False):
        decode.load(decoder.dmodel, hidden, mask, None)
        before = [fn.launches for fn in counters]
        for _ in range(8):
            if replay:
                graph.replay()
                for fn, count in launches.items():
                    fn.launches += count
            else:
                decoder._step(decode, 32, 32, 1.0, None)
        torch.cuda.synchronize()
        assert [fn.launches - n for fn, n in zip(counters, before)] == [16, 16, 16]
        states.append({k: v.clone() for k, v in decode.state.items() if k != "hook"})
    assert int(states[0]["t"]) == 8
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.parametrize("eos_bias", [0.0, 20.0])
def test_graph_decode_equals_eager_decode(gen, eos_bias):
    """Two requests through one decoder's graphs (captured once) against the
    same decoder with ``cuda_graph=False``: sequences and scores bit-equal,
    the same steps; with EOS favoured the decode exits early and the graphs
    stop within ``check_every`` replays of the exit."""
    from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder

    decoder = BeamDecoder(_small_decode_model(eos_bias=eos_bias))
    for seed in (1, 2):
        inputs, mask = _request(3, seed)
        got, want = {}, {}
        seqs, scores = decoder.search(inputs, mask, 4, max_length=32, stage_size=8, stats=got)
        eager_seqs, eager_scores = decoder.search(inputs, mask, 4, max_length=32, stage_size=8,
                                                  cuda_graph=False, stats=want)
        assert torch.equal(seqs, eager_seqs) and torch.equal(scores, eager_scores)
        assert got["graph"] and not want["graph"] and got["steps"] == want["steps"]
        assert got["warmup_steps"] == (4 if seed == 1 else 0)     # 4 stages of 8
        if eos_bias:
            assert got["steps"] < 31 and got["replays"] <= got["steps"] + 8
    assert len(decoder._decodes) == 1


def test_spilled_stage_decodes_under_capture(gen):
    """K 30 on a 576-time stage, past the ~520 times whose select tables fit
    in shared memory: the captured decode (the workspace a torch.empty of
    the step, no allocation of the kernel's own) equals the eager one."""
    from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder

    assert ba._workspace_bytes(1, 2, 30, 2, 64, 576) > 0
    decoder = BeamDecoder(_small_decode_model(max_length=576))
    inputs, mask = _request(2, 3)
    got, want = {}, {}
    seqs, scores = decoder.search(inputs, mask, 30, max_length=576, stage_size=None, stats=got)
    eager = decoder.search(inputs, mask, 30, max_length=576, stage_size=None, cuda_graph=False,
                           stats=want)
    assert got["graph"] and got["steps"] == want["steps"]
    assert torch.equal(seqs, eager[0]) and torch.equal(scores, eager[1])


def _small_multimodal_model():
    """Formula + Multiplets + Carbon + IR at the multimodal recipe's widths
    (Ls 12 + 189 + 54 + 24 = 279), a small kernel-eligible model."""
    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    data_config = {
        "Formula": {"type": "text", "vocab_size": 32, "target": False},
        "Multiplets": {"type": "multiplets", "vocab_size": 1400, "target": False},
        "Carbon": {"type": "carbon", "vocab_size": 2310, "target": False},
        "IR": {"type": "1D_patches", "target": False,
               "preprocessor_arguments": {"patch_size": 75}},
        "Smiles": {"type": "text", "vocab_size": 64, "target": True},
    }
    cfg = ModelConfig(d_model=128, encoder_layers=2, decoder_layers=2,
                      encoder_attention_heads=2, decoder_attention_heads=2,
                      encoder_ffn_dim=256, decoder_ffn_dim=256, vocab_size=64,
                      dtype="bfloat16", max_target_length=32)
    return Seq2SeqModel(cfg, data_config, "Smiles", device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))


def _multimodal_request(batch, seed, xval, carbon=54):
    g = torch.Generator().manual_seed(seed)
    widths = {"Formula": (12, 32), "Multiplets": (189, 1400), "Carbon": (carbon, 2310)}
    inputs, keeps = {}, []
    for name, (width, vocab) in widths.items():
        length = torch.randint(width // 4, width + 1, (batch, 1), generator=g)
        keep = torch.arange(width)[None, :] < length
        inputs[name] = torch.where(keep, torch.randint(4, vocab, (batch, width), generator=g), 0)
        keeps.append(keep)
    if xval:
        values = torch.where(keeps[1], 1.0 + 0.3 * torch.randn(batch, 189, generator=g), 1.0)
        inputs["Multiplets"] = {"tokenized_input": inputs["Multiplets"],
                                "numerical_values": values}
    inputs["IR"] = torch.rand(batch, 24, 75, generator=g)
    keeps.append(torch.ones(batch, 24, dtype=torch.bool))
    mask = torch.cat(keeps, dim=1).int()
    move = lambda x: {k: move(v) for k, v in x.items()} if isinstance(x, dict) else x.cuda()  # noqa: E731,E501
    return move(inputs), mask.cuda()


@pytest.mark.parametrize("xval", [False, True], ids=["ids", "xval"])
def test_multimodal_graph_decode_equals_eager_decode(gen, xval):
    """The multimodal recipe's encoder (Ls 279, the cross kernel's split
    form) through the serving engine's graphs against its eager loop: two
    requests, then one with a shorter carbon width (Ls 255, one pass) that
    the engine captures apart; sequences and scores bit-equal, each decode
    kernel launched 2 x the replays and capture steps."""
    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine

    engine = InferenceEngine(_small_multimodal_model(), n_beams=4, batch_size=3)
    counters = (ba.beam_select_attention_update, ba.beam_cross_attention, decode_ffn.geglu_ffn)
    for seed, carbon in ((1, 54), (2, 54), (3, 30)):
        inputs, mask = _multimodal_request(3, seed, xval, carbon)
        assert mask.shape[1] == 12 + 189 + carbon + 24
        before = [fn.launches for fn in counters]
        seqs, scores = engine.decode_batch(inputs, mask)
        stats = engine.last_stats
        assert stats["graph"]
        assert [fn.launches - n for fn, n in zip(counters, before)] == [
            2 * (stats["replays"] + stats["warmup_steps"])] * 3
        eager = engine.decoder.search(inputs, mask, 4, max_length=32, cuda_graph=False)
        assert (seqs == eager[0].cpu().numpy()).all() and (scores == eager[1].cpu().numpy()).all()
    assert len(engine.decoder._decodes) == 2


def test_validate_after_a_step_decodes_the_new_weights(gen):
    """Trainer: validate (captures the K 1 graphs), one optimizer step,
    validate again through the same graphs: the greedy decode equals an
    eager decode of the new weights, never the old ones."""
    import numpy as np

    from multimodalanalytical_tpu_torch.generation.beam_search import beam_search
    from multimodalanalytical_tpu_torch.training import Trainer

    class Tokenizer:
        pad_token_id, bos_token_id, eos_token_id = 0, 2, 3

        def batch_decode(self, ids, skip_special_tokens=True):
            return [" ".join(str(int(i)) for i in row) for row in np.asarray(ids)]

    model = _small_decode_model()
    inputs, mask = _request(4, 4)
    rng = np.random.default_rng(0)
    dec = rng.integers(4, 64, (4, 10))
    batch = {"encoder_inputs": {k: v.cpu().numpy() for k, v in inputs.items()},
             "encoder_mask": mask.cpu().numpy(), "decoder_ids": dec,
             "decoder_mask": np.ones_like(dec), "labels": dec, "target_strings": ["x"] * 4,
             "n_valid": 4}
    trainer = Trainer(model, Tokenizer(), optimiser="adamw", lr=5e-2, num_steps=10)
    decoded = []
    trainer._decode = lambda *a, _orig=trainer._decode, **kw: decoded.append(
        _orig(*a, **kw)) or decoded[-1]
    trainer.validate([batch])
    old, _ = beam_search(model, inputs, mask, 1, max_length=32, cuda_graph=False)
    trainer.train_step(batch)
    trainer.validate([batch])
    new, _ = beam_search(model, inputs, mask, 1, max_length=32, cuda_graph=False)
    assert trainer.decode_warmups == 1        # the K 1 graph was captured once
    assert torch.equal(decoded[1], new)
    assert not torch.equal(decoded[1], old)


def test_async_save_on_the_card_keeps_the_requested_state(gen, tmp_path):
    """``save_async`` of a card state: the snapshot on the main stream, the
    pinned copies on the manager's side stream. The saved file holds the
    state at the request, though an AdamW step updates it in place before
    the thread copies; the pipelined validate and predict equal depth 0."""
    import threading

    import numpy as np

    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training import trainer as trainer_module
    from multimodalanalytical_tpu_torch.training.checkpoint import CheckpointManager, to_cpu

    class Tokenizer:
        pad_token_id, bos_token_id, eos_token_id = 0, 2, 3

        def batch_decode(self, ids, skip_special_tokens=True):
            return [" ".join(str(int(i)) for i in row) for row in np.asarray(ids)]

    inputs, mask = _request(4, 4)
    rng = np.random.default_rng(0)
    dec = rng.integers(4, 64, (4, 10))
    batch = {"encoder_inputs": {k: v.cpu().numpy() for k, v in inputs.items()},
             "encoder_mask": mask.cpu().numpy(), "decoder_ids": dec,
             "decoder_mask": np.ones_like(dec), "labels": dec, "target_strings": ["x"] * 4,
             "n_valid": 4}
    trainer = Trainer(_small_decode_model(), Tokenizer(), optimiser="adamw", lr=5e-2,
                      num_steps=10)
    trainer.train_step(batch)
    mgr = CheckpointManager(tmp_path / "ck")
    stepped, write = threading.Event(), mgr._write
    mgr._write = lambda *args: stepped.wait(30.0) and write(*args)
    requested = to_cpu(trainer.state_tree())
    trainer._save_state(mgr, {})
    trainer.train_step(batch)
    stepped.set()
    assert mgr.wait(timeout_s=30.0)
    saved = mgr.restore("last")
    for name, value in requested["params"].items():
        assert torch.equal(saved["params"][name], value), name
    for got, want in zip(saved["opt_state"]["nu"], requested["opt_state"]["nu"]):
        assert torch.equal(got, want)
    assert not torch.equal(saved["params"]["lm_head.weight"],
                           trainer.model.state_dict()["lm_head.weight"].cpu())
    results = {}
    for depth in (0, 8):
        trainer_module.PIPELINE_DEPTH = depth
        try:
            results[depth] = (trainer.validate([batch] * 3), trainer.predict([batch] * 3, 4))
        finally:
            trainer_module.PIPELINE_DEPTH = 8
    assert results[0] == results[8]


def test_async_saves_on_the_card_reuse_the_managers_pinned_buffers(gen, tmp_path):
    """Requests to one manager share two sets of pinned buffers: one being
    written, one queued; a replaced request hands its set to the next, and
    a written one gives its set back. Every file holds its own request's
    state."""
    import threading
    import time

    from multimodalanalytical_tpu_torch.training.checkpoint import CheckpointManager

    mgr = CheckpointManager(tmp_path / "ck")
    release, write = threading.Event(), mgr._write
    mgr._write = lambda *args: release.wait(30.0) and write(*args)
    sets = []
    start = mgr._start_host_copy

    def recording(snap):
        out = start(snap)
        sets.append(tuple(b.data_ptr() for b in out[2]))
        return out

    mgr._start_host_copy = recording
    w = torch.zeros(1024, 256, device="cuda")
    for step in range(4):   # 0 is written; 1 and 2 are replaced by 3
        w.fill_(step)
        mgr.save_async(step, {"w": w, "step": step}, {})
        if step == 0:
            while not mgr._busy:
                time.sleep(0.01)
    release.set()
    assert mgr.wait(timeout_s=30.0)
    assert sets[0] != sets[1] and sets[1] == sets[2] == sets[3]
    saved = mgr.restore("last")
    assert saved["step"] == 3 and torch.equal(saved["w"], torch.full((1024, 256), 3.0))
    w.fill_(4)
    mgr.save_async(4, {"w": w, "step": 4}, {})
    assert mgr.wait(timeout_s=30.0)
    assert sets[4] in (sets[0], sets[3]) and len(set(sets)) == 2
    assert torch.equal(mgr.restore("last")["w"], torch.full((1024, 256), 4.0))


def _small_preset_model(model_type, device, d_model=128, heads=2, max_length=32, **extra):
    """A small bf16 model of a BART / T5 preset (post-LN BART without final
    norms, or T5: RMSNorm, relative bias, no scale, ReLU without biases)."""
    from multimodalanalytical_tpu_torch.models.config import resolve_model_config
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    data_config = {
        "Formula": {"type": "text", "vocab_size": 32, "target": False},
        "IR": {"type": "1D_patches", "target": False,
               "preprocessor_arguments": {"patch_size": 125}},
        "Smiles": {"type": "text", "vocab_size": 64, "target": True},
    }
    cfg = resolve_model_config(
        {"model_type": model_type, "d_model": d_model, "encoder_layers": 2,
         "decoder_layers": 2, "encoder_attention_heads": heads,
         "decoder_attention_heads": heads, "encoder_ffn_dim": 2 * d_model,
         "decoder_ffn_dim": 2 * d_model, "dtype": "bfloat16",
         "max_target_length": max_length, **extra},
        vocab_size=64, pad_token_id=0, bos_token_id=2, eos_token_id=3)
    return Seq2SeqModel(cfg, data_config, "Smiles", device=device,
                        generator=torch.Generator(device=device).manual_seed(0))


@pytest.mark.parametrize("beams,stage_size", [(4, 8), (10, None), (1, 8)])
def test_t5_plain_decode_under_capture_equals_eager(gen, beams, stage_size):
    """T5 decodes on the plain route (no scale, a relative bias): its
    captured steps (the buckets computed on the card from the device
    position, the cache rows written by index_copy_ at it) equal the eager
    loop bit for bit, and no decode kernel is launched."""
    from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder

    decoder = BeamDecoder(_small_preset_model("T5ForConditionalGeneration", "cuda"))
    counters = (ba.beam_select_attention_update, ba.beam_cross_attention, decode_ffn.geglu_ffn)
    before = [fn.launches for fn in counters]
    for seed in (1, 2):
        inputs, mask = _request(3, seed)
        got, want = {}, {}
        seqs, scores = decoder.search(inputs, mask, beams, max_length=32, stage_size=stage_size,
                                      stats=got)
        eager = decoder.search(inputs, mask, beams, max_length=32, stage_size=stage_size,
                               cuda_graph=False, stats=want)
        assert got["graph"] and got["steps"] == want["steps"]
        assert torch.equal(seqs, eager[0]) and torch.equal(scores, eager[1])
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("batch,beams,stage", [(3, 4, 16), (5, 10, 37), (2, 1, 13)])
def test_post_ln_bart_decode_steps_on_card_match_cpu(gen, kv_cache_dtype, batch, beams, stage):
    """hf_bart_medium's post-LN decode branch, small and ragged: the card
    launches #1-#3 once per layer per step and its teacher-forced logits
    match the same weights on the CPU (the kernels' plain versions) within
    the bf16 bound of test_decode_steps_on_card_match_cpu."""
    from multimodalanalytical_tpu_torch.generation.beam_search import decode_model

    cpu = _small_preset_model("BartForConditionalGeneration", "cpu",
                              kv_cache_dtype=kv_cache_dtype)
    assert not cpu.config.post_layer_normalisation and not cpu.config.final_layer_norm
    card = _small_preset_model("BartForConditionalGeneration", "cuda",
                               kv_cache_dtype=kv_cache_dtype)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(batch)
    inputs = {"Formula": torch.randint(4, 32, (batch, 12), generator=g),
              "IR": torch.rand(batch, 14, 125, generator=g)}
    mask = torch.ones(batch, 26, dtype=torch.int32)
    mask[0, 7:12] = 0
    steps = 6
    tokens = torch.randint(4, 64, (batch, beams, steps), generator=g)
    anc = torch.randint(0, beams, (batch, beams, stage), generator=g, dtype=torch.int32)
    counters = (ba.beam_select_attention_update, ba.beam_cross_attention, decode_ffn.geglu_ffn)
    quantize = kv_cache_dtype == "int8"
    logits = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        before = [fn.launches for fn in counters]
        with torch.no_grad():
            hidden = model.encode({k: v.to(dev) for k, v in inputs.items()}, mask.to(dev))
            dm = decode_model(model)
            cache = dm.init_beam_cache(batch, beams, stage, hidden, mask.to(dev), quantize)
            out = []
            for t in range(steps):
                a = anc.clone()
                a[:, :, t] = torch.arange(beams, dtype=torch.int32)
                out.append(dm.beam_decode_step(tokens[:, :, t].to(dev), t, cache,
                                               a.to(dev)).float().cpu())
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        assert launched == ([0, 0, 0] if dev == "cpu" else [2 * steps] * 3)
        logits.append(torch.stack(out))
    err = (logits[1] - logits[0]).abs().max().item()
    assert err <= 5e-2 * max(1.0, logits[0].abs().max().item()), err


def _premix_inputs(rows=40, batch=16, compounds=3, vocab=30, spec_len=1791):
    """A seeded pool and index batch for ``data/device_mixture.py``'s premix
    (no tokenizer: the pool's token rows are seeded ids), the last 3 rows
    padding; half the rows normalized."""
    import numpy as np

    from multimodalanalytical_tpu_torch.data import device_mixture as dm

    rng = np.random.default_rng(0)
    pool_ir = np.zeros((rows, dm.SPECTRUM_PAD_LENGTH), np.float32)
    pool_ir[:, :spec_len] = rng.random((rows, spec_len)) - 0.1
    lengths = rng.integers(3, 12, (2, rows))
    arrays = {"pool_ir": pool_ir}
    for name, width, length in (("formula", 12, lengths[0]), ("smiles", 16, lengths[1])):
        mask = (np.arange(width)[None] < length[:, None]).astype(np.int32)
        arrays[f"{name}_ids"] = (rng.integers(4, vocab, (rows, width)) * mask).astype(np.int32)
        arrays[f"{name}_mask"] = mask
    static = {"text_mod": "Formula", "patch_mod": "IR", "align": True, "spec_len": spec_len,
              "patch_size": 75, "mean": 0.4, "std": 0.3, "modality_order": ["Formula", "IR"]}
    loader = dm.DeviceMixtureLoader(rows, {"a": {"n_compounds": compounds}}, "train", 0, batch, 1)
    samples = [(rng.choice(rows, compounds, replace=False), int(rng.integers(compounds)),
                tuple(float(w) for w in rng.dirichlet(np.ones(compounds))), bool(i % 2))
               for i in range(batch - 3)]
    return dm.build_premix(static), arrays, loader._make_batch(samples, len(samples))


def test_premix_on_the_card_equals_the_cpu(gen):
    """The device-mixture premix of one index batch on the card and on the
    CPU: ids, masks and labels bit-equal, patches and the align target
    within 1e-6 of their largest magnitude."""
    from multimodalanalytical_tpu_torch.training.trainer import device_batch

    premix, arrays, index_batch = _premix_inputs()
    outs = [premix({k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
                   device_batch(index_batch, torch.device(device)))
            for device in ("cpu", "cuda")]
    cpu, card = outs
    for key in ("encoder_mask", "decoder_ids", "decoder_mask", "labels"):
        assert torch.equal(card[key].cpu(), cpu[key]), key
    assert torch.equal(card["encoder_inputs"]["Formula"].cpu(), cpu["encoder_inputs"]["Formula"])
    for got, want in ((card["encoder_inputs"]["IR"], cpu["encoder_inputs"]["IR"]),
                      (card["align_target"], cpu["align_target"])):
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), err


def test_world_one_nccl_step_is_bit_equal_to_no_group(gen, monkeypatch):
    """Two train steps (fp32, dropout 0) in a world-1 NCCL process group,
    joined through ``initialize_multihost`` from torchrun's environment as
    the CLIs join it, which sums the gradients over one rank by an
    ``all_reduce``, against the same steps with no group: losses, gradient
    norms and parameters bit-equal."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.parallel import initialize_multihost
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel
    from multimodalanalytical_tpu_torch.training import Trainer

    data_config = {
        "Formula": {"type": "text", "vocab_size": 32, "target": False},
        "IR": {"type": "1D_patches", "target": False,
               "preprocessor_arguments": {"patch_size": 125}},
        "Smiles": {"type": "text", "vocab_size": 64, "target": True},
    }
    cfg = ModelConfig(d_model=64, encoder_layers=1, decoder_layers=1,
                      encoder_attention_heads=2, decoder_attention_heads=2,
                      encoder_ffn_dim=128, decoder_ffn_dim=128, vocab_size=64,
                      dtype="float32", dropout=0.0)
    inputs, mask = _request(4, 1)
    dec = np.random.default_rng(1).integers(4, 64, (4, 10))
    labels = dec.copy()
    labels[1, 6:] = -100
    batch = {"encoder_inputs": {k: v.cpu().numpy() for k, v in inputs.items()},
             "encoder_mask": mask.cpu().numpy(), "decoder_ids": dec,
             "decoder_mask": (labels != -100).astype(np.int32), "labels": labels}

    def run():
        model = Seq2SeqModel(cfg, data_config, "Smiles", device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
        trainer = Trainer(model, optimiser="adamw", lr=1e-3, num_steps=10)
        steps = [trainer.train_step(batch) for _ in range(2)]
        return ([{k: v.item() for k, v in s.items()} for s in steps],
                [p.detach().clone() for p in model.parameters()])

    alone = run()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(AFM_MULTIHOST="1", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    assert initialize_multihost(torch.device("cuda")) == torch.device("cuda", 0)
    assert dist.get_backend() == "nccl"
    try:
        grouped = run()
    finally:
        dist.destroy_process_group()
    assert grouped[0] == alone[0]
    assert all(torch.equal(a, b) for a, b in zip(grouped[1], alone[1]))


# ------------------------------------------------------ the train step's graph
TRAIN_DATA_CONFIG = {
    "Formula": {"type": "text", "vocab_size": 32, "target": False},
    "IR": {"type": "1D_patches", "target": False,
           "preprocessor_arguments": {"patch_size": 125}},
    "Smiles": {"type": "text", "vocab_size": 64, "target": True},
}
RLE_TRAIN_CONFIG = {
    "RLE": {"type": "run_length_encoding", "vocab_size": 105, "target": False},
    "Smiles": {"type": "text", "vocab_size": 64, "target": True},
}
MIX_TRAIN_CONFIG = {
    "Formula": {"type": "text", "vocab_size": 30, "target": False},
    "IR": {"type": "1D_patches", "target": False,
           "preprocessor_arguments": {"patch_size": 75}},
    "Smiles": {"type": "text", "vocab_size": 30, "target": True},
}
GRAPH_STEPS = 5


def _train_model(data_config, dropout=0.1, dtype="float32", use_flash=False, vocab=64):
    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    cfg = ModelConfig(d_model=128, encoder_layers=2, decoder_layers=2,
                      encoder_attention_heads=2, decoder_attention_heads=2,
                      encoder_ffn_dim=256, decoder_ffn_dim=256, vocab_size=vocab, dtype=dtype,
                      dropout=dropout, use_flash_attention=use_flash,
                      max_position_embeddings=4096)
    return Seq2SeqModel(cfg, data_config, "Smiles", device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))


def _train_batch(seed, rows=4, source=None, vocab=64):
    """A host batch of the Formula + IR recipe (or ``source``: modality ->
    (ids, mask) of a long source), targets of 10 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if source is None:
        inputs = {"Formula": rng.integers(4, 32, (rows, 12)),
                  "IR": rng.random((rows, 14, 125)).astype(np.float32)}
        mask = np.ones((rows, 26), np.int32)
        mask[0, 8:12] = 0
    else:
        inputs, mask = source
    dec = rng.integers(4, vocab, (rows, 10))
    labels = dec.copy()
    labels[1, 6:] = -100
    return {"encoder_inputs": inputs, "encoder_mask": mask, "decoder_ids": dec,
            "decoder_mask": (labels != -100).astype(np.int32), "labels": labels}


def _rle_source(rows=2, length=2100):
    import numpy as np

    rng = np.random.default_rng(5)
    mask = (np.arange(length)[None] < np.array([length, length - 77])[:rows, None])
    ids = np.where(mask, rng.integers(4, 105, (rows, length)), 0)
    return {"RLE": ids}, mask.astype(np.int32)


def _train_state(trainer):
    opt = trainer.optimizer
    return [t.detach().clone() for t in trainer.params + opt.mu + opt.nu]


def _steps(trainer, batches, steps=GRAPH_STEPS):
    """Each step's metrics read at once and again after the last step (the
    returned tensors must keep their values), and the state after."""
    kept, now = [], []
    for t in range(steps):
        kept.append(trainer.train_step(batches[t % len(batches)]))
        now.append({k: v.item() for k, v in kept[-1].items()})
    assert [{k: v.item() for k, v in m.items()} for m in kept] == now
    return now, _train_state(trainer)


def _require_same_steps(graph, eager):
    assert graph[0] == eager[0]
    assert len(graph[1]) == len(eager[1])
    assert all(torch.equal(a, b) for a, b in zip(graph[1], eager[1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embedding_backward_gives_the_same_bits_every_call(gen, dtype):
    """The embedding's gradient at an RLE encoder's shape (B 8, L 4090, a
    105-token vocabulary, width 512) is the same bits at every call, so
    that a train step's graph and its eager body can agree bit for bit
    (``F.embedding``'s backward did not, run to run, on the card)."""
    from multimodalanalytical_tpu_torch.ops.layers import Embed

    embed = Embed(105, 512, dtype=dtype, device="cuda", generator=gen)
    ids = torch.randint(0, 105, (8, 4090), generator=gen, device="cuda")
    grad_out = torch.randn(8, 4090, 512, generator=gen, device="cuda").to(dtype)
    grads = [torch.autograd.grad(embed(ids), embed.weight, grad_out)[0] for _ in range(50)]
    assert all(torch.equal(g, grads[0]) for g in grads[1:])
    assert torch.equal(embed(ids), embed.weight.to(dtype)[ids])


@pytest.mark.parametrize("case", ["dropout", "acc2", "two_shapes", "flash", "fused_dropout",
                                  "device_mixture"])
def test_graph_train_step_is_bit_equal_to_eager(gen, monkeypatch, case):
    """5 steps through ``Trainer(cuda_graph=True)``'s replayed graphs and
    through the same body eagerly (``cuda_graph=False``): losses, gradient
    norms, parameters and Adam moments bit-equal; the returned metrics
    keep their values after later replays; each graph key's first step
    runs eagerly, the second captures. Cases: dropout 0.1 with modality
    dropout; ``acc_batches`` 2 (a graph per phase); two batch shapes (a
    graph per shape); the flash route at L 2100 (#5/#6 in the graph,
    launched 2 layers x steps); every dropout site through fused dropout
    (#7 in the graph, its seed drawn on the card from the registered
    generator); the device-mixture premix inside the graph."""
    from multimodalanalytical_tpu_torch.models import transformer
    from multimodalanalytical_tpu_torch.ops import fused_dropout as fd
    from multimodalanalytical_tpu_torch.training import Trainer

    kwargs, keys, counted = {}, 1, ()
    make_model = lambda: _train_model(TRAIN_DATA_CONFIG)  # noqa: E731
    batches = [_train_batch(11), _train_batch(12)]
    if case == "dropout":
        kwargs["modality_dropout"] = ["Formula", "IR"]
    elif case == "acc2":
        kwargs.update(acc_batches=2, modality_dropout=["IR"])
        keys = 2
    elif case == "two_shapes":
        batches = [_train_batch(11), _train_batch(13, rows=3)]
        keys = 2
    elif case == "flash":
        make_model = lambda: _train_model(RLE_TRAIN_CONFIG, dtype="bfloat16",  # noqa: E731
                                          use_flash=True)
        batches = [_train_batch(11, rows=2, source=_rle_source())]
        counted = (flash.flash_attention_fwd, flash.flash_attention_bwd)
    elif case == "fused_dropout":
        def fused(x, rate, generator, columns=None):
            assert columns is None
            return fd.dropout(x, rate, generator)

        monkeypatch.setattr(transformer, "dropout", fused)
        make_model = lambda: _train_model(TRAIN_DATA_CONFIG, dtype="bfloat16")  # noqa: E731
        counted = (fd.fused_dropout,)
    else:
        premix, arrays, index_batch = _premix_inputs()
        consts = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
        kwargs.update(batch_transform=lambda batch: premix(consts, batch),
                      modality_dropout=["Formula", "IR"])
        make_model = lambda: _train_model(MIX_TRAIN_CONFIG, vocab=30)  # noqa: E731
        batches = [index_batch]

    runs, launched = {}, {}
    for graph in (False, True):
        trainer = Trainer(make_model(), optimiser="adamw", lr=1e-3, num_steps=10,
                          cuda_graph=graph, **kwargs)
        for fn in counted:
            fn.launches = 0
        runs[graph] = _steps(trainer, batches)
        launched[graph] = [fn.launches for fn in counted]
        stats = trainer.step_stats
        if graph:
            assert stats["graph"] and stats["captures"] == keys
            assert stats["eager_steps"] == keys
            assert stats["replays"] == GRAPH_STEPS - keys
            assert trainer.graph_pool_bytes() > 0
        else:
            assert not stats["graph"] and stats["eager_steps"] == GRAPH_STEPS
        del trainer
    _require_same_steps(runs[True], runs[False])
    assert launched[True] == launched[False]
    if case == "flash":
        assert launched[True] == [2 * GRAPH_STEPS, 2 * GRAPH_STEPS]
    elif case == "fused_dropout":
        assert launched[True][0] > 0


def test_graph_train_step_resumes_from_last_mid_fit(gen, tmp_path):
    """Dropout 0.1 with modality dropout, 3 batches an epoch: a graph-route
    fit cut at step 3 and resumed from ``last`` in a new trainer, and a
    trainer whose graphs are captured loading that ``last`` in place
    (``load_state_tree`` copies into the parameters and moments the graphs
    read) and training on from it, both take the eager uninterrupted fit's
    losses and end at its state, bit for bit."""
    import shutil

    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training.checkpoint import CheckpointManager

    batches = [_train_batch(11 + i) for i in range(3)]

    def trainer(graph):
        return Trainer(_train_model(TRAIN_DATA_CONFIG), optimiser="adamw", lr=1e-3,
                       num_steps=6, cuda_graph=graph, modality_dropout=["Formula", "IR"])

    straight = trainer(False)
    want = straight.fit(batches, None, epochs=2)
    first = trainer(True)
    head = first.fit(batches, None, epochs=2, checkpoints=CheckpointManager(tmp_path / "a"),
                     max_steps=3)
    shutil.copytree(tmp_path / "a", tmp_path / "b")    # each resume saves over its last
    resumed = trainer(True)
    tail = resumed.fit(batches, None, epochs=2, checkpoints=CheckpointManager(tmp_path / "a"),
                       resume=True)
    assert head + tail == want
    captured = trainer(True)
    captured.fit(batches, None, epochs=2)
    assert captured.step_stats["captures"] == 1
    again = captured.fit(batches, None, epochs=2, checkpoints=CheckpointManager(tmp_path / "b"),
                         resume=True)
    assert again == want[3:] and captured.step_stats["captures"] == 1
    for got in (resumed, captured):
        assert all(torch.equal(a, b) for a, b in zip(_train_state(got), _train_state(straight)))


def test_graph_train_step_in_a_world_one_nccl_group(gen, monkeypatch):
    """5 steps of the graph route in a world-1 NCCL process group (whose
    collectives a graph may hold) against the eager route with no group:
    bit-equal; a gloo group would run the step eagerly."""
    import socket

    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.parallel import initialize_multihost
    from multimodalanalytical_tpu_torch.training import Trainer

    batches = [_train_batch(11), _train_batch(12)]

    def run(graph):
        trainer = Trainer(_train_model(TRAIN_DATA_CONFIG), optimiser="adamw", lr=1e-3,
                          num_steps=10, cuda_graph=graph)
        return _steps(trainer, batches), trainer.step_stats

    alone, _ = run(False)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(AFM_MULTIHOST="1", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    assert initialize_multihost(torch.device("cuda")) == torch.device("cuda", 0)
    try:
        grouped, stats = run(True)
    finally:
        dist.destroy_process_group()
    assert stats["graph"] and stats["captures"] == 1
    _require_same_steps(grouped, alone)


def test_graph_train_step_captures_an_nccl_all_reduce(gen, monkeypatch):
    """A graph holds NCCL's collectives. In a world-1 NCCL group: (1)
    ``dist.all_reduce`` between two ops, captured on a side stream, sums
    (over the one rank) what each replay's new input gives; (2) a trainer
    on a data mesh of two ranks forced onto the one process, so that its
    step sums the loss counts and the gradients over the group by
    ``all_reduce`` inside the captured body, takes 5 steps on the graph
    route bit-equal to the same mesh's eager route."""
    import socket

    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.parallel import initialize_multihost
    from multimodalanalytical_tpu_torch.parallel.mesh import Mesh
    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training import trainer as trainer_module

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(AFM_MULTIHOST="1", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    assert initialize_multihost(torch.device("cuda")) == torch.device("cuda", 0)
    try:
        assert dist.get_backend() == "nccl"
        x = torch.zeros(1000, device="cuda")
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            y = x * 2                       # the communicator's setup, before capture
            dist.all_reduce(y)
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            y = x * 2
            dist.all_reduce(y)
            z = y + 1
        for _ in range(3):
            x.copy_(torch.randn(1000, generator=gen, device="cuda"))
            graph.replay()
            assert torch.equal(z, x * 2 + 1)

        calls = []
        all_reduce = dist.all_reduce

        def counted(tensor, *args, **kwargs):
            calls.append(tuple(tensor.shape))
            return all_reduce(tensor, *args, **kwargs)

        monkeypatch.setattr(dist, "all_reduce", counted)
        monkeypatch.setattr(trainer_module, "default_mesh", lambda: Mesh(n_data=2))
        batches = [_train_batch(11), _train_batch(12)]
        runs, reduced = {}, {}
        for graph_route in (False, True):
            trainer = Trainer(_train_model(TRAIN_DATA_CONFIG), optimiser="adamw", lr=1e-3,
                              num_steps=10, cuda_graph=graph_route,
                              modality_dropout=["Formula", "IR"])
            calls.clear()
            runs[graph_route] = _steps(trainer, batches)
            reduced[graph_route] = len(calls)
            stats = trainer.step_stats
            del trainer
        assert stats["graph"] and stats["captures"] == 1 and stats["replays"] == GRAPH_STEPS - 1
        # Two all_reduces a step body (the loss counts, then the gradients):
        # each eager step's, and the capture's, which the replays run.
        assert reduced == {False: 2 * GRAPH_STEPS, True: 2 * 2}
        _require_same_steps(runs[True], runs[False])
    finally:
        dist.destroy_process_group()
