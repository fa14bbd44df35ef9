"""PyTorch port's beam search vs the JAX package's, on the same weights (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.generation.beam_search import beam_search as jax_beam_search  # noqa: E402,E501
from multimodalanalytical_tpu.generation.beam_search import greedy_decode as jax_greedy  # noqa: E402,E501
from multimodalanalytical_tpu_torch.generation import beam_search as port_beam  # noqa: E402
from test_torch_model import build_pair, to_torch  # noqa: E402

NEG_INF = port_beam.NEG_INF


def _host_loop(model, encoder_inputs, encoder_mask, num_beams, max_length):
    """The beam search as a Python loop on the host (the port's loop before
    the decode state moved to the device): an int step index, a host sync
    per step for the early exit. Returns (seqs, scores, steps)."""
    cfg = model.config
    batch = encoder_mask.shape[0]
    with torch.no_grad():
        hidden = model.encode(encoder_inputs, encoder_mask)
        cache = model.init_beam_cache(batch, num_beams, max_length, hidden, encoder_mask,
                                      port_beam.kv_cache_quantized(cfg, num_beams, max_length))
        live = torch.full((batch, num_beams, max_length), cfg.pad_token_id, dtype=torch.long)
        live[:, :, 0] = cfg.decoder_start_token_id
        live_scores = torch.full((batch, num_beams), NEG_INF)
        live_scores[:, 0] = 0.0
        fin, fin_scores = torch.full_like(live, cfg.pad_token_id), torch.full_like(live_scores,
                                                                                  NEG_INF)
        anc = torch.zeros((batch, num_beams, max_length), dtype=torch.int32)
        t = 0
        while t < max_length - 1:
            if bool((fin_scores.min(1).values >= live_scores.max(1).values / max_length).all()):
                break
            anc[:, :, t] = torch.arange(num_beams, dtype=torch.int32)
            logits = model.beam_decode_step(live[:, :, t], t, cache, anc)
            logprobs = torch.log_softmax(logits.float(), dim=-1)
            vocab = logprobs.shape[-1]
            if t == max_length - 2:
                logprobs = torch.full_like(logprobs, NEG_INF)
                logprobs[:, :, cfg.eos_token_id] = 0.0
            total = (live_scores[:, :, None] + logprobs).reshape(batch, -1)
            top, idx = port_beam._top_k(total, 2 * num_beams)
            src, token = idx // vocab, idx % vocab
            cand = live.gather(1, src[:, :, None].expand(-1, -1, max_length))
            cand[:, :, t + 1] = token
            eos = token == cfg.eos_token_id
            fin_scores, fi = port_beam._top_k(
                torch.cat([fin_scores, torch.where(eos, top / float(t + 1), NEG_INF)], 1),
                num_beams)
            fin = torch.cat([fin, cand], 1).gather(1, fi[:, :, None].expand(-1, -1, max_length))
            live_scores, li = port_beam._top_k(torch.where(eos, NEG_INF, top), num_beams)
            live = cand.gather(1, li[:, :, None].expand(-1, -1, max_length))
            anc = anc.gather(1, src.gather(1, li)[:, :, None].expand(-1, -1, max_length))
            t += 1
        scores, idx = port_beam._top_k(torch.cat([fin_scores, live_scores / max_length], 1),
                                       num_beams)
        seqs = torch.cat([fin, live], 1).gather(1, idx[:, :, None].expand(-1, -1, max_length))
    return seqs, scores, t


def _run_both(beams, max_length, **pair_kw):
    jmodel, variables, model, batch = build_pair(**pair_kw)
    enc, mask = batch["encoder_inputs"], batch["encoder_mask"]
    want_seqs, want_scores = jax_beam_search(
        jmodel, variables, enc, jnp.asarray(mask), num_beams=beams, max_length=max_length)
    stats = {}
    got_seqs, got_scores = port_beam.beam_search(
        model, to_torch(enc), torch.as_tensor(mask), num_beams=beams,
        max_length=max_length, stats=stats)
    return (np.asarray(want_seqs), np.asarray(want_scores), got_seqs.numpy(),
            got_scores.numpy(), stats)


def test_fp32_beam_search_matches_jax_token_for_token():
    want_seqs, want_scores, got_seqs, got_scores, stats = _run_both(beams=4, max_length=16)
    np.testing.assert_array_equal(got_seqs, want_seqs)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5)
    assert 1 <= stats["steps"] <= 15
    assert (got_seqs[:, :, 0] == 2).all()
    assert (np.diff(got_scores, axis=1) <= 0).all()


def test_greedy_matches_jax():
    jmodel, variables, model, batch = build_pair()
    enc, mask = batch["encoder_inputs"], batch["encoder_mask"]
    want = jax_greedy(jmodel, variables, enc, jnp.asarray(mask), max_length=16)
    got = port_beam.greedy_decode(model, to_torch(enc), torch.as_tensor(mask), max_length=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw, beams, length, want", [
    (dict(d_model=512), 10, 128, True),        # the flagship serving config
    (dict(d_model=512), 4, 32, True),          # tests/test_beam_kernel.py int8 case
    (dict(d_model=128, decoder_attention_heads=2), 4, 16, True),
    (dict(d_model=64), 4, 16, False),          # head_dim 8
    (dict(d_model=512), 1, 128, False),        # greedy
    (dict(d_model=512), 40, 128, False),       # more than 32 beams
    (dict(d_model=512), 4, 8, False),          # flat slot axis 32 < 64
    (dict(d_model=512, kv_cache_dtype="bfloat16"), 10, 128, False),
    (dict(d_model=512, use_beam_kernel=False), 10, 128, False),
])
def test_int8_cache_decision(kw, beams, length, want):
    """The port picks the JAX package's cache type (beam_search.py:87-97)."""
    from multimodalanalytical_tpu_torch.models.config import ModelConfig

    assert port_beam.kv_cache_quantized(ModelConfig(**kw), beams, length) is want


def test_top_k_breaks_ties_toward_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    values, indices = port_beam._top_k(x, 3)
    want_values, want_indices = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want_indices))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))


def test_decode_model_pre_casts_the_bf16_dense_biases():
    """``decode_model`` pre-casts the bias of every Dense layer that computes
    in bf16 (each call would cast it to the same bf16 values), so no such
    bias is fp32 in the decode model; LayerNorm parameters and the fp32
    lm_head keep fp32, and the trained model is left as it was."""
    from multimodalanalytical_tpu_torch.ops.layers import Dense, LayerNorm

    _, _, model, _ = build_pair(dtype="bfloat16")
    decoding = port_beam.decode_model(model)
    original = dict(model.named_modules())
    cast = 0
    for name, module in decoding.named_modules():
        if isinstance(module, Dense) and module.bias is not None:
            if module.dtype == torch.bfloat16:
                assert module.bias.dtype == torch.bfloat16, name
                assert torch.equal(module.bias, original[name].bias.to(torch.bfloat16)), name
                cast += 1
            else:
                assert name == "lm_head" and module.bias.dtype == torch.float32
        if isinstance(module, LayerNorm):
            assert module.weight.dtype == module.bias.dtype == torch.float32, name
    assert cast >= 4 * 2 + 2 * 2      # attention and FFN Dense layers of the decoder
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _eos_biased(model, bias=20.0):
    """The model with EOS favoured in its lm_head bias, so decodes end early."""
    with torch.no_grad():
        model.lm_head.bias[model.config.eos_token_id] += bias
    return model


@pytest.mark.parametrize("stage_size", [None, 4, 32])
@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_device_state_loop_matches_jax_and_the_host_loop(check_every, stage_size):
    """The device-state loop at each check period and staging: token for
    token the JAX beam search (fp32, scores rtol 1e-5), and the same steps
    as the host loop, on a model that exits early (EOS favoured) and one
    that does not."""
    for bias in (0.0, 20.0):
        jmodel, variables, model, batch = build_pair()
        enc, mask = batch["encoder_inputs"], batch["encoder_mask"]
        lm_bias = np.array(variables["params"]["lm_head"]["bias"])
        lm_bias[model.config.eos_token_id] += bias
        variables["params"]["lm_head"]["bias"] = lm_bias
        _eos_biased(model, bias)
        want_seqs, want_scores = jax_beam_search(jmodel, variables, enc, jnp.asarray(mask),
                                                 num_beams=4, max_length=16,
                                                 stage_size=stage_size)
        stats = {}
        got_seqs, got_scores = port_beam.beam_search(
            model, to_torch(enc), torch.as_tensor(mask), num_beams=4, max_length=16,
            stage_size=stage_size, check_every=check_every, stats=stats)
        np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
        np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=1e-5)
        _, _, host_steps = _host_loop(model, to_torch(enc), torch.as_tensor(mask), 4, 16)
        assert stats["steps"] == host_steps
        assert stats["replays"] >= host_steps and not stats["graph"]
        if bias:
            assert host_steps < 15     # the early exit was taken
            assert stats["replays"] == min(15, -(-(host_steps + 1) // check_every)
                                           * check_every)


def test_step_past_the_exit_leaves_the_state_unchanged():
    """Once the decode is done (EOS favoured) or ``t`` stands at its stage's
    last time, one more step changes no state tensor and ``t`` stays."""
    _, _, model, batch = build_pair()
    _eos_biased(model)
    decoder = port_beam.BeamDecoder(model)
    stats = {}
    decoder.search(to_torch(batch["encoder_inputs"]), torch.as_tensor(batch["encoder_mask"]),
                   4, max_length=16, stats=stats)
    (decode,) = decoder._decodes.values()
    assert stats["steps"] < 15 and bool(decode.state["done"])

    def snapshot():
        return {k: v.clone() for k, v in decode.state.items() if k != "hook"}

    for bound in (16, stats["steps"] + 1):   # done; done and at the stage's end
        before = snapshot()
        decoder._step(decode, bound, 16, 1.0, None)
        after = snapshot()
        assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("case,reason", [("cpu", "cpu device"), ("off", "cuda_graph=False"),
                                         ("hook", "a logits hook that is not capturable")])
def test_graph_route_reasons_reach_the_search_and_the_trainer(case, reason):
    """The reasons ``graph_route`` gives for the eager route that a machine
    without a card reaches: each is what the route returns, what a search
    reports (``stats["eager_reason"]``) and, through its decodes, what the
    trainer reports; the trainer's steps report their own route. The same
    model on a CUDA device would replay graphs (None)."""
    from multimodalanalytical_tpu_torch.ops import _cuda
    from multimodalanalytical_tpu_torch.training import Trainer

    _, _, model, batch = build_pair()

    def hook(state, logprobs, live_seqs, t):
        return state, logprobs

    hook.capturable = False
    cuda_graph, hooks = case != "off", ({"logits_hook": hook} if case == "hook" else {})
    assert _cuda.graph_route(torch.device("cuda"), True, model) is None
    assert _cuda.graph_route(torch.device("cpu"), cuda_graph, model, hook=hooks.get(
        "logits_hook")) == reason
    request = {"encoder_inputs": to_torch(batch["encoder_inputs"]),
               "encoder_mask": torch.as_tensor(batch["encoder_mask"])}
    stats = {}
    port_beam.BeamDecoder(model).search(*request.values(), 2, max_length=8,
                                        cuda_graph=cuda_graph, stats=stats, **hooks)
    assert not stats["graph"] and stats["eager_reason"] == reason
    trainer = Trainer(model, cuda_graph=cuda_graph)
    trainer._decode(trainer.beam_decoder(), request, 2, hooks)
    assert trainer.last_decode_stats["eager_reason"] == reason
    steps = "cpu device" if case == "hook" else reason
    for route in (trainer.step_stats, trainer.eval_stats):
        assert not route["graph"] and route["eager_reason"] == steps


def test_back_to_back_requests_through_the_static_buffers():
    """Two requests decoded one after the other through one decoder (the
    same static buffers; the caches are not cleared between them) equal two
    fresh decodes."""
    _, _, model, batch = build_pair()
    other = build_pair()[3]
    requests = [(to_torch(b["encoder_inputs"]), torch.as_tensor(b["encoder_mask"]))
                for b in (batch, other)]
    requests[1][0]["IR"] = requests[1][0]["IR"].flip(1)
    decoder = port_beam.BeamDecoder(model)
    reused = [decoder.search(enc, mask, 4, max_length=16) for enc, mask in requests]
    assert len(decoder._decodes) == 1
    for (enc, mask), (seqs, scores) in zip(requests, reused):
        fresh_seqs, fresh_scores = port_beam.beam_search(model, enc, mask, 4, max_length=16)
        assert torch.equal(seqs, fresh_seqs) and torch.equal(scores, fresh_scores)
    assert not torch.equal(reused[0][0], reused[1][0])


@pytest.mark.parametrize("cache_kind", ["int8", "bf16"])
def test_plain_route_takes_a_tensor_position(cache_kind):
    """``use_beam_kernel=False``: the self-attention's plain route with the
    step index as a 0-d tensor writes the same cache rows and returns the
    same output as with an int."""
    from multimodalanalytical_tpu_torch.ops.attention import MultiHeadAttention

    b, k, d, heads, length, pos = 2, 4, 128, 2, 8, 5
    g = torch.Generator().manual_seed(0)
    attn = MultiHeadAttention(heads, d, dtype=torch.bfloat16, use_beam_kernel=False,
                              generator=g)
    x = torch.randn(b * k, d, generator=g).bfloat16()
    anc = torch.randint(0, k, (b, k, length), generator=g, dtype=torch.int32)
    anc[:, :, pos] = torch.arange(k, dtype=torch.int32)
    if cache_kind == "int8":
        cache = {"data": torch.randint(-127, 128, (2, b, length * k, d), generator=g,
                                       dtype=torch.int8),
                 "scale": torch.rand(2, b, heads, 128, generator=g) * 0.05}
    else:
        cache = torch.randn(2, b, length * k, d, generator=g).bfloat16()

    def run(position):
        store = ({n: v.clone() for n, v in cache.items()} if cache_kind == "int8"
                 else cache.clone())
        return attn.beam_decode_self_attention(x, store, anc, position), store

    got, got_store = run(torch.tensor(pos, dtype=torch.int32))
    want, want_store = run(pos)
    assert torch.equal(got, want)
    if cache_kind == "int8":
        assert all(torch.equal(got_store[n], want_store[n]) for n in want_store)
    else:
        assert torch.equal(got_store, want_store)


class _Tokenizer:
    pad_token_id, bos_token_id, eos_token_id = 0, 2, 3

    def batch_decode(self, ids, skip_special_tokens=True):
        return [" ".join(str(int(i)) for i in row if int(i) > 3) for row in np.asarray(ids)]


def test_trainer_decodes_with_the_weights_of_its_latest_step():
    """The trainer keeps one decoder (its static buffers and, on a card,
    its graphs) across validate and predict; after an optimizer step its
    bf16 decode copy holds the new weights, in the same storage, and
    predict decodes as a fresh beam search of the new weights does."""
    from multimodalanalytical_tpu_torch.training import Trainer

    _, _, model, batch = build_pair(dtype="bfloat16")
    batch = dict(batch, target_strings=["5 6", "7", "8 9 10"], n_valid=3)
    trainer = Trainer(model, _Tokenizer(), optimiser="adamw", lr=1e-2, num_steps=10,
                      n_beams=4)
    trainer.validate([batch])
    decoder = trainer.beam_decoder()
    pointers = [p.data_ptr() for p in decoder.dmodel.parameters()]
    trainer.train_step(batch)
    first = trainer.predict([batch])
    assert trainer.beam_decoder() is decoder
    assert [p.data_ptr() for p in decoder.dmodel.parameters()] == pointers
    fresh = port_beam.decode_model(model)
    for (name, got), want in zip(decoder.dmodel.named_parameters(), fresh.parameters()):
        assert got.dtype == want.dtype and torch.equal(got, want), name
    seqs, _ = port_beam.beam_search(model, to_torch(batch["encoder_inputs"]),
                                    torch.as_tensor(batch["encoder_mask"]), 4, max_length=16)
    want = _Tokenizer().batch_decode(seqs.reshape(-1, 16))
    assert [b for row in first["predictions"] for b in row] == want
    assert trainer.decode_replays >= trainer.decode_steps > 0
