"""The port's beam search against HuggingFace ``generate``.

``tests/test_beam_hf_parity.py``'s table-driven toy model (next-token
logits = base[row, step] + coupling[last token]) drives HF's ``generate``
there and the JAX ``beam_search``; here the same tables drive the port's
``BeamDecoder`` through a duck-typed stand-in for ``Seq2SeqModel`` (an
``encode``, an ``init_beam_cache``, a ``decoder.project_cross_kv`` and a
``beam_decode_step``), so the search's prologue, steps and epilogue run as
they do for a real model. Beams identical to HF's token for token (up to
HF's EOS filling after a finished hypothesis), normalised scores within
1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
pytest.importorskip("transformers")

from multimodalanalytical_tpu_torch.generation import beam_search as port_beam  # noqa: E402
from test_beam_hf_parity import (  # noqa: E402
    BATCH,
    BEAMS,
    BOS,
    EOS,
    MAXLEN,
    PAD,
    VOCAB,
    _canon,
    _hf_decode,
    _TableConfig,
    _TableModel,
    _tables,
)


class _Config:
    decoder_start_token_id = BOS
    eos_token_id = EOS
    pad_token_id = PAD
    vocab_size = VOCAB
    d_model = 8
    decoder_attention_heads = 2
    kv_cache_dtype = "bfloat16"
    relative_position_bias = False
    use_beam_kernel = False
    compute_dtype = torch.float32


class _Decoder(torch.nn.Module):
    def project_cross_kv(self, encoder_hidden, out=None):
        kv = [(encoder_hidden.clone(), encoder_hidden.clone())]
        if out is None:
            return kv
        for (k, v), (k_new, v_new) in zip(out, kv):
            k.copy_(k_new)
            v.copy_(v_new)
        return out


class _TableStandIn(torch.nn.Module):
    """Duck-typed ``Seq2SeqModel``: the toy's logits table, a trivial cache."""

    def __init__(self, base, coupling):
        super().__init__()
        self.config = _Config()
        self.mesh = None
        self.decoder = _Decoder()
        self.register_buffer("base", torch.tensor(base))
        self.register_buffer("coupling", torch.tensor(coupling))

    def encode(self, encoder_inputs, encoder_mask):
        return torch.zeros((encoder_mask.shape[0], encoder_mask.shape[1],
                            self.config.d_model))

    def init_beam_cache(self, batch, beams, max_length, encoder_hidden, encoder_mask,
                        quantize=False):
        assert not quantize
        return {"self": [], "cross": self.decoder.project_cross_kv(encoder_hidden),
                "cross_bias": torch.zeros(encoder_mask.shape)}

    def beam_decode_step(self, token_ids, position, cache, ancestry):
        # position: the decode loop's 0-d step index, read on the device.
        return self.base[:, position][:, None, :] + self.coupling[token_ids]


def _port_decode(base, coupling, stage_size, beams=BEAMS):
    decoder = port_beam.BeamDecoder(_TableStandIn(base, coupling))
    stats = {}
    seqs, scores = decoder.search({"X": torch.zeros((BATCH, 1), dtype=torch.long)},
                                  torch.ones((BATCH, 1), dtype=torch.int32), beams,
                                  max_length=MAXLEN, stage_size=stage_size, stats=stats)
    assert not stats["graph"] and 1 <= stats["steps"] <= MAXLEN - 1
    return seqs.numpy(), scores.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("stage_size", [None, 4])
def test_port_beam_search_matches_canonical_hf_generate(seed, stage_size):
    """Token-exact and score-exact parity with HF ``generate`` under
    ``early_stopping="never"``, the canonical beam search whose provably
    safe early exit the port's loop takes."""
    base, coupling = _tables(seed)
    hf_seqs, hf_scores = _hf_decode(base, coupling)
    seqs, scores = _port_decode(base, coupling, stage_size)
    np.testing.assert_array_equal(_canon(seqs), _canon(hf_seqs))
    np.testing.assert_allclose(scores, hf_scores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_hf_default_heuristic_never_beats_the_port(seed):
    """HF's default ``early_stopping=False`` may stop before a better,
    longer hypothesis exists; wherever it differs, the port's beams score
    at least as well."""
    base, coupling = _tables(seed)
    _, hf_scores = _hf_decode(base, coupling, early_stopping=False)
    _, scores = _port_decode(base, coupling, None)
    assert (scores >= hf_scores - 1e-5).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_greedy_matches_hf_greedy_search(seed):
    """One beam against HF's separate greedy path (``num_beams=1``)."""
    base, coupling = _tables(seed)
    model = _TableModel(_TableConfig(), base, coupling).eval()
    hf = model.generate(input_ids=torch.full((BATCH, 1), BOS, dtype=torch.long), num_beams=1,
                        max_length=MAXLEN, forced_eos_token_id=EOS, use_cache=False,
                        do_sample=False).numpy()
    if hf.shape[-1] < MAXLEN:
        hf = np.concatenate([hf, np.full((BATCH, MAXLEN - hf.shape[-1]), PAD, np.int64)], -1)
    seqs, _ = _port_decode(base, coupling, None, beams=1)
    np.testing.assert_array_equal(_canon(seqs)[:, 0], _canon(hf[:, None, :])[:, 0])
