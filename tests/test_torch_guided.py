"""The port's formula-guided decoding against the JAX package's (CPU, fp32).

Mirrors ``tests/test_guided.py``'s seven tests: each port function and the
JAX function get the same inputs (a SMILES vocabulary, seeded log-probs,
hand-built prefixes) and must agree exactly. Guided beam search through
the port's ``BeamDecoder`` must equal the JAX ``beam_search`` with the same
hook (surrogate and exact) token for token at K 1, 4 and 30, scores within
rtol 1e-5.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.chem import GUIDED_ATOM_LIST as JAX_ATOMS  # noqa: E402
from multimodalanalytical_tpu.generation import guided as jg  # noqa: E402
from multimodalanalytical_tpu.generation.beam_search import beam_search as jax_beam_search  # noqa: E402,E501
from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu_torch.chem import GUIDED_ATOM_LIST  # noqa: E402
from multimodalanalytical_tpu_torch.generation import guided as pg  # noqa: E402
from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from test_torch_model import data_config, example_batch, random_params, to_torch  # noqa: E402

SMILES_REGEX = (r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\|\/|:"
                r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")
CORPUS = ["CCO", "CC(=O)O", "c1ccccc1", "CCN", "CCS", "CC(C)O", "CC(=O)OCl", "C=CC", "CC#N",
          "C=C", "CC"]
VOCAB = 64          # SMILES tokens and fillers; > 30, so K 30 has K candidates at once
MAX_LENGTH = 16


class Tokenizer:
    """A fixed SMILES vocabulary (specials, the corpus's regex tokens, then
    fillers that name no atom), with what ``GuidedDecoder`` reads: ``vocab``,
    the special tokens, ``eos_token_id`` and a space-joined ``batch_decode``
    as the regex tokenizer's."""

    pad_token, unk_token, bos_token, eos_token = "<pad>", "<unk>", "<bos>", "<eos>"
    pad_token_id, unk_token_id, bos_token_id, eos_token_id = 0, 1, 2, 3

    def __init__(self):
        self.regex = re.compile(SMILES_REGEX)
        atoms = sorted({t for s in CORPUS for t in self.regex.findall(s)})
        tokens = [self.pad_token, self.unk_token, self.bos_token, self.eos_token] + atoms
        self.tokens = tokens + [f"<x{i}>" for i in range(VOCAB - len(tokens))]
        self.vocab = {t: i for i, t in enumerate(self.tokens)}

    def encode(self, smiles):
        return [self.vocab[t] for t in self.regex.findall(smiles)]

    def batch_decode(self, ids, skip_special_tokens=True):
        specials = {self.pad_token_id, self.bos_token_id, self.eos_token_id}
        return [" ".join(self.tokens[int(i)] for i in row
                         if not (skip_special_tokens and int(i) in specials))
                for row in np.asarray(ids)]


TOK = Tokenizer()
SPECIALS = [TOK.pad_token, TOK.unk_token, TOK.bos_token, TOK.eos_token]


def _prefixes(smiles_list, length=16):
    """(1, N, length) live rows: BOS, the SMILES's tokens, pad."""
    live = np.full((1, len(smiles_list), length), TOK.pad_token_id, np.int64)
    live[0, :, 0] = TOK.bos_token_id
    for n, smiles in enumerate(smiles_list):
        ids = TOK.encode(smiles)
        live[0, n, 1: 1 + len(ids)] = ids
    return live


def _both_hooks(mode):
    table = pg.build_token_atom_table(TOK.vocab, SPECIALS)
    if mode == "surrogate":
        return (jg.make_formula_hook(table, TOK.eos_token_id),
                pg.make_formula_hook(table, TOK.eos_token_id))
    decode = TOK.batch_decode
    return (jg.make_exact_formula_hook(table, TOK.eos_token_id, decode),
            pg.make_exact_formula_hook(table, TOK.eos_token_id, decode))


def _run_hooks(mode, target, live, logprobs, t):
    """Both hooks on the same inputs; returns (jax out, port out) as numpy."""
    jhook, phook = _both_hooks(mode)
    _, want = jhook({"target": jnp.asarray(target)}, jnp.asarray(logprobs),
                    jnp.asarray(live.astype(np.int32)), t)
    _, got = phook({"target": torch.as_tensor(target)}, torch.as_tensor(logprobs),
                   torch.as_tensor(live), torch.tensor(t))
    return np.asarray(want), got.numpy()


def test_token_atom_table_matches_jax():
    assert GUIDED_ATOM_LIST == JAX_ATOMS
    want = jg.build_token_atom_table(TOK.vocab, SPECIALS)
    got = pg.build_token_atom_table(TOK.vocab, SPECIALS)
    np.testing.assert_array_equal(got, want)
    c, cl = GUIDED_ATOM_LIST.index("C"), GUIDED_ATOM_LIST.index("Cl")
    assert got[TOK.vocab["C"], c] == 1 and got[TOK.vocab["Cl"], c] == 0
    assert got[TOK.vocab["Cl"], cl] == 1 and got[TOK.vocab["c"], c] == 1
    assert got[TOK.eos_token_id].sum() == 0


def test_target_formula_counts_match_jax():
    smiles = CORPUS + ["bad(", ""]
    got = pg.target_formula_counts(smiles)
    np.testing.assert_array_equal(got, jg.target_formula_counts(smiles))
    assert got[0, GUIDED_ATOM_LIST.index("H")] == 6 and got[-2].sum() == 0


@pytest.mark.parametrize("mode", ["surrogate", "exact"])
def test_hook_rules_on_seeded_logprobs_match_jax(mode):
    """Both rules and the lookahead, on seeded log-probs and the corpus's
    prefixes against their own targets (even rows) or seeded ones (odd
    rows), at every prefix length: EOS forced, EOS banned and tokens
    banned somewhere, each as the JAX hook does it."""
    rng = np.random.default_rng(0)
    live = _prefixes(CORPUS)
    own = rng.integers(0, len(CORPUS), len(CORPUS))
    own[::2] = np.arange(0, len(CORPUS), 2)
    targets = pg.target_formula_counts([CORPUS[i] for i in own])[None]
    logprobs = np.log(rng.dirichlet(np.ones(VOCAB), (1, len(CORPUS)))).astype(np.float32)
    eos = TOK.eos_token_id
    forced = banned_eos = banned = False
    for t in range(1, 9):
        want, got = _run_hooks(mode, targets, live, logprobs, t)
        np.testing.assert_array_equal(got, want)
        forced |= bool((got[..., eos] == 0.0).any())
        banned_eos |= bool(np.isneginf(got[..., eos]).any())
        banned |= bool(np.isneginf(got[..., 4:]).any())
    assert forced and banned_eos and banned


def test_exact_hook_forces_and_bans_as_jax():
    """Target CCO: prefix "CCO" matches (EOS forced, C banned), "CO"
    undershoots (EOS banned, C allowed), as tests/test_guided.py."""
    live = _prefixes(["CCO", "CO"])
    target = np.tile(pg.target_formula_counts(["CCO"])[:, None, :], (1, 2, 1))
    want, got = _run_hooks("exact", target, live, np.zeros((1, 2, VOCAB), np.float32), 3)
    np.testing.assert_array_equal(got, want)
    eos, c = TOK.eos_token_id, TOK.vocab["C"]
    assert got[0, 0, eos] == 0.0 and got[0, 0, c] == -np.inf
    assert got[0, 1, eos] == -np.inf and got[0, 1, c] == 0.0


def test_exact_and_surrogate_diverge_on_hydrogen_as_jax():
    """CC (C2H6) and C=C (C2H4) against target CC: the surrogate forces EOS
    on both, the exact hook on CC only."""
    live = _prefixes(["CC", "C=C"])
    target = np.tile(pg.target_formula_counts(["CC"])[:, None, :], (1, 2, 1))
    zeros = np.zeros((1, 2, VOCAB), np.float32)
    outs = {}
    for mode in ("exact", "surrogate"):
        want, got = _run_hooks(mode, target, live, zeros, 3)
        np.testing.assert_array_equal(got, want)
        outs[mode] = got[0, :, TOK.eos_token_id]
    assert list(outs["exact"]) == [0.0, -np.inf]
    assert list(outs["surrogate"]) == [0.0, 0.0]


def test_surrogate_subsumes_exact_on_corpus():
    """Where exact forces EOS, the surrogate does; where the surrogate bans
    EOS, exact does (tests/test_guided.py's corpus check), each hook equal
    to its JAX counterpart on every (target, prefix) pair."""
    checked = 0
    for target in CORPUS:
        counts = pg.target_formula_counts([target])[:, None, :]
        for prefix in CORPUS:
            live = _prefixes([prefix])
            t = len(TOK.encode(prefix))
            zeros = np.zeros((1, 1, VOCAB), np.float32)
            outs = {}
            for mode in ("surrogate", "exact"):
                want, got = _run_hooks(mode, counts, live, zeros, t)
                np.testing.assert_array_equal(got, want)
                outs[mode] = got[0, 0, TOK.eos_token_id]
            if outs["exact"] == 0.0:
                assert outs["surrogate"] == 0.0, (target, prefix)
            if outs["surrogate"] == -np.inf:
                assert outs["exact"] == -np.inf, (target, prefix)
            checked += 1
    assert checked == len(CORPUS) ** 2


def _batch(rows=3, seed=0):
    rng = np.random.default_rng(seed)
    batch = example_batch(batch=rows, seed=seed)
    batch["target_strings"] = [CORPUS[i] for i in rng.integers(0, len(CORPUS), rows - 1)]
    return batch      # the last row has no target: a padding row, as the collator pads


def test_guided_decoder_state_for_matches_jax():
    """Per-batch targets tiled over the beams, padding rows and unparseable
    targets at 10_000; one static decode shape serves batches with other
    targets (the JAX test's single compile)."""
    batch = _batch()
    batch["target_strings"][0] = "bad("
    for mode in ("surrogate", "exact"):
        want = jg.GuidedDecoder(TOK, mode).state_for(batch, 4)["target"]
        got = pg.GuidedDecoder(TOK, mode).state_for(batch, 4, device="cpu")["target"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0] == 10_000).all() and (got[2] == 10_000).all()
    with pytest.raises(ValueError):
        pg.GuidedDecoder(TOK, "loose")


@pytest.fixture(scope="module")
def pair():
    cfg = JaxConfig(d_model=64, encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
                    vocab_size=VOCAB, dtype="float32", max_target_length=MAX_LENGTH,
                    dropout=0.0)
    jmodel = JaxModel(config=cfg, data_config=data_config(VOCAB), target_modality="Smiles")
    sample = example_batch()
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, sample["encoder_inputs"], sample["encoder_mask"], sample["decoder_ids"],
        sample["decoder_mask"], sample["labels"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed=7)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), data_config(VOCAB), "Smiles")
    load_flax_params(model, params)
    return jmodel, {"params": params}, model


@pytest.mark.parametrize("mode", ["surrogate", "exact"])
@pytest.mark.parametrize("beams", [1, 4, 30])
def test_guided_beam_search_matches_jax(pair, mode, beams):
    jmodel, variables, model = pair
    batch = _batch()
    jguide, pguide = jg.GuidedDecoder(TOK, mode), pg.GuidedDecoder(TOK, mode)
    want_seqs, want_scores = jax_beam_search(
        jmodel, variables, batch["encoder_inputs"], jnp.asarray(batch["encoder_mask"]),
        num_beams=beams, max_length=MAX_LENGTH, logits_hook=jguide.hook,
        hook_init=jguide.state_for(batch, beams))
    stats = {}
    got_seqs, got_scores = BeamDecoder(model).search(
        to_torch(batch["encoder_inputs"]), torch.as_tensor(batch["encoder_mask"]), beams,
        max_length=MAX_LENGTH, logits_hook=pguide.hook,
        hook_init=pguide.state_for(batch, beams), stats=stats)
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=1e-5)
    # The guide must have changed the decode: unguided beams differ.
    plain, _ = BeamDecoder(model).search(
        to_torch(batch["encoder_inputs"]), torch.as_tensor(batch["encoder_mask"]), beams,
        max_length=MAX_LENGTH)
    assert not torch.equal(plain, got_seqs)
    assert 1 <= stats["steps"] <= MAX_LENGTH - 1
