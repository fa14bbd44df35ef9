"""The port's ``Trainer.validate`` and ``predict`` against the JAX
``Trainer``'s on the same weights (CPU, fp32, a tiny flagship-family model).

Validation: weighted ``val_loss`` (rtol 1e-5: summation order), token and
greedy molecular accuracy (exact). Predict at K 2 and 30: every beam string
exact, ``avg_loss`` rtol 1e-5. Half of the target strings are the greedy
predictions, so the molecular accuracy counts real matches.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")

from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.parallel.mesh import make_mesh  # noqa: E402
from multimodalanalytical_tpu.training import trainer as jax_trainer  # noqa: E402
from multimodalanalytical_tpu_torch.generation.beam_search import greedy_decode  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.training import Trainer  # noqa: E402
from test_torch_model import data_config, example_batch, random_params, to_torch  # noqa: E402

VOCAB = 64  # > 30 candidates at the first beam-30 expansion
MAX_LENGTH = 16


class Tokenizer:
    """Fixed-vocabulary ``batch_decode`` (token ``t{id}``, specials skipped)."""

    pad_token_id, bos_token_id, eos_token_id = 0, 2, 3

    def batch_decode(self, ids, skip_special_tokens=True):
        specials = {self.pad_token_id, self.bos_token_id, self.eos_token_id}
        return [" ".join(f"t{int(i)}" for i in row if int(i) not in specials)
                for row in np.asarray(ids)]


@pytest.fixture(scope="module")
def pair():
    cfg = JaxConfig(d_model=64, encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
                    vocab_size=VOCAB, dtype="float32", max_target_length=MAX_LENGTH, dropout=0.0)
    jmodel = JaxModel(config=cfg, data_config=data_config(VOCAB), target_modality="Smiles")
    sample = example_batch()
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, sample["encoder_inputs"], sample["encoder_mask"], sample["decoder_ids"],
        sample["decoder_mask"], sample["labels"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed=3)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), data_config(VOCAB), "Smiles")
    load_flax_params(model, params)

    tokenizer = Tokenizer()
    batches = []
    for seed, n_valid in ((0, 3), (1, 2)):
        batch = example_batch(batch=3, seed=seed)
        if n_valid < 3:                       # a collator padding row
            batch["encoder_mask"][n_valid:] = 0
            batch["labels"][n_valid:] = -100
        greedy = greedy_decode(model, to_torch(batch["encoder_inputs"]),
                               torch.as_tensor(batch["encoder_mask"]), max_length=MAX_LENGTH)
        decoded = tokenizer.batch_decode(greedy.numpy())
        batch["target_strings"] = [d if i % 2 == 0 else "t5 t6" for i, d in enumerate(decoded)]
        batch["n_valid"] = n_valid
        batches.append(batch)

    jt = jax_trainer.Trainer(jmodel, tokenizer, mesh=make_mesh(devices=jax.devices()[:1]),
                             seed=0)
    state = jt.state_with_params(jax.jit(jt.init_state)(sample), params)
    return jt, state, Trainer(model, tokenizer), batches


def test_validate_matches_jax_trainer(pair):
    jt, state, trainer, batches = pair
    want = jt.validate(state, batches, jt._build_eval_step())
    got = trainer.validate(batches)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert got["val_token_acc"] == want["val_token_acc"]
    assert got["val_molecular_accuracy"] == want["val_molecular_accuracy"] == 3 / 5
    assert trainer.decode_steps > 0


@pytest.mark.parametrize("beams", [2, 30])
def test_predict_matches_jax_trainer(pair, beams):
    jt, state, trainer, batches = pair
    want = jt.predict(state, batches, n_beams=beams)
    got = trainer.predict(batches, n_beams=beams)
    assert got.keys() == want.keys()
    assert len(got["predictions"]) == 5 and all(len(p) == beams for p in got["predictions"])
    assert got["predictions"] == want["predictions"]
    assert got["targets"] == want["targets"]
    np.testing.assert_allclose(got["avg_loss"], want["avg_loss"], rtol=1e-5)
