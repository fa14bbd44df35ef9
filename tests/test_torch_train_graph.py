"""The train step's two halves on the CPU: the host plan and the device body.

``Trainer.train_step`` plans on the host every value that depends on the
step count (the dropout seed, the modality keep vector, the schedule's
learning rate, optax's float32 bias corrections, the accumulation phase)
and runs a device body that reads them from small tensors, which a CUDA
device captures once and replays (``tests/test_torch_cuda.py`` holds the
graph to the eager body there). Here the body runs eagerly, as it does on
every route off the card:

- over 3 steps it equals the JAX ``Trainer`` (fp32, dropout 0) for adam and
  adamw, ``acc_batches`` 1 and 2, with modality dropout over both inputs:
  the port's masks after its draw are carried into the JAX step, as
  ``tests/test_torch_multiprocess.py`` carries them (the packages draw from
  different generators); losses to rtol 1e-5 and parameters to atol 1e-5,
  as ``tests/test_torch_train.py`` holds them;
- over 12 steps across the schedule's warm-up and decay, the plan's
  learning rate and bias corrections equal optax's schedule and optax's
  float32 ``1 - b**count``, and its keep vectors equal the host draw of
  ``apply_modality_dropout`` for the same (seed, step);
- a fit resumed from ``last`` takes the losses and ends at the parameters
  of the uninterrupted fit, with dropout and modality dropout on.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")

from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.parallel.mesh import make_mesh, shard_batch  # noqa: E402
from multimodalanalytical_tpu.training import trainer as jax_trainer  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import (  # noqa: E402
    flax_to_state_dict,
    load_flax_params,
)
from multimodalanalytical_tpu_torch.training import optim  # noqa: E402
from multimodalanalytical_tpu_torch.training import trainer as trainer_module  # noqa: E402
from multimodalanalytical_tpu_torch.training.checkpoint import CheckpointManager  # noqa: E402
from multimodalanalytical_tpu_torch.training.trainer import Trainer  # noqa: E402

TARGET_VOCAB = 40
DATA_CONFIG = {
    "Formula": {"type": "text", "vocab_size": 32, "target": False},
    "IR": {"type": "1D_patches", "target": False, "preprocessor_arguments": {"patch_size": 125}},
    "Smiles": {"type": "text", "vocab_size": TARGET_VOCAB, "target": True},
}
MODEL = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4,
             encoder_ffn_dim=128, decoder_ffn_dim=128, encoder_layers=1, decoder_layers=1,
             vocab_size=TARGET_VOCAB)
DROPPED = ["Formula", "IR"]
SEED = 3   # its (seed, step) draws drop a modality in some of the first 3 steps, not all
B1, B2 = 0.9, 0.999


def _batches(steps, batch=2, target_len=12):
    """Seeded collated-style batches of the Formula + IR patches recipe:
    tail-padded sources, padded targets (``tests/test_torch_train.py``'s)."""
    out = []
    for step in range(steps):
        rng = np.random.default_rng(100 + step)
        enc = {"Formula": rng.integers(1, 32, (batch, 12)).astype(np.int32),
               "IR": rng.random((batch, 14, 125)).astype(np.float32)}
        length = 12 + 14
        mask = np.ones((batch, length), np.int32)
        mask[-1, length - 5 + step:] = 0
        dec = rng.integers(4, TARGET_VOCAB, (batch, target_len)).astype(np.int32)
        dmask = np.ones((batch, target_len), np.int32)
        dmask[0, 9:] = 0
        labels = rng.integers(4, TARGET_VOCAB, (batch, target_len)).astype(np.int32)
        labels[0, 8:] = -100
        out.append({"encoder_inputs": enc, "encoder_mask": mask, "decoder_ids": dec,
                    "decoder_mask": dmask, "labels": labels, "n_valid": batch})
    return out


def _key_bias(name, size):
    """The entries of a bias that add a constant to every key of a row (the
    k part of the fused self-attention qkv bias and of the cross kv bias):
    their true gradient is 0, so each package sees only its own rounding
    noise, which Adam scales up to as much as one learning rate a step."""
    mask = np.zeros(size, bool)
    if name.endswith("self_attn.qkv_proj.bias"):
        mask[size // 3: 2 * size // 3] = True
    elif name.endswith("cross_attn.kv_proj.bias"):
        mask[: size // 2] = True
    return mask


def _record_masks(monkeypatch):
    """Record each mask the train step's body takes after its modality
    dropout."""
    masks, draw = [], trainer_module.apply_modality_dropout

    def recorded(*args):
        mask = draw(*args)
        masks.append(mask.numpy().copy())
        return mask

    monkeypatch.setattr(trainer_module, "apply_modality_dropout", recorded)
    return masks


@pytest.mark.parametrize("optimiser,acc_batches",
                         [("adam", 1), ("adamw", 1), ("adam", 2), ("adamw", 2)])
def test_step_body_matches_jax_trainer(monkeypatch, optimiser, acc_batches):
    """3 steps of the port's plan and eager body against the JAX step on the
    same initial params and batches, the JAX step fed the port's masks."""
    steps = 3
    opt = dict(optimiser=optimiser, lr=2e-3, weight_decay=0.01, num_steps=steps, clip_grad=1.0,
               acc_batches=acc_batches)
    cfg = JaxConfig(dropout=0.0, dtype="float32", **MODEL)
    batches = _batches(steps)
    jmodel = JaxModel(config=cfg, data_config=DATA_CONFIG, target_modality="Smiles")
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = jax_trainer.Trainer(jmodel, None, mesh=mesh, seed=0, **opt)
    state = jax.jit(jt.init_state)(batches[0])

    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), DATA_CONFIG, "Smiles")
    load_flax_params(model, jax.device_get(state.params))
    trainer = Trainer(model, seed=SEED, modality_dropout=DROPPED, **opt)
    assert not trainer.step_stats["graph"] and trainer.step_stats["eager_reason"] == "cpu device"
    masks = _record_masks(monkeypatch)
    got_losses, got_params = [], []
    for batch in batches:
        got_losses.append(float(trainer.train_step(batch)["loss"]))
        got_params.append({k: p.detach().numpy().copy() for k, p in model.named_parameters()})
    assert len(masks) == steps and trainer.step_stats["eager_steps"] == steps
    dropped = [[not m[:, s:e].any() for s, e in ((0, 12), (12, 26))] for m in masks]
    assert any(any(d) for d in dropped) and not all(any(d) for d in dropped), dropped

    step = jt._build_train_step(jax_trainer._modality_segments(
        batches[0]["encoder_inputs"], order=list(DATA_CONFIG)))
    schedule = optim.build_optimizer([torch.zeros(1)], optimiser, opt["lr"], steps).schedule
    for t, (batch, mask) in enumerate(zip(batches, masks)):
        dev = shard_batch(jax_trainer._device_batch(dict(batch, encoder_mask=mask)), mesh)
        state, metrics = step(state, dev, {})
        np.testing.assert_allclose(got_losses[t], float(metrics["loss"]), rtol=1e-5)
        want = {k: np.asarray(v) for k, v in flax_to_state_dict(
            jax.device_get(state.params)).items()}
        got = got_params[t]
        assert set(want) == set(got)
        noise_bound = 2 * sum(schedule(u) for u in range((t + 1) // acc_batches))
        for name in want:
            key = _key_bias(name, want[name].shape[0]) if want[name].ndim == 1 else None
            if key is None or not key.any():
                np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5,
                                           err_msg=f"{name} step {t}")
                continue
            np.testing.assert_allclose(got[name][~key], want[name][~key], rtol=0, atol=1e-5,
                                       err_msg=f"{name} step {t}")
            assert np.abs(got[name][key] - want[name][key]).max() <= noise_bound, name
    assert trainer.optimizer.count == steps // acc_batches


_bias_correction = jax.jit(lambda count, decay: 1 - decay ** count, static_argnums=1)


def _old_draw(n, step_seed):
    """The host draw as the modality dropout made it before the step was
    split: k from [0, n), then a random order; the first k dropped."""
    g = torch.Generator().manual_seed(step_seed)
    k = int(torch.randint(0, n, (1,), generator=g))
    order = torch.randperm(n, generator=g).tolist()
    return [0.0 if rank < k else 1.0 for rank in order]


@pytest.mark.parametrize("acc_batches", [1, 2])
def test_plan_follows_optax_and_the_host_draw_over_12_steps(monkeypatch, acc_batches):
    """12 mini-steps of a tiny model: after each, the plan's scalars hold
    the schedule's lr (optax's float32 schedule) and optax's float32 bias
    corrections of the update it completed, and the running mean's
    divisor; its keep vector is the (seed, step) draw of
    ``apply_modality_dropout``."""
    mini_steps, updates = 12, 12 // acc_batches
    model = Seq2SeqModel(ModelConfig(dropout=0.1, dtype="float32", **MODEL), DATA_CONFIG,
                         "Smiles", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, optimiser="adamw", lr=3e-3, num_steps=updates, seed=SEED,
                      acc_batches=acc_batches, modality_dropout=DROPPED)
    keeps, keep = [], trainer_module.modality_keep

    def recorded(n, generator):
        keeps.append(keep(n, generator))
        return keeps[-1]

    monkeypatch.setattr(trainer_module, "modality_keep", recorded)
    want_lr = optax.cosine_onecycle_schedule(transition_steps=max(updates, 4), peak_value=3e-3,
                                             pct_start=0.3, div_factor=25.0,
                                             final_div_factor=1e4)
    batches = _batches(2)
    count = 0
    for t in range(mini_steps):
        trainer.train_step(batches[t % 2])
        lr, bias1, bias2, divisor = trainer.optimizer.scalars.tolist()
        assert divisor == t % acc_batches + 1
        if (t + 1) % acc_batches == 0:
            count += 1
            np.testing.assert_allclose(lr, float(want_lr(count - 1)), rtol=1e-6)
            # optax's scale_by_adam, jitted as the JAX step runs it:
            # 1 - decay ** count, count an int32, in float32; bit-equal.
            for got, decay in ((bias1, B1), (bias2, B2)):
                assert got == float(_bias_correction(jnp.int32(count), decay)), count
        assert trainer.optimizer.count == count
        step_seed = (SEED * 1_000_003 + t) % 2 ** 63
        assert len(keeps) == 1
        drew = keeps.pop().tolist()
        assert drew == _old_draw(len(DROPPED), step_seed), t
        mask = torch.ones(2, 26, dtype=torch.int32)
        drawn = trainer_module.apply_modality_dropout(
            mask, [(0, 12), (12, 26)],
            torch.as_tensor(keep(2, torch.Generator().manual_seed(step_seed))))
        assert [float(drawn[:, s:e].all()) for s, e in ((0, 12), (12, 26))] == drew
        keeps.clear()
    # The schedule moved through its warm-up and its decay.
    lrs = [float(want_lr(c)) for c in range(updates)]
    assert max(lrs) > lrs[0] and lrs[-1] < max(lrs)


@pytest.mark.parametrize("acc_batches", [1, 2])
def test_resumed_fit_takes_the_uninterrupted_fits_losses(tmp_path, acc_batches):
    """3 batches an epoch, 2 epochs, dropout 0.1 and modality dropout: the
    fit cut at step 3 (mid-accumulation at ``acc_batches`` 2) and resumed
    from ``last`` in a new trainer takes the uninterrupted fit's losses and
    ends at its parameters and moments, bit for bit."""
    batches = _batches(3)

    def trainer():
        model = Seq2SeqModel(ModelConfig(dropout=0.1, dtype="float32", **MODEL), DATA_CONFIG,
                             "Smiles", generator=torch.Generator().manual_seed(0))
        return Trainer(model, optimiser="adamw", lr=3e-3, num_steps=6, seed=SEED,
                       acc_batches=acc_batches, modality_dropout=DROPPED)

    straight = trainer()
    want = straight.fit(batches, None, epochs=2)
    checkpoints = CheckpointManager(tmp_path / "ckpt")
    first = trainer()
    head = first.fit(batches, None, epochs=2, checkpoints=checkpoints, max_steps=3)
    resumed = trainer()
    tail = resumed.fit(batches, None, epochs=2, checkpoints=checkpoints, resume=True)
    assert len(want) == 6 and head + tail == want
    assert resumed.global_step == 6 and resumed.optimizer.count == straight.optimizer.count
    for got, ref in zip(resumed.params, straight.params):
        assert torch.equal(got, ref)
    for got, ref in zip(resumed.optimizer.mu + resumed.optimizer.nu,
                        straight.optimizer.mu + straight.optimizer.nu):
        assert torch.equal(got, ref)
