"""The port's optimizer and train step against optax and the JAX ``Trainer``.

Schedule, clipping and accumulation are held against optax itself. The
trainer runs one and three steps beside the JAX ``Trainer`` on the same
params (the JAX ``init_state`` params, carried by ``load_flax_params``) and
the same seeded batches, fp32, dropout 0 and no modality dropout, on a
tiny model of the flagship's Formula + IR patches recipe (no flash; the
long-sequence RLE case is ``tests/test_torch_train_rle.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.parallel.mesh import make_mesh, shard_batch  # noqa: E402
from multimodalanalytical_tpu.training import trainer as jax_trainer  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.training import optim  # noqa: E402
from multimodalanalytical_tpu_torch.training.trainer import (  # noqa: E402
    Trainer,
    apply_modality_dropout,
    modality_keep,
    modality_segments,
)

TARGET_VOCAB = 40
RLE_VOCAB = 105      # the RLE vocabulary fitted on tests/test_data/ir_dataset
RLE_LEN = 2100
OPTIMISER = dict(optimiser="adamw", lr=2e-3, weight_decay=0.01, num_steps=3, clip_grad=1.0)


# ------------------------------------------------------------- optimizer


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((5, 3))).astype(np.float32),
            "b": (scale * rng.standard_normal(7)).astype(np.float32)}


@pytest.mark.parametrize("num_steps", [1, 2, 3, 4, 5])
def test_onecycle_schedule_matches_optax(num_steps):
    """The LR at every update count, with the horizon floored at 4 as
    ``build_optimizer`` does; float32 on the optax side."""
    opt = optim.build_optimizer([torch.zeros(1)], "adam", 3e-3, num_steps)
    want = optax.cosine_onecycle_schedule(transition_steps=max(num_steps, 4), peak_value=3e-3,
                                          pct_start=0.3, div_factor=25.0, final_div_factor=1e4)
    for count in range(num_steps + 3):
        np.testing.assert_allclose(opt.schedule(count), float(want(count)), rtol=1e-6)


@pytest.mark.parametrize("norm_over_bound", [0.5, 1.0 - 1e-4, 1.0 + 1e-4, 30.0])
def test_clip_by_global_norm_matches_optax(norm_over_bound):
    """Exactly ``g * max_norm / norm`` at and above the bound, identity below.
    With the bound at 1e-3, torch's ``clip_grad_norm_`` (norm + 1e-6 in the
    divisor, applied below the bound too) is off by ~1e-3 relative in both
    near-bound cases; this holds the port to 1e-6."""
    max_norm = 1e-3
    grads = _tree(0)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    grads = {k: (g * (norm_over_bound * max_norm / norm)).astype(np.float32)
             for k, g in grads.items()}
    want, _ = optax.clip_by_global_norm(max_norm).update(grads, optax.EmptyState())
    got = optim.clip_by_global_norm([torch.as_tensor(grads[k]) for k in ("w", "b")], max_norm)
    for g, key in zip(got, ("w", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("optimiser,acc_batches,num_steps",
                         [("adamw", 2, n) for n in (1, 2, 3, 4, 5)] + [("adam", 1, 3)])
def test_optimizer_updates_match_optax(optimiser, acc_batches, num_steps):
    """Seven gradients through clip -> adam/adamw -> MultiSteps: params after
    every gradient, and the update counts (optax's gradient_step and
    mini_step), against optax's own chain as the JAX ``build_optimizer``
    builds it. Some gradients are above the clip bound."""
    tx = jax_trainer.build_optimizer(optimiser, 1e-2, num_steps, weight_decay=0.05,
                                     clip_grad=1.0, acc_batches=acc_batches)
    params = _tree(1)
    state = tx.init(params)
    update = jax.jit(tx.update)
    names = ("w", "b")
    ours = [torch.tensor(params[k]) for k in names]
    opt = optim.build_optimizer(ours, optimiser, 1e-2, num_steps, weight_decay=0.05,
                                clip_grad=1.0, acc_batches=acc_batches)
    for i in range(7):
        grads = _tree(10 + i, scale=0.2 if i % 2 else 1.0)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.as_tensor(grads[k]) for k in names])
        for p, key in zip(ours, names):
            np.testing.assert_allclose(p.numpy(), np.asarray(params[key]), rtol=1e-6, atol=1e-7)
        if acc_batches > 1:
            assert opt.count == int(state.gradient_step)
            assert opt.mini_step == int(state.mini_step)
    assert opt.count == 7 // acc_batches


# -------------------------------------------------------- modality dropout


def test_modality_segments_match_jax():
    inputs = {"IR": np.zeros((2, 14, 125)), "Formula": np.zeros((2, 12)),
              "RLE": np.zeros((2, 30))}
    order = ["Formula", "RLE", "IR", "Smiles"]
    assert modality_segments(inputs, order) == jax_trainer._modality_segments(inputs, order)


@pytest.mark.parametrize("n_droppable", [1, 2, 3])
def test_modality_dropout_zeroes_segments_and_never_all(n_droppable):
    segments = [(0, 4), (4, 10), (10, 13)][:n_droppable]
    mask = torch.ones(3, 16, dtype=torch.int32)
    mask[1, 14:] = 0
    g = torch.Generator().manual_seed(0)
    dropped_counts = set()
    for _ in range(200):
        keep = torch.as_tensor(modality_keep(n_droppable, g))
        out = apply_modality_dropout(mask, segments, keep)
        dropped = [bool((out[:, s:e] == 0).all()) for s, e in segments]
        for (s, e), gone in zip(segments, dropped):
            assert torch.equal(out[:, s:e], torch.zeros_like(out[:, s:e]) if gone
                               else mask[:, s:e])
        assert torch.equal(out[:, 13:], mask[:, 13:])
        assert not all(dropped)
        dropped_counts.add(sum(dropped))
    assert dropped_counts == set(range(n_droppable))
    assert apply_modality_dropout(mask, [], torch.ones(0)) is mask


# ----------------------------------------------------------------- trainer


def _rle_case():
    data_config = {
        "RLE": {"type": "run_length_encoding", "vocab_size": RLE_VOCAB, "target": False},
        "Smiles": {"type": "text", "vocab_size": TARGET_VOCAB, "target": True},
    }
    model = dict(d_model=128, encoder_attention_heads=2, decoder_attention_heads=2,
                 encoder_ffn_dim=256, decoder_ffn_dim=256, max_position_embeddings=4096)
    return data_config, model, lambda rng, b: {"RLE": rng.integers(1, RLE_VOCAB, (b, RLE_LEN))}


def _patch_case():
    data_config = {
        "Formula": {"type": "text", "vocab_size": 32, "target": False},
        "IR": {"type": "1D_patches", "target": False,
               "preprocessor_arguments": {"patch_size": 125}},
        "Smiles": {"type": "text", "vocab_size": TARGET_VOCAB, "target": True},
    }
    model = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4,
                 encoder_ffn_dim=128, decoder_ffn_dim=128)
    return data_config, model, lambda rng, b: {
        "Formula": rng.integers(1, 32, (b, 12)),
        "IR": rng.random((b, 14, 125)).astype(np.float32)}


def _batches(make_inputs, steps, batch=2, target_len=12):
    """Seeded collated-style batches: tail-padded sources, padded targets."""
    out = []
    for step in range(steps):
        rng = np.random.default_rng(100 + step)
        enc = {m: x.astype(np.float32 if x.dtype.kind == "f" else np.int32)
               for m, x in make_inputs(rng, batch).items()}
        length = sum(x.shape[1] for x in enc.values())
        mask = np.ones((batch, length), np.int32)
        mask[-1, length - 250 + 17 * step:] = 0
        dec = rng.integers(4, TARGET_VOCAB, (batch, target_len)).astype(np.int32)
        dmask = np.ones((batch, target_len), np.int32)
        dmask[0, 9:] = 0
        labels = rng.integers(4, TARGET_VOCAB, (batch, target_len)).astype(np.int32)
        labels[0, 8:] = -100
        out.append({"encoder_inputs": enc, "encoder_mask": mask, "decoder_ids": dec,
                    "decoder_mask": dmask, "labels": labels, "n_valid": batch})
    return out


def _run_both(case, steps=3):
    """Losses of every step and the params after step 1 and after the last,
    for the JAX Trainer and the port's, from the same initial params."""
    data_config, model_kw, make_inputs = case()
    cfg = JaxConfig(encoder_layers=1, decoder_layers=1, vocab_size=TARGET_VOCAB, dropout=0.0,
                    dtype="float32", **model_kw)
    batches = _batches(make_inputs, steps)
    jmodel = JaxModel(config=cfg, data_config=data_config, target_modality="Smiles")
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = jax_trainer.Trainer(jmodel, None, mesh=mesh, seed=0, **OPTIMISER)
    # init_state compiled: the same params as the eager call (the same
    # seeded keys), in a quarter of the time on the CPU.
    state = jax.jit(jt.init_state)(batches[0])
    init_params = jax.device_get(state.params)
    step = jt._build_train_step(jax_trainer._modality_segments(
        batches[0]["encoder_inputs"], order=list(data_config)))
    want_losses, want_params = [], []
    for batch in batches:
        state, metrics = step(state, shard_batch(jax_trainer._device_batch(batch), mesh), {})
        want_losses.append(float(metrics["loss"]))
        want_params.append(load_params_as_numpy(jax.device_get(state.params)))

    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), data_config, "Smiles")
    load_flax_params(model, init_params)
    trainer = Trainer(model, seed=0, **OPTIMISER)
    got_losses, got_params = [], []
    for batch in batches:
        got_losses.append(float(trainer.train_step(batch)["loss"]))
        got_params.append({k: p.detach().numpy().copy() for k, p in model.named_parameters()})
    return want_losses, want_params, got_losses, got_params


def load_params_as_numpy(params):
    from multimodalanalytical_tpu_torch.models.weights import flax_to_state_dict

    return {k: np.asarray(v) for k, v in flax_to_state_dict(params).items()}


@pytest.fixture(scope="module")
def patch_run():
    return _run_both(_patch_case)


def _key_bias(name, size):
    """The entries of a bias that add a constant to every key of a row: the
    k part of the fused self-attention qkv bias and of the cross kv bias."""
    mask = np.zeros(size, bool)
    if name.endswith("self_attn.qkv_proj.bias"):
        mask[size // 3: 2 * size // 3] = True
    elif name.endswith("cross_attn.kv_proj.bias"):
        mask[: size // 2] = True
    return mask


def _check(run, steps):
    want_losses, want_params, got_losses, got_params = run
    # fp32 on both sides; the losses differ only in summation order.
    np.testing.assert_allclose(got_losses[:steps], want_losses[:steps], rtol=1e-5)
    want, got = want_params[steps - 1], got_params[steps - 1]
    assert set(want) == set(got)
    # The key biases shift every logit of a row by the same amount, so their
    # true gradient is 0 (softmax is shift-invariant) and each package sees
    # only its own rounding noise, which Adam's normalisation scales up to
    # as much as one learning rate per step. They are held to that bound;
    # every other entry to 1e-5.
    schedule = optim.build_optimizer([torch.zeros(1)], "adamw", OPTIMISER["lr"],
                                     OPTIMISER["num_steps"]).schedule
    noise_bound = 2 * sum(schedule(t) for t in range(steps))
    for name in want:
        key = _key_bias(name, want[name].shape[0]) if want[name].ndim == 1 else None
        if key is None or not key.any():
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=name)
            continue
        np.testing.assert_allclose(got[name][~key], want[name][~key], rtol=0, atol=1e-5,
                                   err_msg=name)
        assert np.abs(got[name][key] - want[name][key]).max() <= noise_bound, name


@pytest.mark.parametrize("steps", [1, 3])
def test_patch_trainer_matches_jax_trainer(patch_run, steps):
    _check(patch_run, steps)


def test_fit_takes_max_steps_and_returns_losses():
    data_config, model_kw, make_inputs = _patch_case()
    cfg = ModelConfig(encoder_layers=1, decoder_layers=1, vocab_size=TARGET_VOCAB, dropout=0.1,
                      **model_kw)
    model = Seq2SeqModel(cfg, data_config, "Smiles")
    trainer = Trainer(model, optimiser="adamw", lr=1e-3, num_steps=5, seed=0,
                      modality_dropout=["Formula", "IR"])
    losses = trainer.fit(_batches(make_inputs, 2), epochs=3, max_steps=5, log_every=2)
    assert len(losses) == 5 and trainer.global_step == 5 and trainer.optimizer.count == 5
    assert np.isfinite(losses).all()
    with pytest.raises(ValueError, match="generator"):
        b = _batches(make_inputs, 1)[0]
        model({k: torch.as_tensor(v) for k, v in b["encoder_inputs"].items()},
              *(torch.as_tensor(b[k]) for k in ("encoder_mask", "decoder_ids", "decoder_mask",
                                                  "labels")), deterministic=False)


def _tiny_trainer():
    data_config, model_kw, make_inputs = _patch_case()
    cfg = ModelConfig(encoder_layers=1, decoder_layers=1, vocab_size=TARGET_VOCAB, **model_kw)
    trainer = Trainer(Seq2SeqModel(cfg, data_config, "Smiles"), optimiser="adamw", lr=1e-3,
                      num_steps=7, seed=0)
    return trainer, _batches(make_inputs, 1)


@pytest.mark.parametrize("steps,window", [(7, "2-6"), (8, "2-6"), (3, "2-2"), (4, "2-3")])
def test_fit_profile_dir_traces_steps_2_to_6(tmp_path, steps, window):
    """``profile_dir`` traces the steps at global steps 2-6, as the JAX
    trainer does; a shorter fit writes the steps it took and leaves no
    profiler running."""
    import json

    trainer, batches = _tiny_trainer()
    losses = trainer.fit(batches, epochs=steps, profile_dir=str(tmp_path / "profile"))
    assert len(losses) == steps
    assert not torch.autograd._profiler_enabled()
    traces = sorted((tmp_path / "profile").iterdir())
    assert [t.name for t in traces] == [f"train_steps_{window}.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_fit_without_profile_dir_starts_no_profiler(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was started without profile_dir")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    trainer, batches = _tiny_trainer()
    assert len(trainer.fit(batches, epochs=7, profile_dir=None)) == 7
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("shuffle,num_shards,prefetch", [(False, 1, 0), (True, 2, 2)])
def test_loader_copy_yields_the_jax_loaders_batches(shuffle, num_shards, prefetch):
    """The port's numpy-only DataLoader copy against the JAX package's, on
    the same table: same batches in the same order, shards and dummy rows
    included, over two epochs."""
    from multimodalanalytical_tpu.data.datasets import TableDataset as JaxTable
    from multimodalanalytical_tpu.training.loader import DataLoader as JaxLoader
    from multimodalanalytical_tpu_torch.data.datasets import TableDataset
    from multimodalanalytical_tpu_torch.training import DataLoader

    columns = {"x": list(range(11)), "y": [f"s{i}" for i in range(11)]}
    table, jax_table = TableDataset(dict(columns)), JaxTable(dict(columns))

    def collate(columns):
        return {"x": np.asarray(columns["x"]), "y": list(columns["y"]),
                "encoder_mask": np.ones((len(columns["x"]), 2)), "n_valid": len(columns["x"])}

    for shard in range(num_shards):
        kw = dict(batch_size=4, shuffle=shuffle, seed=3, prefetch=prefetch,
                  num_shards=num_shards, shard_index=shard)
        ours, theirs = DataLoader(table, collate, **kw), JaxLoader(jax_table, collate, **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a["y"] == b["y"] and a["n_valid"] == b["n_valid"]
                np.testing.assert_array_equal(a["x"], b["x"])
                np.testing.assert_array_equal(a["encoder_mask"], b["encoder_mask"])


def test_dropout_is_inverted_and_seeded():
    """Kept elements scaled by 1 / (1 - rate), about ``rate`` of them zeroed,
    the same mask for the same seed; identity for rate 0 or no generator."""
    from multimodalanalytical_tpu_torch.ops.dropout import dropout

    x = torch.full((200, 500), 2.0)
    out = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0 / 0.9))
    assert abs(1 - kept.float().mean().item() - 0.1) < 0.005
    assert torch.equal(out, dropout(x, 0.1, torch.Generator().manual_seed(0)))
    assert dropout(x, 0.0, torch.Generator()) is x and dropout(x, 0.1, None) is x
    assert torch.equal(dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))


def test_training_forward_applies_dropout_at_the_jax_sites(monkeypatch):
    """Per layer, as the JAX layers: the encoder drops its attention output
    and the FFN hidden and output (3 sites), the decoder its self- and
    cross-attention outputs and the FFN's two (4 sites). Deterministic mode
    draws nothing and returns the inference forward's loss."""
    from multimodalanalytical_tpu_torch.models import transformer

    data_config, model_kw, make_inputs = _patch_case()
    cfg = ModelConfig(encoder_layers=2, decoder_layers=1, vocab_size=TARGET_VOCAB, dropout=0.1,
                      **model_kw)
    model = Seq2SeqModel(cfg, data_config, "Smiles")
    b = _batches(make_inputs, 1)[0]
    args = ({k: torch.as_tensor(v) for k, v in b["encoder_inputs"].items()},
            *(torch.as_tensor(b[k]) for k in ("encoder_mask", "decoder_ids", "decoder_mask",
                                               "labels")))
    drawn = []
    original = transformer.dropout

    def counting(x, rate, generator):
        drawn.append(generator is not None)
        return original(x, rate, generator)

    monkeypatch.setattr(transformer, "dropout", counting)
    with torch.no_grad():
        train = model(*args, deterministic=False, generator=torch.Generator().manual_seed(1))
        assert drawn == [True] * (2 * 3 + 1 * 4)
        drawn.clear()
        infer = model(*args)
    assert not any(drawn)
    assert float(train["loss"]) != float(infer["loss"])
