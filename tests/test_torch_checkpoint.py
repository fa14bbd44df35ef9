"""The port's fit loop and checkpoints (CPU): best/last/top-K, ``max_steps``,
resume equality, bit-exact round trips, the save cadence with its pinned
best, finetune loading and the JAX-params ``.npz`` route.

The policy tests mirror ``tests/test_trainer.py`` (cadence, pinned best,
``max_steps``) on the port's ``CheckpointManager`` and, for the cadence, on
a recorder with the manager's protocol (``save_async``, ``snapshot``,
``wait``), as the JAX tests' fakes have it.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator  # noqa: E402
from multimodalanalytical_tpu_torch.data.data_utils import fit_preprocessors  # noqa: E402
from multimodalanalytical_tpu_torch.data.datasets import TableDataset  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.training import DataLoader, Trainer  # noqa: E402
from multimodalanalytical_tpu_torch.training.checkpoint import (  # noqa: E402
    STATE_FILE,
    CheckpointManager,
    _migrate_fused_projections,
    load_finetune_params,
    restore_params,
    save_flax_npz,
)

SMILES_REGEX = (r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\\\|\/|:"
                r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")


@pytest.fixture(scope="module")
def setup():
    """tests/test_trainer.py's 16-row table, preprocessors and collator."""
    rng = np.random.default_rng(0)
    n = 16
    table = TableDataset({
        "Formula": ["C2H6O", "C2H7N"] * (n // 2),
        "IR": [rng.random(200).tolist() for _ in range(n)],
        "Smiles": ["CCO", "CCN"] * (n // 2),
    })
    config = {
        "Formula": {"type": "text", "column": "Formula", "target": False,
                    "preprocessor_arguments": {"tokenizer_regex": r"([A-Z]{1}[a-z]?[0-9]*)"}},
        "IR": {"type": "1D_patches", "column": "IR", "target": False,
               "preprocessor_arguments": {"patch_size": 50, "interpolation": False,
                                          "masking": False}},
        "Smiles": {"type": "text", "column": "Smiles", "target": True,
                   "preprocessor_arguments": {"tokenizer_regex": SMILES_REGEX}},
    }
    config, preps = fit_preprocessors(table.columns, config)
    collator = MultiModalCollator(preps, config, pad_to_batch_size=8)
    collator.fit_lengths(table.columns)
    return table, config, preps, collator


def _model(config, dropout=0.0):
    cfg = ModelConfig(d_model=32, encoder_layers=1, decoder_layers=1, encoder_attention_heads=4,
                      decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                      vocab_size=config["Smiles"]["vocab_size"],
                      pad_token_id=config["Smiles"]["pad_token_id"], max_target_length=16,
                      dropout=dropout)
    return Seq2SeqModel(cfg, config, "Smiles", generator=torch.Generator().manual_seed(0))


def _trainer(setup, **kw):
    table, config, preps, collator = setup
    return Trainer(_model(config), preps["Smiles"], num_steps=8, lr=1e-3, seed=0, **kw)


def _loader(setup, shuffle=True):
    table, _, _, collator = setup
    return DataLoader(table, collator, batch_size=8, shuffle=shuffle, prefetch=0)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_fit_checkpoints_best_last_and_top_k(setup, tmp_path):
    trainer = _trainer(setup)
    ckpts = CheckpointManager(tmp_path / "ckpt", top_k=2)
    losses = trainer.fit(_loader(setup), _loader(setup, shuffle=False), epochs=4,
                         checkpoints=ckpts, limit_val_batches=0.5)
    assert len(losses) == 8 and trainer.global_step == 8 and np.isfinite(losses).all()
    for name in ("last", "best"):
        assert (tmp_path / "ckpt" / name / "state.pt").exists()
    steps = sorted(p.name for p in (tmp_path / "ckpt").glob("step_*"))
    assert len(steps) == 2 and steps == sorted(e["name"] for e in ckpts._index["checkpoints"])
    last = ckpts.restore("last")
    assert last["step"] == 8 and last["opt_state"]["count"] == 8
    assert ckpts.best_step in {int(s.split("_")[1]) for s in steps}
    params = restore_params(tmp_path / "ckpt" / "best")
    assert all(torch.isfinite(v).all() for v in params.values())


def test_fit_max_steps_bounds_global_step(setup, tmp_path):
    """max_steps stops mid-epoch, validates there so ``best`` reflects the
    final state, and a resume at the bound trains nothing."""
    trainer = _trainer(setup)
    ckpts = CheckpointManager(tmp_path / "ckpt")
    # 2 batches per epoch; 4 epochs would be 8 steps: the bound wins at 3.
    losses = trainer.fit(_loader(setup), _loader(setup), epochs=4, checkpoints=ckpts,
                         max_steps=3)
    assert len(losses) == 3 and trainer.global_step == 3
    assert (tmp_path / "ckpt" / "best").exists() and ckpts.restore("last")["step"] == 3
    again = _trainer(setup)
    assert again.fit(_loader(setup), None, epochs=4, checkpoints=ckpts, resume=True,
                     max_steps=3) == []
    assert again.global_step == 3


def test_resume_equals_the_uninterrupted_run(setup, tmp_path):
    """2 + 2 steps through a checkpoint = 4 steps, params bit for bit: the
    resume restores params, optimizer state and step, and advances the
    shuffling loader's epoch counter."""
    straight = _trainer(setup)
    straight.fit(_loader(setup), None, epochs=2)
    ckpts = CheckpointManager(tmp_path / "ckpt")
    first = _trainer(setup)
    first.fit(_loader(setup), None, epochs=2, checkpoints=ckpts, max_steps=2)
    resumed = _trainer(setup)
    resumed.fit(_loader(setup), None, epochs=2, checkpoints=ckpts, resume=True)
    assert resumed.global_step == straight.global_step == 4
    assert resumed.optimizer.count == 4
    want, got = _params(straight.model), _params(resumed.model)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_checkpoint_round_trip_is_bit_exact(setup, tmp_path):
    trainer = _trainer(setup)
    trainer.fit(_loader(setup), None, epochs=1)
    ckpts = CheckpointManager(tmp_path / "ckpt")
    ckpts.save(trainer.global_step, trainer.state_tree(), {"val_molecular_accuracy": 0.5})
    fresh = _trainer(setup)
    fresh.load_state_tree(ckpts.restore("last"))
    for name, value in _params(trainer.model).items():
        assert torch.equal(fresh.model.state_dict()[name], value), name
    want, got = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert (got["count"], got["mini_step"]) == (want["count"], want["mini_step"])
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key]))
    best = restore_params(tmp_path / "ckpt" / "best")
    assert set(best) == set(_params(trainer.model))
    assert ckpts.best_step == trainer.global_step


class _Saves:
    """Records what the trainer saves (step, monitored value), through the
    manager's protocol: ``save_async``, ``snapshot`` (the tree itself),
    ``wait``."""

    def __init__(self):
        self.saves = []

    def save_async(self, step, tree, metrics, fresh=()):
        self.saves.append((step, metrics.get("val_molecular_accuracy")))

    def snapshot(self, tree, fresh=()):
        return tree

    def wait(self, timeout_s=None):
        return True


def _scripted(trainer, accuracies):
    values = iter(accuracies)
    trainer.validate = lambda *a, **k: {"val_loss": 0.0, "val_token_acc": 0.0,
                                        "val_molecular_accuracy": next(values)}


def _validate_at(trainer, ckpts, steps, best, patience=100, patience_left=100):
    for step in steps:
        trainer.global_step = step
        _, best, patience_left = trainer._run_validation(None, 1.0, ckpts, None, step, patience,
                                                         best, patience_left)
    return best, patience_left


@pytest.mark.parametrize("every,patience,accuracies,want", [
    # Steady improvement, every 3: val 1 (first improvement), 3 (cadence), 4
    # (improvement, >= 3 after val 1), 6 (cadence), 7 (improvement).
    (3, 100, [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7], [0.1, 0.3, 0.4, 0.6, 0.7]),
    # Without early stopping a non-improving validation is no improvement:
    # val 1 improvement, val 2 cadence, val 3 (0.4 < 0.5) not saved, val 4.
    (2, None, [0.5, 0.3, 0.4, 0.6], [0.5, 0.3, 0.6]),
])
def test_save_cadence_rate_limits_improvement_saves(setup, every, patience, accuracies, want):
    trainer = _trainer(setup, checkpoint_every_n_vals=every)
    _scripted(trainer, accuracies)
    ckpts = _Saves()
    _validate_at(trainer, ckpts, range(len(accuracies)), -float("inf"), patience, patience)
    assert [acc for _, acc in ckpts.saves] == want


def test_rate_suppressed_improvement_is_never_lost(setup):
    """A suppressed improvement is pinned and saved by the next due save
    (in place of the worse current state) or at the end of the fit."""
    trainer = _trainer(setup, checkpoint_every_n_vals=3)
    ckpts = _Saves()
    _scripted(trainer, [0.1, 0.9, 0.2, 0.3, 0.85])
    best, _ = _validate_at(trainer, ckpts, range(5), -float("inf"))
    assert ckpts.saves == [(0, 0.1), (1, 0.9)]
    assert trainer._pending_best is None
    _scripted(trainer, [0.95, 0.97])
    _validate_at(trainer, ckpts, (5, 6), best)
    assert ckpts.saves[-1] == (5, 0.95) and trainer._pending_best is not None
    pinned_step, pinned_tree, _ = trainer._pending_best
    assert pinned_step == 6 and pinned_tree["step"] == 6
    trainer._flush_pending_best(ckpts)
    assert ckpts.saves[-1] == (6, 0.97) and trainer._pending_best is None


def test_early_stopping_counts_patience(setup):
    trainer = _trainer(setup)
    _scripted(trainer, [0.5, 0.4, 0.3])
    stops = []
    best, left = -float("inf"), 2
    for step in range(3):
        stop, best, left = trainer._run_validation(None, 1.0, None, None, step, 2, best, left)
        stops.append(stop)
    assert stops == [False, False, True]


def test_finetune_load_strips_align_and_checks_counts(setup, tmp_path):
    trainer = _trainer(setup)
    ckpts = CheckpointManager(tmp_path / "ckpt")
    tree = trainer.state_tree()
    ckpts.save(0, tree, {})
    params, dropped = load_finetune_params(tmp_path / "ckpt" / "last", trainer.model,
                                           strip_align=True)
    assert dropped == 0 and set(params) == set(trainer.model.state_dict())
    with_align = dict(tree, params={**tree["params"], "align_network.w": torch.zeros(3)})
    ckpts.save(1, with_align, {})
    params, dropped = load_finetune_params(tmp_path / "ckpt" / "last", trainer.model,
                                           strip_align=True)
    assert dropped == 1 and "align_network.w" not in params
    with pytest.raises(ValueError, match="mismatch"):
        load_finetune_params(tmp_path / "ckpt" / "last", trainer.model, strip_align=False)


def test_jax_params_npz_round_trip_and_fused_projection_migration(tmp_path):
    """A JAX param tree written as ``.npz`` comes back under the port's
    names (kernels transposed); pre-fusion q/k/v projections are fused as
    the JAX ``_migrate_fused_projections`` fuses them."""
    from multimodalanalytical_tpu_torch.models.weights import flax_to_state_dict

    rng = np.random.default_rng(0)

    def dense(i, o):
        return {"kernel": rng.random((i, o)).astype(np.float32),
                "bias": rng.random(o).astype(np.float32)}

    old = {"encoder": {"layer_0": {"self_attn": {
        "q_proj": dense(8, 8), "k_proj": dense(8, 8), "v_proj": dense(8, 8),
        "out_proj": dense(8, 8)}}},
        "decoder": {"layer_0": {"cross_attn": {
            "q_proj": dense(8, 8), "k_proj": dense(8, 8), "v_proj": dense(8, 8)}}}}
    new = _migrate_fused_projections(old)
    enc = new["encoder"]["layer_0"]["self_attn"]
    assert set(enc) == {"qkv_proj", "out_proj"} and enc["qkv_proj"]["kernel"].shape == (8, 24)
    np.testing.assert_array_equal(enc["qkv_proj"]["kernel"][:, :8],
                                  old["encoder"]["layer_0"]["self_attn"]["q_proj"]["kernel"])
    cross = new["decoder"]["layer_0"]["cross_attn"]
    assert set(cross) == {"q_proj", "kv_proj"}
    np.testing.assert_array_equal(cross["kv_proj"]["kernel"][:, 8:],
                                  old["decoder"]["layer_0"]["cross_attn"]["v_proj"]["kernel"])

    path = save_flax_npz(tmp_path / "params.npz", old)
    got = restore_params(path)
    want = flax_to_state_dict(new)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value)


@pytest.mark.parametrize("first_save", [True, False])
def test_a_save_cut_short_leaves_the_previous_last(tmp_path, monkeypatch, first_save):
    """A save that dies while writing (the file half written, then an
    error) leaves ``last`` as it was: absent before the first save, else
    the previous state file whole. The next save completes it."""
    manager = CheckpointManager(tmp_path / "ckpt")
    if not first_save:
        manager.save(1, {"w": torch.ones(3)}, {})
    save = torch.save

    def cut_short(obj, path):
        Path(path).write_bytes(b"torn")
        raise OSError("killed mid-save")

    monkeypatch.setattr(torch, "save", cut_short)
    with pytest.raises(OSError):
        manager.save(2, {"w": torch.full((3,), 2.0)}, {})
    monkeypatch.setattr(torch, "save", save)
    last = tmp_path / "ckpt" / "last"
    if first_save:
        assert not last.exists()
    else:
        assert torch.equal(manager.restore("last")["w"], torch.ones(3))
    manager.save(3, {"w": torch.full((3,), 3.0)}, {})
    assert torch.equal(manager.restore("last")["w"], torch.full((3,), 3.0))
    assert sorted(p.name for p in last.iterdir()) == [STATE_FILE]
    assert not (tmp_path / "ckpt" / ".last.partial").exists()
