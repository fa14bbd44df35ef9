"""The port's device-side mixture synthesis against the JAX package's.

The five cases of ``tests/test_device_mixture.py`` through the port, each
beside the JAX package's own functions on the same pool and seed: the
index streams (and their replay of the host generator), the premix of the
same index batches (ids bit-equal, floats within 1e-6 of the batch's
largest magnitude), a fit on the device route against the host route
(rtol 5e-4, JAX's own bound), the cases where the route is refused, and
the loader's final partial batch. A partial batch's padding rows are the
host collator's padding in the port; the JAX premix leaves NaN patches
there, so they are compared on the masks and labels only.
"""

import copy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")

from multimodalanalytical_tpu.data import device_mixture as jax_dm  # noqa: E402
from multimodalanalytical_tpu.data.collator import MultiModalCollator as JaxCollator  # noqa: E402
from multimodalanalytical_tpu.data.data_utils import (  # noqa: E402
    fit_preprocessors as jax_fit_preprocessors,
)
from multimodalanalytical_tpu.data.datasets import (  # noqa: E402
    IterableDatasetWithLength as JaxStream,
)
from multimodalanalytical_tpu.data.datasets import TableDataset as JaxTable  # noqa: E402
from multimodalanalytical_tpu.data.datasets import multi_config_mix as jax_mix  # noqa: E402
from multimodalanalytical_tpu_torch.data import device_mixture as dm  # noqa: E402
from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator  # noqa: E402
from multimodalanalytical_tpu_torch.data.data_utils import fit_preprocessors  # noqa: E402
from multimodalanalytical_tpu_torch.data.datasets import (  # noqa: E402
    IterableDatasetWithLength,
    TableDataset,
    multi_config_mix,
)
from multimodalanalytical_tpu_torch.models.config import AlignConfig, ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.parallel import multihost  # noqa: E402
from multimodalanalytical_tpu_torch.training.loader import DataLoader  # noqa: E402
from multimodalanalytical_tpu_torch.training.trainer import Trainer, device_batch  # noqa: E402

SMILES_REGEX = (
    r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\\\|\/|:"
    r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])"
)
PATCH_ARGS = {"patch_size": 100, "interpolation": False, "masking": False}
DATA_CONFIG = {
    "Formula": {"type": "text", "column": "Formula", "target": False,
                "preprocessor_arguments": {"tokenizer_regex": r"([A-Z]{1}[a-z]?[0-9]*)"}},
    "IR": {"type": "1D_patches", "column": "IR", "target": False,
           "preprocessor_arguments": dict(PATCH_ARGS)},
    "IR_target": {"type": "1D_patches", "column": "", "target": True, "alignment": True,
                  "preprocessor_arguments": dict(PATCH_ARGS)},
    "Smiles": {"type": "text", "column": "Smiles", "target": True,
               "preprocessor_arguments": {"tokenizer_regex": SMILES_REGEX}},
}
SEED = 3247
FLOAT_TOL = 1e-6     # of the batch's largest magnitude
FIT_RTOL = 5e-4      # tests/test_device_mixture.py's bound, device route against host


def _mode(n_compounds=2, ratio=None, samples=64, normalize=False):
    return {"n_compounds": n_compounds, "compounds_ratio": ratio,
            "train_max_n_samples": samples, "parallel_samples": 8, "normalize": normalize}


BINARY = {"balanced": _mode(ratio=[0.3, 0.7], normalize=True)}
TERNARY = {"balanced": _mode(n_compounds=3, samples=120)}
MULTITASK = {"balanced": _mode(normalize=True),
             "unbalanced_3_7": _mode(ratio=[0.3, 0.7], normalize=True),
             "unbalanced_0_10": _mode(ratio=[0.0, 1.0], normalize=True)}
MIXTURES = {"binary": BINARY, "ternary": TERNARY, "multitask": MULTITASK}


def _columns(n=12, length=1800):
    rng = np.random.default_rng(1)
    return {"Smiles": [f"{'C' * (i + 1)}O" for i in range(n)],
            "Formula": [f"C{i + 1}H{2 * i + 4}O" for i in range(n)],
            "IR": [rng.random(length).tolist() for _ in range(n)]}


def _pipeline(mixture_config, length, batch_size=4, port=True, spectrum_length=1800):
    """(stream, data config, preprocessors, collator) of the port or of the JAX package."""
    table_cls, stream_cls, mix, fit, collator_cls = (
        (TableDataset, IterableDatasetWithLength, multi_config_mix, fit_preprocessors,
         MultiModalCollator) if port else
        (JaxTable, JaxStream, jax_mix, jax_fit_preprocessors, JaxCollator))
    pool = table_cls(_columns(length=spectrum_length))
    stream = stream_cls(generator_fn=mix,
                        generator_args={"dataset": pool, "mixture_config": mixture_config,
                                        "split": "train", "seed": SEED},
                        length=length, split="train")
    sampled = stream.take(min(length, 48))
    config, preps = fit(sampled.columns, copy.deepcopy(DATA_CONFIG))
    collator = collator_cls(preps, config, pad_to_batch_size=batch_size)
    collator.fit_lengths(sampled.columns)
    return stream, config, preps, collator


def _build(mixture_config, length, batch_size=4, port=True, **kwargs):
    stream, config, preps, collator = _pipeline(mixture_config, length, batch_size, port,
                                                **kwargs)
    build = dm.try_build_device_mixture if port else jax_dm.try_build_device_mixture
    extra = {"device": torch.device("cpu")} if port else {}
    return build(stream, config, preps, collator, batch_size=batch_size, seed=SEED, **extra)


def _near(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= FLOAT_TOL, f"{what}: {err:.3e} of the largest magnitude"


def _batch_numpy(batch):
    return {k: ({m: v.numpy() for m, v in val.items()} if isinstance(val, dict)
                else val.numpy()) for k, val in batch.items()}


# ------------------------------------------------------------ index streams


@pytest.mark.parametrize("name", list(MIXTURES))
def test_index_streams_equal_the_jax_streams_and_replay_the_host_generator(name):
    mixture_config = MIXTURES[name]
    columns = _columns()
    ours = list(dm.multi_config_index_stream(mixture_config, 12, "train", seed=11))
    theirs = list(jax_dm.multi_config_index_stream(mixture_config, 12, "train", seed=11))
    assert len(ours) == len(theirs) > 0
    for (idx, comp, ratios, norm), (j_idx, j_comp, j_ratios, j_norm) in zip(ours, theirs):
        np.testing.assert_array_equal(idx, j_idx)
        assert (comp, ratios, norm) == (j_comp, j_ratios, j_norm)
    single = list(dm.mixture_index_stream(12, next(iter(mixture_config.values())), "train", 11))
    j_single = list(jax_dm.mixture_index_stream(12, next(iter(mixture_config.values())),
                                                "train", 11))
    assert [(tuple(i), c) for i, c, _, _ in single] == [(tuple(i), c) for i, c, _, _ in j_single]

    # The port's host generator yields the sample each decision names.
    host = list(multi_config_mix(TableDataset(columns), mixture_config, "train", seed=11))
    assert len(host) == len(ours)
    for sample, (idx, comp, ratios, _) in zip(host, ours):
        assert sample["Smiles"] == columns["Smiles"][idx[comp]]
        assert sample["Formula"] == columns["Formula"][idx[comp]]
        assert sample["Percentage"] == f"{np.asarray(ratios)[comp]}"
        assert sample["Additional_smiles"] == ",".join(
            columns["Smiles"][idx[j]] for j in range(len(idx)) if j != comp)


# ------------------------------------------------------------------ premix


@pytest.mark.parametrize("name,length,spectrum_length", [
    ("multitask", 42, 1800),     # last batch: 2 real rows of 4
    ("ternary", 37, 1791),       # the real spectra's length, padded to 1800; 1 real row
])
def test_premix_equals_the_jax_premix_and_the_host_collator(name, length, spectrum_length):
    mixture_config = MIXTURES[name]
    ours = _build(mixture_config, length, spectrum_length=spectrum_length)
    theirs = _build(mixture_config, length, port=False, spectrum_length=spectrum_length)
    assert ours is not None and theirs is not None
    assert set(ours.consts) == set(theirs.consts)
    for key, value in ours.consts.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(theirs.consts[key]), key)
    assert ours.pool_bytes == theirs.pool_bytes

    stream, _, _, collator = _pipeline(mixture_config, length, spectrum_length=spectrum_length)
    host = DataLoader(stream, collator, batch_size=4, prefetch=0)
    jax_premix = jax.jit(theirs.premix)
    index_batches = list(ours.loader)
    assert len(index_batches) == len(host) == len(list(theirs.loader))
    assert index_batches[-1]["n_valid"] < 4
    for index_batch, jax_index_batch, host_batch in zip(index_batches, theirs.loader, host):
        for key in index_batch:
            np.testing.assert_array_equal(index_batch[key], jax_index_batch[key])
        got = _batch_numpy(ours.premix(ours.consts, device_batch(index_batch, "cpu")))
        want = jax.device_get(jax_premix(theirs.consts, jax_index_batch))
        rows = index_batch["row_valid"]

        # Against the JAX premix: every mask and label; ids and floats on real rows.
        for key in ("encoder_mask", "decoder_mask", "labels"):
            np.testing.assert_array_equal(got[key], want[key], key)
        for key in ("decoder_ids",):
            np.testing.assert_array_equal(got[key][rows], want[key][rows], key)
        np.testing.assert_array_equal(got["encoder_inputs"]["Formula"][rows],
                                      want["encoder_inputs"]["Formula"][rows])
        _near(got["encoder_inputs"]["IR"][rows], want["encoder_inputs"]["IR"][rows], "IR")
        _near(got["align_target"], want["align_target"], "align_target")

        # Against the host collator's batch of the same samples: every row.
        assert host_batch["n_valid"] == index_batch["n_valid"]
        for key in ("encoder_mask", "decoder_ids", "decoder_mask", "labels"):
            np.testing.assert_array_equal(got[key], host_batch[key], key)
            assert got[key].dtype == host_batch[key].dtype, key
        np.testing.assert_array_equal(got["encoder_inputs"]["Formula"],
                                      host_batch["encoder_inputs"]["Formula"])
        _near(got["encoder_inputs"]["IR"], host_batch["encoder_inputs"]["IR"], "host IR")
        _near(got["align_target"], host_batch["align_target"], "host align_target")
        assert not np.any(got["encoder_inputs"]["IR"][~rows])


# -------------------------------------------------------------------- fit


def _fit_losses(loader, config, preps, transform):
    cfg = ModelConfig(
        d_model=32, encoder_layers=1, decoder_layers=1, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        vocab_size=config["Smiles"]["vocab_size"], pad_token_id=config["Smiles"]["pad_token_id"],
        dropout=0.0, dtype="float32",
        align_config=AlignConfig(align_network="convolutional", hidden_dimension=16,
                                 conv_channels=8, kernel_size=5, output_dimension=1800,
                                 loss_lambda=10.0, loss_function="mae"))
    model = Seq2SeqModel(cfg, config, "Smiles", generator=torch.Generator().manual_seed(5))
    trainer = Trainer(model, preps["Smiles"], num_steps=12, lr=1e-3, seed=5,
                      batch_transform=transform)
    return trainer.fit(loader, epochs=1)


def test_fit_on_the_device_route_matches_the_host_route():
    """Seven steps at B 4 over 26 samples: the last batch has 2 real rows."""
    mixture_config = {"balanced": _mode(samples=32)}
    stream, config, preps, collator = _pipeline(mixture_config, 26)
    mix = dm.try_build_device_mixture(stream, config, preps, collator, batch_size=4, seed=SEED,
                                      device=torch.device("cpu"))
    assert mix is not None
    host = _fit_losses(DataLoader(stream, collator, batch_size=4, prefetch=0), config, preps,
                       None)
    device = _fit_losses(mix.loader, config, preps, mix.expand)
    assert len(device) == len(host) == 7
    assert np.all(np.isfinite(device))
    np.testing.assert_allclose(device, host, rtol=FIT_RTOL)


# ------------------------------------------------------------ refused cases


def test_the_route_is_refused_where_the_jax_package_refuses_it(monkeypatch):
    args = dict(batch_size=4, seed=SEED)
    mixed = {"balanced": dict(_mode(samples=0), parallel_samples=16384, mixed=True)}
    for port in (True, False):
        build = dm.try_build_device_mixture if port else jax_dm.try_build_device_mixture
        stream, config, preps, collator = _pipeline({"balanced": _mode(samples=24)}, 24,
                                                    port=port)
        mixed_stream, *_ = _pipeline(mixed, 12, port=port)
        table = stream.generator_args["dataset"]
        assert build(mixed_stream, config, preps, collator, **args) is None
        assert build(table, config, preps, collator, **args) is None
        assert build(stream, config, preps, collator, **args) is not None
        wide = copy.deepcopy(config)
        wide["Extra"] = {"type": "text", "column": "Extra", "target": False}
        assert build(stream, wide, preps, collator, **args) is None
        with pytest.raises(ValueError):
            next((dm if port else jax_dm).mixture_index_stream(12, mixed["balanced"], "train",
                                                               1))
    # World size above 1: the JAX package's predicate (jax.process_count() > 1).
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    stream, config, preps, collator = _pipeline({"balanced": _mode(samples=24)}, 24)
    assert dm.try_build_device_mixture(stream, config, preps, collator, **args) is None


@pytest.mark.parametrize("prep_key,value", [
    ("interpolation", True), ("masking", True), ("overlap", 2), ("derivative", True)])
def test_eligibility_equals_the_jax_predicate(prep_key, value):
    stream, config, preps, _ = _pipeline({"balanced": _mode(samples=24)}, 24)
    mixture_config = stream.generator_args["mixture_config"]
    assert dm.device_mixture_eligible(config, mixture_config, preps)
    setattr(preps["IR"], prep_key, value)
    assert not dm.device_mixture_eligible(config, mixture_config, preps)
    assert dm.device_mixture_eligible(config, mixture_config, preps) == \
        jax_dm.device_mixture_eligible(config, mixture_config, preps)


# ------------------------------------------------------------------ loader


def test_loader_final_partial_batch_equals_the_jax_loader():
    mixture_config = {"balanced": _mode(samples=24)}
    args = (12, mixture_config, "train", SEED, 5, 23)
    ours, theirs = list(dm.DeviceMixtureLoader(*args)), list(jax_dm.DeviceMixtureLoader(*args))
    assert len(ours) == len(dm.DeviceMixtureLoader(*args)) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], key)
    last = ours[-1]
    assert sum(b["n_valid"] for b in ours) == 23
    assert last["row_valid"].sum() == last["n_valid"] < 5
    assert last["mix_idx"].shape == (5, 2)
    assert dm.DeviceMixtureLoader(*args).batch_bytes == sum(
        last[k].nbytes for k in ("mix_idx", "comp_slot", "mix_weights", "mix_normalize",
                                 "row_valid"))


# --------------------------------------------------------------------- CLI

IR_DATA = Path(__file__).parent / "test_data" / "ir_dataset"
CLI_RUN = [
    "data=ir/patches_mixture_text_align", f"data_path={IR_DATA}", "model=custom_model_align",
    "mixture=ir/binary", "mixture.balanced.train_max_n_samples=32",
    "mixture.balanced.validation_max_n_samples=8", "mixture.balanced.test_max_n_samples=8",
    "mixture.balanced.parallel_samples=8", "model.align_config.hidden_dimension=16",
    "model.align_config.conv_channels=8", "model.d_model=32", "model.encoder_layers=1",
    "model.decoder_layers=1", "model.encoder_ffn_dim=64", "model.decoder_ffn_dim=64",
    "model.encoder_attention_heads=4", "model.decoder_attention_heads=4",
    "model.batch_size=8", "model.n_beams=2", "model.dtype=float32", "+model.dropout=0.0",
    "trainer.epochs=1", "trainer.acc_batches=1", "+device=cpu",
]


@pytest.mark.parametrize("device_mixing", [None, "false"])
def test_training_cli_takes_the_device_route_unless_told_not_to(tmp_path, device_mixing):
    """The align recipe through the training CLI: by default on the device
    route (the pool staged, index batches fed), with
    ``+device_mixing=false`` on the host generator; the first step's loss is
    the same either way (rtol FIT_RTOL)."""
    from multimodalanalytical_tpu_torch.cli import training

    def first_loss(job, extra):
        training.main([f"working_dir={tmp_path}", f"job_name={job}", *CLI_RUN, *extra])
        log = (tmp_path / job / "training.log").read_text()
        step0 = next(line for line in log.splitlines() if "step 0 train_loss" in line)
        return log, float(step0.split("train_loss ")[1].split()[0])

    extra = [] if device_mixing is None else [f"+device_mixing={device_mixing}"]
    log, loss = first_loss("run", extra)
    assert ("device mixing engaged" in log) == (device_mixing is None)
    _, reference = first_loss("reference", ["+device_mixing=" + (
        "false" if device_mixing is None else "true")])
    np.testing.assert_allclose(loss, reference, rtol=FIT_RTOL)
