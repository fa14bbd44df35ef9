"""The port's own copies of the framework-free layers (``configuration.py``,
``chem/``, ``data/``, ``config/``, ``evaluation/``).

The port imports nothing of the JAX package and no JAX library: an ``ast``
walk over every module of the port and over ``chip_smoke.py`` (imports
inside functions included), and a fresh interpreter that imports the port's
entry points and scores a prediction without loading either. Each copy is
held against its original on the same inputs: preprocessors fitted on
``tests/test_data/ir_dataset`` (arrays and JSON state), config composition,
collated batches, scoring and rejection sampling, canonical SMILES.
"""

import ast
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multimodalanalytical_tpu_torch"
CONFIGS = REPO / "configs"
FORBIDDEN_ROOTS = ("multimodalanalytical_tpu", "jax", "flax", "optax", "orbax")
SMILES_REGEX = (r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\\\|\/|:"
                r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")
FORMULA_REGEX = r"([A-Z]{1}[a-z]?[0-9]*)"


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imports(path: Path):
    """Absolute names of every module that ``path`` imports, at any depth;
    relative imports resolved against the file's package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    package = _module_name(path).split(".")
    if path.name != "__init__.py":
        package = package[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            else:
                base = package[: len(package) - (node.level - 1)]
                yield ".".join(base + ([node.module] if node.module else []))


PY_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package_or_jax(path):
    bad = [name for name in _imports(path) if name.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
    if path.parent != REPO:
        outside = [name for name in _imports(path) if name.startswith("multimodalanalytical")
                   and not name.startswith("multimodalanalytical_tpu_torch")]
        assert not outside


def test_entry_points_load_nothing_of_the_jax_package():
    """A fresh interpreter imports the port's CLIs, trainer and beam search
    and scores one prediction through the port's metrics (and so its chem
    engine); neither the JAX package nor a JAX library is then loaded."""
    code = (
        "import sys\n"
        "import multimodalanalytical_tpu_torch.cli.training\n"
        "import multimodalanalytical_tpu_torch.cli.predict\n"
        "import multimodalanalytical_tpu_torch.cli.serve\n"
        "import multimodalanalytical_tpu_torch.training\n"
        "import multimodalanalytical_tpu_torch.generation\n"
        "from multimodalanalytical_tpu_torch.evaluation.metrics import calc_sampling_metrics\n"
        "metrics = calc_sampling_metrics([['OCC', 'C'], ['C', 'C']], ['CCO', 'CCN'],"
        " molecules=True)\n"
        "assert metrics['Top-1'] == 0.5, metrics\n"
        f"roots = {FORBIDDEN_ROOTS!r}\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in roots))\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                            text=True, timeout=300, env=dict(os.environ))
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.strip().splitlines()[-1] == "[]"


# --------------------------------------------------------------- parity
@pytest.fixture(scope="module")
def columns():
    """The IR test dataset's columns as modalities."""
    pq = pytest.importorskip("pyarrow.parquet")
    table = pq.read_table(REPO / "tests" / "test_data" / "ir_dataset" / "ir_data.parquet")
    data = table.to_pydict()
    return {"Formula": data["molecular_formula"], "IR": data["ir_spectra"],
            "Smiles": data["smiles"]}


PREPROCESSOR_CASES = {
    "text_formula": ("Formula", {"type": "text",
                                 "preprocessor_arguments": {"tokenizer_regex": FORMULA_REGEX}}),
    "text_smiles": ("Smiles", {"type": "text",
                               "preprocessor_arguments": {"tokenizer_regex": SMILES_REGEX}}),
    "1D_patches": ("IR", {"type": "1D_patches", "preprocessor_arguments": {"patch_size": 125}}),
    "1D_patches_masked": ("IR", {"type": "1D_patches", "preprocessor_arguments": {
        "patch_size": 50, "masking": True, "overlap": 2}}),
    "run_length_encoding": ("IR", {"type": "run_length_encoding",
                                   "preprocessor_arguments": {}}),
    "text_spectrum": ("IR", {"type": "text_spectrum", "preprocessor_arguments": {
        "spectrum_tokens_x": 400, "spectra_only": True}}),
    "text_spectrum_formula": ("IR", {"type": "text_spectrum", "preprocessor_arguments": {
        "spectrum_tokens_x": 400, "spectra_only": False, "formula_column": "Formula"}}),
    "peak_positional_encoding": ("IR", {"type": "peak_positional_encoding",
                                        "preprocessor_arguments": {
                                            "spectrum_to_text_x": "threshold"}}),
    "peak_positional_encoding_variance": ("IR", {"type": "peak_positional_encoding",
                                                 "preprocessor_arguments": {
                                                     "spectrum_to_text_x": "variance"}}),
    "normalise": ("IR", {"type": "normalise", "preprocessor_arguments": {}}),
    "functional_group": ("Smiles", {"type": "functional_group",
                                    "preprocessor_arguments": {}}),
}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _apply(prep, modality_type, values, formulae):
    if modality_type == "text":
        return prep(values, padding="max_length", max_length=64)
    if modality_type == "text_spectrum" and not prep.spectra_only:
        return prep(values, formulae)
    if modality_type == "normalise":
        return prep(np.asarray(values, dtype=np.float64))
    return prep(values)


@pytest.mark.parametrize("case", sorted(PREPROCESSOR_CASES))
def test_preprocessors_match_the_originals(case, columns, tmp_path):
    """fit_preprocessors on the IR test dataset: the same config written back,
    the same JSON artifact, the same arrays on the data."""
    pytest.importorskip("tokenizers")
    from multimodalanalytical_tpu.data import data_utils as jax_utils
    from multimodalanalytical_tpu_torch.data import data_utils

    modality, spec = PREPROCESSOR_CASES[case]
    config = {modality: {"column": modality, "target": False, **copy.deepcopy(spec)}}
    sampled = dict(columns)
    if spec["type"] == "normalise":
        sampled[modality] = np.asarray(columns[modality], dtype=np.float64)
    want_config, want_preps = jax_utils.fit_preprocessors(sampled, copy.deepcopy(config))
    got_config, got_preps = data_utils.fit_preprocessors(sampled, copy.deepcopy(config))
    assert got_config == want_config
    jax_utils.save_preprocessors(tmp_path / "jax.json", want_config, want_preps)
    data_utils.save_preprocessors(tmp_path / "port.json", got_config, got_preps)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    rows = columns[modality][:8]
    _assert_same(_apply(got_preps[modality], spec["type"], rows, columns["Formula"][:8]),
                 _apply(want_preps[modality], spec["type"], rows, columns["Formula"][:8]))
    # An artifact written by the JAX package loads into the port.
    loaded_config, loaded = data_utils.load_preprocessors_artifact(tmp_path / "jax.json")
    assert loaded_config == want_config
    _assert_same(_apply(loaded[modality], spec["type"], rows, columns["Formula"][:8]),
                 _apply(want_preps[modality], spec["type"], rows, columns["Formula"][:8]))


@pytest.mark.parametrize("name,overrides", [
    ("config_train", ["working_dir=/tmp/x"]),
    ("config_train", ["working_dir=/tmp/x", "data=multimodal/multimodal",
                      "model=custom_model_align", "mixture=ir/binary", "augment=ir/smooth",
                      "data.IR.preprocessor_arguments.patch_size=25", "trainer.epochs=3",
                      "modality_dropout=[IR,Multiplets,Carbon]"]),
    ("config_train", ["working_dir=/tmp/x", "model=t5_small", "+model.my_new_knob=7"]),
    ("config_predict", ["working_dir=/tmp/x"]),
    ("config_serve", ["working_dir=/tmp/x"]),
])
def test_compose_config_matches_the_original(name, overrides):
    pytest.importorskip("yaml")
    from multimodalanalytical_tpu.config import compose_config as jax_compose
    from multimodalanalytical_tpu_torch.config import compose_config

    assert compose_config(CONFIGS, name, list(overrides)) == jax_compose(
        CONFIGS, name, list(overrides))


@pytest.mark.parametrize("pad_to_batch_size", [None, 16])
def test_collator_batches_match_the_original(pad_to_batch_size, columns):
    """Formula + IR patches -> SMILES, fitted on the IR test dataset: the
    same fitted lengths and the same collated batch, padding rows included."""
    pytest.importorskip("tokenizers")
    from multimodalanalytical_tpu.data import collator as jax_collator
    from multimodalanalytical_tpu.data import data_utils as jax_utils
    from multimodalanalytical_tpu_torch.data import collator, data_utils

    config = {
        "Formula": {"type": "text", "column": "Formula", "target": False,
                    "preprocessor_arguments": {"tokenizer_regex": FORMULA_REGEX}},
        "IR": {"type": "1D_patches", "column": "IR", "target": False,
               "preprocessor_arguments": {"patch_size": 125}},
        "Smiles": {"type": "text", "column": "Smiles", "target": True,
                   "preprocessor_arguments": {"tokenizer_regex": SMILES_REGEX}},
    }
    batches = []
    for utils, module in ((data_utils, collator), (jax_utils, jax_collator)):
        cfg, preps = utils.fit_preprocessors(columns, copy.deepcopy(config))
        fitted = module.MultiModalCollator(preps, cfg, pad_to_batch_size=pad_to_batch_size)
        fitted.fit_lengths(columns)
        assert fitted.max_source_length and fitted.max_target_length
        batches.append((fitted.max_source_length, fitted.max_target_length,
                        fitted({k: v[:12] for k, v in columns.items()})))
    _assert_same(batches[0], batches[1])


SAMPLES = [
    ["OCC", "C", "C", "C", "C"],
    ["C", "NCC", "C", "C", "C"],
    ["C", "C", "C", "C", "CCC"],
    ["C", "C", "C", "C", "C"],
    ["bad(", "OC(C)=O", "C", "C", "C"],
]
TARGETS = ["CCO", "CCN", "CCC", "c1ccccc1", "CC(=O)O"]


@pytest.mark.parametrize("classes", [None, [0.5, 0.5, 0.33, 0.33, 0.5]])
def test_sampling_metrics_match_the_original(classes):
    from multimodalanalytical_tpu.evaluation import calc_sampling_metrics as jax_metrics
    from multimodalanalytical_tpu_torch.evaluation import calc_sampling_metrics

    for molecules in (True, False):
        got = calc_sampling_metrics(SAMPLES, TARGETS, classes=classes, molecules=molecules)
        assert got and got == jax_metrics(SAMPLES, TARGETS, classes=classes, molecules=molecules)


def test_reject_sample_matches_the_original():
    from multimodalanalytical_tpu.evaluation import reject_sample as jax_reject
    from multimodalanalytical_tpu_torch.evaluation import reject_sample

    predictions = {"predictions": [list(s) for s in SAMPLES], "targets": list(TARGETS)}
    want = jax_reject(copy.deepcopy(predictions), molecules=True)
    assert reject_sample(copy.deepcopy(predictions), molecules=True) == want


def _equivalent_pairs():
    """``EQUIVALENT_PAIRS`` of tests/test_chem.py, read without importing it."""
    tree = ast.parse((REPO / "tests" / "test_chem.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "EQUIVALENT_PAIRS":
            return ast.literal_eval(node.value)
    raise AssertionError("EQUIVALENT_PAIRS not found")


@pytest.mark.parametrize("a,b", _equivalent_pairs())
def test_canonicalize_matches_the_original(a, b):
    from multimodalanalytical_tpu.chem import canonicalize as jax_canonicalize
    from multimodalanalytical_tpu.chem import mol_formula as jax_formula
    from multimodalanalytical_tpu_torch.chem import canonicalize, mol_formula

    assert canonicalize(a) == canonicalize(b) == jax_canonicalize(a) is not None
    assert mol_formula(a) == jax_formula(a)


def test_chem_library_is_built_in_the_ports_own_directory():
    """The port's engine comes from its own build directory, written under a
    temporary name and renamed into place: never the JAX package's."""
    from multimodalanalytical_tpu_torch.chem import smiles

    so_path = smiles._build_library()
    assert so_path.parent == PORT / "csrc" / "build" and so_path.is_file()
    assert smiles._build_library() == so_path
