"""The port's model config mirrors the JAX one, and the port never imports
JAX or the JAX package's framework dependencies."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from multimodalanalytical_tpu.models import config as jax_config  # noqa: E402
from multimodalanalytical_tpu_torch.models import config as port_config  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_model_config_fields_and_defaults_match_jax():
    for name in ("ModelConfig", "AlignConfig"):
        jax_cls, port_cls = getattr(jax_config, name), getattr(port_config, name)
        assert ([f.name for f in dataclasses.fields(port_cls)]
                == [f.name for f in dataclasses.fields(jax_cls)])
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    assert port_config.MODEL_PRESETS == jax_config.MODEL_PRESETS
    assert port_config.ModelConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    assert port_config.ModelConfig().compute_dtype == torch.float32


@pytest.mark.parametrize("model_type", sorted(jax_config.MODEL_PRESETS))
def test_resolve_model_config_matches_jax(model_type):
    yaml_dict = {"model_type": model_type, "d_model": 256, "encoder_layers": 3,
                 "dtype": "bfloat16", "n_beams": 10, "lr": 1e-4,
                 "align_config": {"loss_function": "mse"}}
    ids = dict(vocab_size=320, pad_token_id=0, bos_token_id=2, eos_token_id=3)
    want = jax_config.resolve_model_config(yaml_dict, **ids)
    got = port_config.resolve_model_config(yaml_dict, **ids)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hf_derived_dimensions_are_not_ported_yet():
    with pytest.raises(NotImplementedError):
        port_config.resolve_model_config(
            {"model_type": "BartForConditionalGeneration", "model_name": "facebook/bart-base"},
            vocab_size=10, pad_token_id=0, bos_token_id=2, eos_token_id=3)


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke.py, import with torch, numpy
    and the standard library only (as on a machine without JAX), except the
    port's copies of the record-path layers (``data/``, ``config/``), which
    need pyyaml, pyarrow or ``tokenizers`` as their originals do
    (``tests/test_torch_shared_layers.py`` checks that no module of the port
    imports JAX or the JAX package)."""
    code = """
import importlib, sys
from pathlib import Path
before = set(sys.modules)
import multimodalanalytical_tpu_torch as pkg
root = Path(pkg.__file__).parent
# module names from the files (pkgutil.walk_packages would import packages)
names = sorted(".".join((pkg.__name__,) + p.relative_to(root).with_suffix("").parts)
               .removesuffix(".__init__") for p in root.rglob("*.py")
               if p.relative_to(root).parts != ("__init__.py",))
record_path = tuple(pkg.__name__ + "." + layer for layer in ("data", "config"))
core = [n for n in names if not n.startswith(record_path)]
for name in core:
    importlib.import_module(name)
import chip_smoke
banned = ("jax", "flax", "tokenizers", "yaml", "pyarrow", "multimodalanalytical_tpu")
loaded = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in banned)
assert not loaded, loaded
assert not any(m.split(".")[0] in banned for m in before), "preloaded at startup"
print(len(core))
"""
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert int(result.stdout.split()[-1]) >= 14
