"""Convert a reference (rxn4chemistry/MultimodalAnalytical) checkpoint into a
checkpoint of this package (counterpart of ``scripts/convert_reference_checkpoint.py``).

    python -m multimodalanalytical_tpu_torch.cli.convert_reference_checkpoint IN.ckpt OUT \\
        [--family auto|CustomModel|BartForConditionalGeneration|T5ForConditionalGeneration]

``IN.ckpt`` is a Lightning checkpoint (``state_dict`` keys under
``hf_model.``) or a bare torch ``state_dict`` of CustomModel or the
reference's surgered HF BART / T5. Its weights go through the port's copy of
the reference mapping (``models/torch_mapping.py``, held to the reference's
executed forward by ``tests/test_torch_reference_parity.py``) and land in
the directory ``OUT`` as a checkpoint of ``training/checkpoint.py``'s layout
(``OUT/state.pt``), which ``restore_params`` and ``load_finetune_params``
read: point the CLIs at it with ``model.model_checkpoint_path=OUT``
(``cli.predict``, ``cli.serve``, or ``finetuning=True`` in ``cli.training``).
The model config (``model=...``) and the preprocessor artifact are supplied
as for any checkpoint. ``OUT`` must not exist yet.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..models.torch_mapping import lightning_state_dict_to_flax
from ..models.weights import flax_to_state_dict
from ..training.checkpoint import STATE_FILE

FAMILIES = ["auto", "CustomModel", "BartForConditionalGeneration",
            "T5ForConditionalGeneration"]


def load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """The tensors of a reference checkpoint as numpy arrays, by key."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # Lightning checkpoints embed hyper_parameters (arbitrary pickled
        # objects), which the restricted unpickler refuses; fall back only
        # for a file the user chose to load.
        print("weights_only load failed; falling back to full unpickling "
              "(only convert checkpoints you trust)", file=sys.stderr)
        raw = torch.load(path, map_location="cpu", weights_only=False)
    state = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return {key: value.detach().cpu().numpy() for key, value in state.items()
            if hasattr(value, "detach")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt", type=Path, help="reference .ckpt / .pt file")
    parser.add_argument("out", type=Path, help="checkpoint directory to create")
    parser.add_argument("--family", default="auto", choices=FAMILIES,
                        help="reference model family (default: detect from keys)")
    args = parser.parse_args(argv)

    out = args.out.resolve()
    if out.exists():
        parser.error(f"{out} already exists; the converter writes a fresh directory")
    params = lightning_state_dict_to_flax(load_state_dict(args.ckpt), family=args.family)
    state = {name: torch.from_numpy(np.array(array, dtype=np.float32))
             for name, array in flax_to_state_dict(params).items()}
    out.mkdir(parents=True)
    torch.save({"params": state}, out / STATE_FILE)
    print(f"wrote {out}: {len(state)} param arrays, "
          f"{sum(t.numel() for t in state.values()):,} weights")
    return 0


if __name__ == "__main__":
    sys.exit(main())
