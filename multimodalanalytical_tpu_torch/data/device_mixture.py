"""Device-side mixture synthesis (counterpart of ``data/device_mixture.py``).

The reference synthesizes mixture spectra on the host inside the dataset
generator (reference datasets.py:58-141) and ships every batch's floats to
the device. Yet everything in a mixture batch is a function of (pool,
indices, ratios), so this module moves the content onto the device, as the
JAX package does:

  * the pure-compound pool (spectra, pre-tokenized formula and SMILES rows)
    is staged on the trainer's device once, as tensors held by
    ``DeviceMixture``;
  * the host streams only the sampling decisions (component indices, ratio
    weights, normalize flags) drawn by ``mixture_index_stream``, which
    replays the host generator's RandomState draws, so that both routes
    train on the same sample sequence;
  * ``build_premix`` returns a function of tensors that expands an index
    batch into the collated batch at the top of the train step: gather ->
    weighted average (``np.average``) -> optional ``normalize_spectrum`` ->
    patch standardization -> token gathers, in float32 where the host
    pipeline is float64 (agreement ~1e-6 relative).

The index streams, the eligibility check and the loader are numpy, copies
of the JAX module's. Eligibility is the JAX module's
(``try_build_device_mixture`` returns None and the caller keeps the host
generator): no ``mixed`` mode, inputs exactly {text, 1D_patches without
interpolation, masking, overlap or derivative}, a text target, an optional
non-interpolating 1D_patches alignment modality, and one process.

Rows past a final partial batch's real ones are the host collator's
padding (zero ids, masks, patches and align target, ``-100`` labels). The
JAX premix leaves such rows at the pool's first entry's ids and at NaN
patches (its weighted mean divides by a zero weight sum).
"""

from __future__ import annotations

import logging
import math
from itertools import zip_longest
from typing import Any, Callable, Dict, Generator, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..configuration import DEFAULT_SETTINGS

logger = logging.getLogger(__name__)

SPECTRUM_PAD_LENGTH = 1800  # mix_spectra pads real (1791) data to 1800


# ---------------------------------------------------------------------------
# Index streams: the sampling decisions of mix_spectra, nothing else
# ---------------------------------------------------------------------------

def mixture_index_stream(
    n_rows: int,
    mix_config: Dict[str, Any],
    split: str,
    seed: int = 0,
) -> Generator[Tuple[np.ndarray, int, Tuple[float, ...], bool], None, None]:
    """Yield ``(indices, component_slot, ratios, normalize)`` per SAMPLE in
    exactly the order ``datasets.mix_spectra`` yields samples: same
    RandomState, same draw shapes, same unique/valid filtering, same
    ``num_expected`` early break, same per-component expansion over nonzero
    ratios. ``mixed=True`` configs are not index-representable here; the
    caller must route them to the host generator."""
    rng = np.random.RandomState(seed or DEFAULT_SETTINGS.default_seed)

    n_compounds = mix_config["n_compounds"]
    compounds_ratio = mix_config.get("compounds_ratio")
    parallel_samples = mix_config["parallel_samples"]
    max_n_samples = mix_config[f"{split}_max_n_samples"]
    normalize = bool(mix_config["normalize"])
    if mix_config.get("mixed", False):
        raise ValueError("mixed=True is not index-representable")

    if max_n_samples // parallel_samples < 1:
        parallel_samples = max_n_samples
    if compounds_ratio is None:
        compounds_ratio = [1 / n_compounds] * n_compounds
    if len(compounds_ratio) != n_compounds or not math.isclose(sum(compounds_ratio), 1):
        raise ValueError(
            f"Invalid compound ratios: expected {n_compounds} compounds with "
            f"ratios summing to 1; got {compounds_ratio}."
        )

    num_expected = math.perm(n_rows, n_compounds)
    ratios = tuple(float(r) for r in compounds_ratio)
    nonzero = [i for i in range(n_compounds) if ratios[i] != 0]

    for n in range(max_n_samples // parallel_samples):
        random_indices = rng.choice(n_rows, size=(parallel_samples, n_compounds))
        random_indices = np.unique(random_indices, axis=0)
        valid = np.asarray([len(set(row)) == len(row) for row in random_indices])
        random_indices = random_indices[valid]

        if n * parallel_samples + parallel_samples >= num_expected:
            break

        for row in random_indices:
            for i in nonzero:
                yield row, i, ratios, normalize


def multi_config_index_stream(
    mixture_config: Dict[str, Any],
    n_rows: int,
    split: str,
    seed: int = 0,
):
    """Round-robin interleave matching ``datasets.multi_config_mix``."""
    generators = [
        mixture_index_stream(n_rows, mixture_config[mode], split, seed)
        for mode in mixture_config
    ]
    for samples in zip_longest(*generators, fillvalue=None):
        for sample in samples:
            if sample is not None:
                yield sample


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------

def _patch_prep_eligible(prep) -> bool:
    return (
        getattr(prep, "interpolation", True) is False
        and getattr(prep, "masking", True) is False
        and getattr(prep, "overlap", 0) == 1
        and getattr(prep, "derivative", True) is False
    )


def device_mixture_eligible(
    data_config: Dict[str, Any],
    mixture_config: Dict[str, Any],
    preprocessors: Dict[str, Any],
) -> bool:
    for mode, cfg in mixture_config.items():
        if cfg.get("mixed", False):
            logger.info("device mixing: mode %s is mixed=True -> host path", mode)
            return False
    inputs = [m for m, c in data_config.items() if not c["target"]]
    targets = [m for m, c in data_config.items()
               if c["target"] and not c.get("alignment")]
    aligns = [m for m, c in data_config.items()
              if c["target"] and c.get("alignment")]
    if len(targets) != 1 or data_config[targets[0]]["type"] != "text":
        return False
    type_by_mod = {m: data_config[m]["type"] for m in inputs}
    if sorted(type_by_mod.values()) != ["1D_patches", "text"]:
        return False
    patch_mod = next(m for m, t in type_by_mod.items() if t == "1D_patches")
    if not _patch_prep_eligible(preprocessors[patch_mod]):
        return False
    for m in aligns:
        if data_config[m]["type"] != "1D_patches":
            return False
        prep = preprocessors.get(m)
        if prep is not None and getattr(prep, "interpolation", False):
            return False
    return True


# ---------------------------------------------------------------------------
# Loader: batches of sampling decisions
# ---------------------------------------------------------------------------

class DeviceMixtureLoader:
    """Drop-in for the train ``DataLoader`` over a streaming mixture set:
    yields index batches (device fields: mix_idx / comp_slot / mix_weights /
    mix_normalize / row_valid; host fields: n_valid) for ``premix``
    expansion on the device. Single-process only (the caller gates)."""

    def __init__(
        self,
        n_rows: int,
        mixture_config: Dict[str, Any],
        split: str,
        seed: int,
        batch_size: int,
        length: int,
    ):
        self.n_rows = n_rows
        self.mixture_config = mixture_config
        self.split = split
        self.seed = seed
        self.batch_size = batch_size
        self._length = length
        self.max_n_compounds = max(
            cfg["n_compounds"] for cfg in mixture_config.values()
        )

    def __len__(self) -> int:
        return (self._length + self.batch_size - 1) // self.batch_size

    @property
    def batch_bytes(self) -> int:
        """Bytes of one index batch's device fields."""
        return self.batch_size * (8 * self.max_n_compounds + 6)

    def _make_batch(self, rows: List[Tuple], n_valid: int) -> Dict[str, Any]:
        b = self.batch_size
        nc = self.max_n_compounds
        mix_idx = np.zeros((b, nc), dtype=np.int32)
        comp_slot = np.zeros((b,), dtype=np.int32)
        weights = np.zeros((b, nc), dtype=np.float32)
        normalize = np.zeros((b,), dtype=bool)
        row_valid = np.zeros((b,), dtype=bool)
        for j, (idx, comp, ratios, norm) in enumerate(rows):
            k = len(idx)
            mix_idx[j, :k] = idx
            comp_slot[j] = comp
            weights[j, :k] = ratios
            normalize[j] = norm
            row_valid[j] = True
        return {
            "mix_idx": mix_idx,
            "comp_slot": comp_slot,
            "mix_weights": weights,
            "mix_normalize": normalize,
            "row_valid": row_valid,
            "n_valid": n_valid,
        }

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rows: List[Tuple] = []
        emitted = 0
        stream = multi_config_index_stream(
            self.mixture_config, self.n_rows, self.split, self.seed
        )
        for sample in stream:
            if emitted >= self._length:
                break
            rows.append(sample)
            emitted += 1
            if len(rows) == self.batch_size:
                yield self._make_batch(rows, self.batch_size)
                rows = []
        if rows:
            yield self._make_batch(rows, len(rows))


# ---------------------------------------------------------------------------
# Expansion on the device
# ---------------------------------------------------------------------------

class DeviceMixture:
    """The staged pool tensors and the index -> batch expansion:
    ``premix(consts, batch)``, or :meth:`expand` (what the trainer's
    ``batch_transform`` takes). The pool is an argument of ``premix``, as
    in the JAX module, though nothing here needs that: JAX passed it so
    that a traced closure would not inline it into the compiled program,
    and eager PyTorch compiles nothing."""

    def __init__(self, loader: DeviceMixtureLoader, premix, consts: Dict[str, torch.Tensor],
                 pool_bytes: int):
        self.loader = loader
        self.premix = premix
        self.consts = consts
        self.pool_bytes = pool_bytes

    def expand(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """An index batch on the device as the collated batch."""
        return self.premix(self.consts, batch)


def _stage_pool(
    pool_table,
    data_config: Dict[str, Any],
    preprocessors: Dict[str, Any],
    collator,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Host-side one-time pool preparation. Returns (arrays, static)."""
    inputs = [m for m, c in data_config.items() if not c["target"]]
    text_mod = next(m for m in inputs if data_config[m]["type"] == "text")
    patch_mod = next(m for m in inputs if data_config[m]["type"] == "1D_patches")
    target_mod = collator.target_modality
    align_mod = collator.alignment_modality

    ir_rows = [np.asarray(s, dtype=np.float32) for s in pool_table["IR"]]
    spec_len = len(ir_rows[0])
    if any(len(r) != spec_len for r in ir_rows):
        raise ValueError("ragged spectra pool is not device-mixable")
    pool_ir = np.zeros((len(ir_rows), SPECTRUM_PAD_LENGTH), dtype=np.float32)
    pool_ir[:, :spec_len] = np.stack(ir_rows)

    formula_tok = preprocessors[text_mod](
        list(pool_table["Formula"]), padding="max_length",
        max_length=collator.max_source_length[text_mod], truncation=True,
    )
    smiles_tok = preprocessors[target_mod](
        list(pool_table["Smiles"]), padding="max_length",
        max_length=collator.max_target_length, truncation=True,
    )

    prep = preprocessors[patch_mod]
    arrays = {
        "pool_ir": pool_ir,
        "formula_ids": formula_tok["input_ids"].astype(np.int32),
        "formula_mask": formula_tok["attention_mask"].astype(np.int32),
        "smiles_ids": smiles_tok["input_ids"].astype(np.int32),
        "smiles_mask": smiles_tok["attention_mask"].astype(np.int32),
    }
    static = {
        "text_mod": text_mod,
        "patch_mod": patch_mod,
        "align": align_mod is not None,
        "spec_len": spec_len,
        "patch_size": prep.patch_size,
        "mean": float(prep.mean),
        "std": float(prep.std),
        "modality_order": inputs,
    }
    return arrays, static


def build_premix(static: Dict[str, Any]) -> Callable[[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]],
                                                     Dict[str, Any]]:
    """Return ``premix(consts, batch) -> collated batch``: ``consts`` are the
    staged pool tensors, ``batch`` an index batch on their device."""
    spec_len = static["spec_len"]
    patch = static["patch_size"]
    n_patches = SPECTRUM_PAD_LENGTH // patch
    trim = n_patches * patch
    mean, std = static["mean"], static["std"]
    text_mod, patch_mod = static["text_mod"], static["patch_mod"]
    order = static["modality_order"]
    has_align = static["align"]

    def premix(consts: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
               ) -> Dict[str, Any]:
        idx = batch["mix_idx"].long()                # (B, nc)
        comp = batch["comp_slot"].long()             # (B,)
        w = batch["mix_weights"].float()             # (B, nc)
        norm_flag = batch["mix_normalize"].bool()    # (B,)
        valid = batch["row_valid"].bool()[:, None]   # (B, 1)

        spectra = consts["pool_ir"][idx]             # (B, nc, 1800) gather
        # np.average semantics: sum(w*x)/sum(w) (reference datasets.py:118);
        # a padding row has no weights and stays 0.
        w_sum = w.sum(dim=1, keepdim=True)
        mixed = (spectra * w[:, :, None]).sum(dim=1) / torch.where(w_sum == 0, 1.0, w_sum)

        # normalize_spectrum over the REAL spectrum support only: the host
        # normalizes before padding to 1800 (datasets.py:311-318), so the
        # pad tail stays exactly 0 and never biases min/max. As the host
        # does, the maximum with 0 is taken before the minimum is subtracted.
        in_support = (torch.arange(SPECTRUM_PAD_LENGTH, device=mixed.device) < spec_len)[None]
        mn = torch.where(in_support, mixed, math.inf).amin(dim=1, keepdim=True)
        mx = torch.where(in_support, mixed, -math.inf).amax(dim=1, keepdim=True)
        span = mx - mn
        normed = torch.where(span == 0, 0.0,
                             (mixed.clamp_min(0.0) - mn) / torch.where(span == 0, 1.0, span))
        normed = torch.where(in_support, normed, 0.0)
        mixed = torch.where(norm_flag[:, None], normed, mixed)

        # Standardized over the full padded row, as the host collator does;
        # padding rows are zero, as the collator pads.
        standardized = torch.where(valid, (mixed - mean) / std, 0.0)
        patches = standardized[:, :trim].reshape(-1, n_patches, patch)

        target_row = idx.gather(1, comp[:, None])[:, 0]
        keep = valid.to(torch.int32)
        f_ids = consts["formula_ids"][target_row] * keep
        f_mask = consts["formula_mask"][target_row] * keep
        s_ids = consts["smiles_ids"][target_row] * keep
        s_mask = consts["smiles_mask"][target_row] * keep

        mask_parts = {text_mod: f_mask, patch_mod: keep.expand(-1, n_patches)}
        out = {
            "encoder_inputs": {text_mod: f_ids, patch_mod: patches},
            "encoder_mask": torch.cat([mask_parts[m] for m in order], dim=1),
            "decoder_ids": s_ids[:, :-1],
            "decoder_mask": s_mask[:, :-1],
            "labels": torch.where(s_mask[:, 1:] == 0, -100, s_ids[:, 1:]).to(torch.int32),
        }
        if has_align:
            out["align_target"] = consts["pool_ir"][target_row] * valid
        return out

    return premix


def try_build_device_mixture(
    train_set,
    data_config: Dict[str, Any],
    preprocessors: Dict[str, Any],
    collator,
    batch_size: int,
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> Optional[DeviceMixture]:
    """Build the device route for a streaming-mixture train set on
    ``device`` (the trainer's), or None when the recipe is outside the
    eligible envelope or the run spans several processes: then the caller
    keeps the host generator, which is the parity reference."""
    from ..parallel import multihost
    from .datasets import IterableDatasetWithLength, multi_config_mix

    if not isinstance(train_set, IterableDatasetWithLength):
        return None
    if train_set.generator_fn is not multi_config_mix:
        return None
    if multihost.process_count() > 1:
        logger.info("device mixing: multi-process run -> host path")
        return None
    args = train_set.generator_args
    mixture_config = args["mixture_config"]
    pool_table = args["dataset"]
    if not device_mixture_eligible(data_config, mixture_config, preprocessors):
        return None

    arrays, static = _stage_pool(pool_table, data_config, preprocessors, collator)
    consts = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    premix = build_premix(static)
    loader = DeviceMixtureLoader(
        n_rows=len(pool_table),
        mixture_config=mixture_config,
        split=train_set.split,
        seed=args.get("seed", seed),
        batch_size=batch_size,
        length=len(train_set),
    )
    pool_bytes = sum(a.nbytes for a in arrays.values())
    logger.info(
        "device mixing engaged: %d-row pool staged on %s (%.1f MB); the host "
        "ships %d B/batch of sampling decisions",
        len(pool_table), device, pool_bytes / 1e6, loader.batch_bytes,
    )
    return DeviceMixture(loader, premix, consts, pool_bytes)
