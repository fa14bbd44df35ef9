"""Host-side batching with background prefetch (a copy of ``training/loader.py``).

The dataset classes come from this package's ``data`` layer and are
imported where they are needed, so importing this module needs numpy only.
A thread prefetcher overlaps host preprocessing with device steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List

import numpy as np


def _dataset_classes():
    from ..data.datasets import IterableDatasetWithLength, TableDataset

    return IterableDatasetWithLength, TableDataset


class DataLoader:
    def __init__(
        self,
        dataset,
        collator: Callable[[Dict[str, List[Any]]], Dict[str, Any]],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        """``num_shards``/``shard_index``: multi-process row partitioning
        (reference equivalent: DDP's DistributedSampler). ``batch_size`` is
        the GLOBAL batch size; under sharding this loader yields the
        ``shard_index``-th contiguous chunk (``batch_size // num_shards``
        rows) of every global batch, so the process-order concat of all
        shards reproduces the single-process batch exactly. Every shard
        yields the same number of batches (lockstep for collectives); a
        shard with no real rows in the final partial batch yields a fully
        masked dummy batch with ``n_valid == 0``. Shuffling must be seeded
        identically on every process (it is: the config seed)."""
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_shards = max(int(num_shards), 1)
        self.shard_index = int(shard_index)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _shard_bounds(self, global_rows: int) -> tuple:
        """(offset, size) of this shard's contiguous chunk of a global
        batch with ``global_rows`` rows; remainder rows go to the lowest
        shard indices so sizes differ by at most one."""
        base, rem = divmod(global_rows, self.num_shards)
        sizes = [base + (1 if p < rem else 0) for p in range(self.num_shards)]
        return sum(sizes[: self.shard_index]), sizes[self.shard_index]

    def _shard_columns(self, columns: Dict[str, List[Any]]):
        """Slice a global column batch to this shard. Returns
        ``(columns, dummy)``: when this shard gets zero rows (final partial
        batch smaller than num_shards), one dummy row is kept so collation
        produces a static-shape batch; the consumer masks it out."""
        if self.num_shards == 1:
            return columns, False
        first = next(iter(columns))
        offset, size = self._shard_bounds(len(columns[first]))
        if size == 0:
            return {k: list(v[:1]) for k, v in columns.items()}, True
        return {k: list(v[offset : offset + size]) for k, v in columns.items()}, False

    @staticmethod
    def _mask_dummy(batch: Dict[str, Any]) -> Dict[str, Any]:
        """Turn every row of a collated batch into a pad row (the same
        semantics the collator's _pad_batch gives trailing dummy rows)."""
        batch["n_valid"] = 0
        for key in ("encoder_mask", "decoder_mask"):
            if key in batch and batch[key] is not None:
                batch[key] = np.zeros_like(batch[key])
        if batch.get("labels") is not None:
            batch["labels"] = np.full_like(batch["labels"], -100)
        return batch

    def _column_batches(self) -> Iterator[Dict[str, List[Any]]]:
        IterableDatasetWithLength, TableDataset = _dataset_classes()
        if isinstance(self.dataset, IterableDatasetWithLength):
            # Streaming: every process consumes the full stream and keeps
            # its chunk of each global batch (synthesis is host-cheap
            # relative to the TPU step; keeps shards in lockstep).
            columns: Dict[str, List[Any]] = {}
            count = 0
            for row in self.dataset:
                for k, v in row.items():
                    columns.setdefault(k, []).append(v)
                count += 1
                if count == self.batch_size:
                    yield self._shard_columns(columns)
                    columns, count = {}, 0
            if count and not self.drop_last:
                yield self._shard_columns(columns)
            return

        if not isinstance(self.dataset, TableDataset):
            raise TypeError(f"unsupported dataset {type(self.dataset).__name__}")
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(indices)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            batch_idx = indices[start : start + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                break
            if self.num_shards > 1:
                offset, size = self._shard_bounds(len(batch_idx))
                dummy = size == 0
                local_idx = batch_idx[:1] if dummy else batch_idx[offset : offset + size]
                yield self.dataset.slice_columns(local_idx), dummy
            else:
                yield self.dataset.slice_columns(batch_idx), False

    def _collate(self, item) -> Dict[str, Any]:
        columns, dummy = item
        batch = self.collator(columns)
        return self._mask_dummy(batch) if dummy else batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch <= 0:
            for item in self._column_batches():
                yield self._collate(item)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def _put(item) -> bool:
            # Bounded put that notices an abandoned consumer (e.g. validate
            # breaking at limit_val_batches) so the producer thread exits
            # instead of blocking on a full queue forever.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for item in self._column_batches():
                    if not _put(self._collate(item)):
                        return
            except BaseException as exc:  # noqa: BLE001 - re-raised on consumer
                error.append(exc)
            finally:
                _put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # Runs on normal exhaustion AND on generator close (consumer
            # stopped iterating early): unblock + stop the producer.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)
        # Normal completion only (a closed generator never gets here, so an
        # early-abandoning consumer isn't hit with a stale producer error).
        if error:
            raise error[0]


def subsample_dataset(dataset, cap: int, seed: int = 0):
    """Cap validation/predict sets at ``cap`` random samples
    (reference datamodules.py:441-491)."""
    IterableDatasetWithLength, _ = _dataset_classes()
    if isinstance(dataset, IterableDatasetWithLength):
        return dataset.take(min(cap, len(dataset)))
    if len(dataset) <= cap:
        return dataset
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(dataset), cap, replace=False)
    return dataset.select(idx)
