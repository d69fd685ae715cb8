"""Batches of pre-encoded samples from webdataset-style tar shards.

Counterpart of the ``pre_encode`` branch of ``open_muse_tpu/training/data.py``
``Text2ImageDataset``: image tokens and text embeddings stored as ``.npy``
(or ``.pth``) members, a metadata quality filter, a shuffle buffer and
numpy batches.  It reuses that module's jax-free pieces (``ShardSource``,
``tar_samples``, ``decode_sample``, ``_prefetch``) and passes the process
rank to ``ShardSource`` (one process: rank 0 of 1); left out, ``ShardSource``
asks jax for it.
"""

from __future__ import annotations

import logging
import random
import tarfile
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from open_muse_tpu.training.data import ShardSource, _prefetch, decode_sample, tar_samples

__all__ = ["PreEncodedDataset"]

logger = logging.getLogger(__name__)


class PreEncodedDataset:
    """Yields dicts of stacked numpy arrays, one entry per ``.npy`` / ``.pth``
    member (``vq_f16.npy``, ``clip_penultimate.npy``, ``clip_pooled.npy``, ...)
    plus ``__keys__``, from shards resampled with replacement;
    ``select`` filters on the decoded sample (its ``metadata``)."""

    def __init__(self, train_shards_path_or_url, batch_size: int, *,
                 shuffle_buffer_size: int = 1000, select: Optional[Callable] = None,
                 seed: int = 0):
        self.shards = ShardSource(train_shards_path_or_url, resample=True, seed=seed,
                                  process_index=0, process_count=1)
        self.batch_size = batch_size
        self.shuffle_buffer_size = shuffle_buffer_size
        self.select = select
        self.rng = random.Random(seed + 1)

    def _samples(self) -> Iterator[Dict[str, Any]]:
        for url in self.shards:
            try:
                for raw in tar_samples(url, handler="raise"):
                    sample = decode_sample(raw, pre_encoded=True)
                    if self.select is None or self.select(sample):
                        yield sample
            except (tarfile.TarError, EOFError, OSError) as exc:
                logger.warning("skipping corrupt shard %s: %s", url, exc)

    def _shuffled(self) -> Iterator[Dict[str, Any]]:
        buf: List[Dict[str, Any]] = []
        for sample in self._samples():
            if len(buf) < self.shuffle_buffer_size:
                buf.append(sample)
                continue
            idx = self.rng.randrange(len(buf))
            yield buf[idx]
            buf[idx] = sample
        self.rng.shuffle(buf)
        yield from buf

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batch: List[Dict[str, Any]] = []
        for sample in _prefetch(self._shuffled()):
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []

    @staticmethod
    def _collate(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"__keys__": [s["__key__"] for s in batch]}
        for k in batch[0]:
            if k.endswith("npy") or k.endswith("pth"):
                out[k] = np.stack([np.asarray(s[k]) for s in batch])
        return out
