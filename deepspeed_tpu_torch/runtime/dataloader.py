"""Rank-sharded data loading (PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``. The JAX package's
single controller yields global micro-batches and lets the sharded
``device_put`` split them; here every rank is its own process, so each rank
draws its own ``batch_size`` rows of every global batch of
``batch_size * data_parallel_world_size`` rows, as the reference's
per-process loader did. Batches are stacked with numpy; the engine moves
them to its device.
"""

import math
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


class RepeatingLoader:
    """Wrap an iterator so it restarts from the beginning when exhausted."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


class DeepSpeedDataLoader:
    """Batches an indexable dataset into this rank's micro-batches.

    ``dataset`` is any sequence of samples (tuples / dicts of arrays or
    single arrays); ``batch_size`` is the per-rank micro-batch.
    """

    def __init__(self,
                 dataset: Sequence,
                 batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False,
                 seed: int = 0,
                 drop_last: bool = True,
                 data_parallel_world_size: int = 1,
                 data_parallel_rank: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.dp = data_parallel_world_size
        self.rank = data_parallel_rank
        global_batch = batch_size * self.dp
        if drop_last:
            self.len = len(dataset) // global_batch
        else:
            self.len = math.ceil(len(dataset) / global_batch)

    def __len__(self):
        return self.len

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        global_batch = self.batch_size * self.dp
        for b in range(self.len):
            start = b * global_batch + self.rank * self.batch_size
            idx = order[start:start + self.batch_size]
            samples = [self.dataset[int(i)] for i in idx]
            yield self.collate_fn(samples)


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])
