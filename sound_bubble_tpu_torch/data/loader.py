"""Batches for training (port of `sound_bubble_tpu/data/loader.py`).

A `torch.utils.data.DataLoader` over the sample-dir datasets, with the JAX
loader's collation (numpy leaves stacked, audio padded to the batch's
longest), shuffling from an explicit `torch.Generator`, and worker processes
started with `spawn`, each seeded by `worker_init_fn` as `src/train_pt.py`
seeds them.
"""
from __future__ import annotations

import numpy as np
import torch

from sound_bubble_tpu_torch.utils import seed_all


def _collate_leaves(values):
    v0 = values[0]
    if isinstance(v0, np.ndarray) and v0.ndim >= 1:
        max_t = max(v.shape[-1] for v in values)
        if any(v.shape[-1] != max_t for v in values):
            values = [np.pad(v, [(0, 0)] * (v.ndim - 1)
                             + [(0, max_t - v.shape[-1])]) for v in values]
        return np.stack(values)
    return np.asarray(values)


def collate(items):
    inputs = {k: _collate_leaves([it[0][k] for it in items])
              for k in items[0][0]}
    targets = {k: _collate_leaves([it[1][k] for it in items])
               for k in items[0][1]}
    return inputs, targets


class SeedWorkers:
    """worker_init_fn: every worker seeds Python's, numpy's and torch's
    generators with `seed + epoch` (set `epoch` before each epoch)."""

    def __init__(self, seed: int):
        self.seed = seed
        self.epoch = 0

    def __call__(self, worker_id: int):
        seed_all(self.seed + self.epoch)


def make_loader(dataset, batch_size: int, num_workers: int,
                worker_init_fn=None, generator: torch.Generator | None = None):
    """Shuffled when a `generator` is given, in order otherwise."""
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=generator is not None,
        num_workers=num_workers, worker_init_fn=worker_init_fn,
        collate_fn=collate, generator=generator,
        multiprocessing_context="spawn" if num_workers > 0 else None)
