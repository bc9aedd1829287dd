"""Epoch loops (port of `sound_bubble_tpu/train/loop.py`)."""
from __future__ import annotations


def train_epoch(hl_module, train_loader) -> float:
    """One optimizer step per batch; returns the sample-weighted mean loss."""
    hl_module.train()
    total, n = 0.0, 0
    for batch_idx, batch in enumerate(train_loader):
        loss, b = hl_module.training_step(batch, batch_idx)
        total += loss * b
        n += b
        print(f"  train step {batch_idx}: loss {loss:.5f}", flush=True)
    return total / max(n, 1)


def test_epoch(hl_module, test_loader) -> float:
    hl_module.eval()
    total, n = 0.0, 0
    for batch_idx, batch in enumerate(test_loader):
        loss, b = hl_module.validation_step(batch, batch_idx)
        total += loss * b
        n += b
    return total / max(n, 1)
