"""SNRLP pretrain loss (port of `sound_bubble_tpu/losses/snrlp.py`): SNR on
positive samples, weighted L1-to-zero on negative (empty-bubble) samples.

The negative branch is the reference's `nn.L1Loss()`: ONE scalar, the mean
|est| over the whole negative subset, given to every negative sample, times
`neg_weight`; positives get the per-sample neg-SDR. Branchless: the masked
mean over the negatives replaces boolean indexing.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.losses.sdr import SNRLosses


class SNRLPLoss:
    def __init__(self, snr_loss_name: str = "snr", neg_weight: float = 1.0):
        self.snr_loss = SNRLosses(snr_loss_name)
        self.neg_weight = neg_weight

    def __call__(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """est/gt: [B, C, T] -> [B] per-sample loss."""
        b, c, _ = est.shape
        neg_mask = gt.abs().amax(dim=(1, 2)) == 0              # [B]
        per_sample_l1 = est.abs().mean(dim=(1, 2))
        n_neg = neg_mask.sum()
        neg_scalar = ((per_sample_l1 * neg_mask).sum()
                      / torch.clamp(n_neg, min=1))
        pos = self.snr_loss(est, gt).reshape(b, c).mean(dim=1)
        return torch.where(neg_mask, neg_scalar * self.neg_weight, pos)
