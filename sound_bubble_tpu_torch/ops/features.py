"""Multichannel spatial features: ILD and IPD(sin, cos) against mic 0.

Port of `sound_bubble_tpu/ops/features.py`, in fp32. real/imag are
[B, M, T, F]; output features are [B, T, F, Cfeat] (channels minor), channel
order identical to the reference:
  omni:        [ILD_1..ILD_{M-1}, sin_1, cos_1, ..., sin_{M-1}, cos_{M-1}]
  directional: [ILD_{2vs3}, ILD_1, ILD_4, ILD_5, sin_1, cos_1, ..., sin_5, cos_5]
"""
from __future__ import annotations

import torch


def _ipd_pairs(real, imag, norm, eps):
    """sin/cos of phase difference of mics 1..M-1 vs mic 0, interleaved.

    real/imag/norm: [B, M, T, F]. Returns [B, T, F, 2(M-1)] ordered
    [sin_1, cos_1, sin_2, cos_2, ...]."""
    r0, i0, n0 = real[:, :1], imag[:, :1], norm[:, :1]
    r, i, n = real[:, 1:], imag[:, 1:], norm[:, 1:]
    denom = n * n0 + eps
    cos = (r * r0 + i * i0) / denom                  # [B, M-1, T, F]
    sin = (r0 * i - i0 * r) / denom
    pairs = torch.stack([sin, cos], dim=2)           # [B, M-1, 2, T, F]
    b, m1, _, t, f = pairs.shape
    return torch.movedim(pairs.reshape(b, 2 * m1, t, f), 1, -1)


def spatial_features(real: torch.Tensor, imag: torch.Tensor,
                     directional: bool = False, eps: float = 1e-6):
    """ILD + IPD features. real/imag: [B, M, T, F] -> [B, T, F, Cfeat]."""
    norm = torch.sqrt(real.square() + imag.square())
    if directional:
        ild_d = torch.log10((norm[:, 2:3] + eps) / (norm[:, 3:4] + eps))
        ild_m = torch.log10((norm[:, [1, 4, 5]] + eps) / (norm[:, 0:1] + eps))
        ild = torch.cat([ild_d, ild_m], dim=1)
    else:
        ild = torch.log10((norm[:, 1:] + eps) / (norm[:, 0:1] + eps))
    ild = torch.movedim(ild, 1, -1)                  # [B, T, F, n_ild]
    return torch.cat([ild, _ipd_pairs(real, imag, norm, eps)], dim=-1)
