"""Negative-SDR loss family with asteroid `SingleSrcNegSDR` semantics (port
of `sound_bubble_tpu/losses/sdr.py`).

Zero-mean both signals, EPS=1e-8 inside the energy ratio and the log.
Returns per-sample values (the training module reduces them).
"""
from __future__ import annotations

import torch

EPS = 1e-8


def neg_sdr(est: torch.Tensor, target: torch.Tensor, sdr_type: str = "snr",
            zero_mean: bool = True) -> torch.Tensor:
    """-SDR over the last axis. est/target: [..., T] -> [...]."""
    if sdr_type not in ("snr", "sisdr", "sdsdr"):
        raise ValueError(f"unknown sdr_type {sdr_type}")
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = (est * target).sum(dim=-1, keepdim=True)
        energy = target.square().sum(dim=-1, keepdim=True) + EPS
        scaled = dot * target / energy
    else:
        scaled = target
    e_noise = est - target if sdr_type in ("snr", "sdsdr") else est - scaled
    ratio = scaled.square().sum(dim=-1) / (e_noise.square().sum(dim=-1) + EPS)
    return -10.0 * torch.log10(ratio + EPS)


class SNRLosses:
    """Name-dispatched combination of neg-SDR variants (reference
    `SNRLosses`): snr | sisdr | fused | max_fused | sdsdr | full.
    __call__(est, gt): [B, C, T] -> [B*C] per-sample loss."""

    NAMES = ("snr", "sisdr", "fused", "max_fused", "sdsdr", "full")

    def __init__(self, name: str, **_):
        if name not in self.NAMES:
            raise ValueError(
                f"Invalid loss function used: Loss {name} not found")
        self.name = name

    def __call__(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        b, c, t = est.shape
        est = est.reshape(b * c, t)
        gt = gt.reshape(b * c, t)
        if self.name == "fused":
            return 0.5 * neg_sdr(est, gt, "sisdr") + 0.5 * neg_sdr(est, gt,
                                                                   "snr")
        if self.name == "max_fused":
            return torch.maximum(neg_sdr(est, gt, "sisdr"),
                                 neg_sdr(est, gt, "snr"))
        if self.name == "sdsdr":
            return torch.maximum(neg_sdr(est, gt, "snr"),
                                 neg_sdr(est, gt, "sdsdr"))
        if self.name == "full":
            return 0.5 * neg_sdr(est, gt, "sisdr") + 0.5 * torch.maximum(
                neg_sdr(est, gt, "snr"), neg_sdr(est, gt, "sdsdr"))
        return neg_sdr(est, gt, self.name)
