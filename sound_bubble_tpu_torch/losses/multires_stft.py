"""Multi-resolution STFT loss with auraloss semantics (+ A-weighting): port
of `sound_bubble_tpu/losses/multires_stft.py`, the finetune loss of the
reference configs (`syn_experiments/finetune_stage.json`,
`real_experiments/*_finetune.json`: w_sc=0, w_log_mag=0, w_lin_mag=20,
perceptual_weighting=true, sample_rate=24000, + l1_ratio*L1).

- per resolution (fft, hop, win) in ([1024,120,600],[2048,240,1200],[512,50,240]):
  `torch.stft` (reflect center-pad by fft//2, periodic Hann window of
  win_length zero-padded centered to fft), magnitude sqrt(clamp(|.|^2, eps));
- spectral convergence ||Y-X||_F/||Y||_F, log-mag L1, lin-mag L1; mean over
  resolutions;
- perceptual weighting: a 101-tap A-weighting FIR (IEC 61672 analog
  prototype -> bilinear -> least-squares FIR fit, auraloss
  `FIRFilter("aw")`) applied to est and target first.

No kernel: the JAX package computes these outside any Pallas kernel too.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=8)
def a_weighting_fir(fs: int, ntaps: int = 101) -> np.ndarray:
    """Least-squares FIR fit of the IEC 61672 A-weighting response."""
    import scipy.signal

    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    a1000 = 1.9997
    num = [(2 * np.pi * f4) ** 2 * (10 ** (a1000 / 20)), 0, 0, 0, 0]
    den = np.polymul([1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
                     [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2])
    den = np.polymul(np.polymul(den, [1, 2 * np.pi * f3]), [1, 2 * np.pi * f2])
    b, a = scipy.signal.bilinear(num, den, fs=fs)
    w, h = scipy.signal.freqz(b, a, worN=512, fs=fs)
    taps = scipy.signal.firls(ntaps, w, abs(h), fs=fs)
    return taps.astype(np.float32)


def fir_filter(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """conv1d(x, taps, padding=ntaps//2), cross-correlation (no flip).
    x: [..., T] -> [..., T] (T+1 for an even number of taps)."""
    pad = taps.shape[0] // 2
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), taps.reshape(1, 1, -1),
                 padding=pad)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def stft_mag(x: torch.Tensor, fft: int, hop: int, win: int,
             eps: float = 1e-8) -> torch.Tensor:
    """torch.stft(center=True, pad_mode='reflect') magnitude. [..., T] ->
    [..., F, frames] with F = fft//2+1."""
    window = torch.hann_window(win, dtype=x.dtype, device=x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]), fft, hop, win, window,
                      center=True, pad_mode="reflect", return_complex=True)
    mag = torch.sqrt(torch.clamp(spec.real.square() + spec.imag.square(),
                                 min=eps))
    return mag.reshape(x.shape[:-1] + mag.shape[-2:])


class STFTLoss:
    def __init__(self, fft_size=1024, hop_size=256, win_length=1024,
                 w_sc=1.0, w_log_mag=1.0, w_lin_mag=0.0,
                 sample_rate=None, perceptual_weighting=False, eps=1e-8):
        self.fft_size, self.hop_size = fft_size, hop_size
        self.win_length = win_length
        self.w_sc, self.w_log_mag, self.w_lin_mag = w_sc, w_log_mag, w_lin_mag
        self.eps = eps
        self.taps = None
        if perceptual_weighting:
            if sample_rate is None:
                raise ValueError("perceptual weighting needs sample_rate")
            self.taps = torch.from_numpy(a_weighting_fir(sample_rate))

    def __call__(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """est/gt [B, C, T]. Returns per-sample [B] (its mean is the
        auraloss batch scalar) except when w_sc > 0: the spectral-convergence
        norm is global over the batch, so that case returns the scalar."""
        if self.taps is not None:
            taps = self.taps.to(est.device)
            est = fir_filter(est, taps)
            gt = fir_filter(gt, taps)
        b = est.shape[0]
        x = stft_mag(est, self.fft_size, self.hop_size, self.win_length,
                     self.eps)
        y = stft_mag(gt, self.fft_size, self.hop_size, self.win_length,
                     self.eps)
        if self.w_sc:
            loss = self.w_sc * torch.linalg.norm(y - x) / torch.linalg.norm(y)
            if self.w_log_mag:
                loss = loss + self.w_log_mag * torch.mean(
                    torch.abs(torch.log(y) - torch.log(x)))
            if self.w_lin_mag:
                loss = loss + self.w_lin_mag * torch.mean(torch.abs(y - x))
            return loss
        xb, yb = x.reshape(b, -1), y.reshape(b, -1)
        loss = x.new_zeros(b)
        if self.w_log_mag:
            loss = loss + self.w_log_mag * torch.mean(
                torch.abs(torch.log(yb) - torch.log(xb)), dim=-1)
        if self.w_lin_mag:
            loss = loss + self.w_lin_mag * torch.mean(torch.abs(yb - xb),
                                                      dim=-1)
        return loss


class MultiResolutionSTFTLoss:
    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), **kwargs):
        self.losses = [STFTLoss(f, h, w, **kwargs)
                       for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)]

    def __call__(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for fn in self.losses:
            total = total + fn(est, gt)
        return total / len(self.losses)


class MultiResoFuseLoss:
    """Reference finetune loss: MR-STFT + l1_ratio * L1. est/gt: [B, C, T]
    -> per-sample [B] when w_sc == 0, the scalar otherwise (see STFTLoss)."""

    def __init__(self, l1_ratio: float = 0.0, **kwargs):
        self.l1_ratio = l1_ratio
        self.loss_fn = MultiResolutionSTFTLoss(**kwargs)

    def __call__(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        loss = self.loss_fn(est, gt)
        if self.l1_ratio > 0:
            l1 = torch.abs(est - gt)
            if loss.ndim == 1:       # per-sample path
                loss = loss + self.l1_ratio * torch.mean(
                    l1.reshape(est.shape[0], -1), dim=-1)
            else:
                loss = loss + self.l1_ratio * torch.mean(l1)
        return loss
