"""Evaluation metrics with torchmetrics conventions (port of
`sound_bubble_tpu/metrics/metrics.py`: snr, si_sdr, si_snr, compute_decay,
the `Metrics` improvement wrappers, STOI, PESQ and `Multi_Reso_L1`).

- snr and si_sdr use zero_mean=False; si_snr is si_sdr with zero mean;
- `*_i` variants are the improvement over the mixture: metric(est) -
  metric(mix);
- `compute_decay` = 10log10(P_mix) - 10log10(P_est), the empty-bubble
  suppression measure;
- STOI (`metrics/stoi.py`) and PESQ (P.862 narrowband at 16 kHz: the
  optional `pesq` package when it imports, else `metrics/pesq.py:pesq_nb`)
  run in numpy on the host, on the float32 values, as in the JAX package.

Inputs are numpy arrays or tensors; the math runs in float32 torch.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32))


def snr(preds, target, zero_mean: bool = False):
    """[..., T] -> [...] in dB."""
    preds, target = _t(preds), _t(target)
    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    noise = target - preds
    val = ((target.square().sum(dim=-1) + _EPS)
           / (noise.square().sum(dim=-1) + _EPS))
    return 10.0 * torch.log10(val)


def si_sdr(preds, target, zero_mean: bool = False):
    """Scale-invariant SDR, torchmetrics convention. [..., T] -> [...]."""
    preds, target = _t(preds), _t(target)
    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    alpha = (((preds * target).sum(dim=-1, keepdim=True) + _EPS)
             / (target.square().sum(dim=-1, keepdim=True) + _EPS))
    scaled = alpha * target
    noise = scaled - preds
    val = ((scaled.square().sum(dim=-1) + _EPS)
           / (noise.square().sum(dim=-1) + _EPS))
    return 10.0 * torch.log10(val)


def si_snr(preds, target):
    return si_sdr(preds, target, zero_mean=True)


def compute_decay(est, mix):
    """[*, C, T] -> [*]: how strongly the model mutes an empty bubble."""
    est, mix = _t(est), _t(mix)
    p_est = 10.0 * torch.log10(est.square().sum(dim=-1))
    p_mix = 10.0 * torch.log10(mix.square().sum(dim=-1))
    return (p_mix - p_est).mean(dim=-1)


def _np(a) -> np.ndarray:
    """float32 numpy copy of a tensor or an array-like."""
    return _t(a).cpu().numpy()


def _pesq_impl(est, gt, fs):
    """P.862 narrowband at 16 kHz per row of [..., T] (the JAX package's
    `_pesq_impl`): the ITU C library's `pesq` package when installed, else
    `metrics/pesq.py:pesq_nb`."""
    from sound_bubble_tpu_torch.data.resample import resample_poly_np
    try:
        from pesq import pesq as _pesq

        def one(g16, e16):
            return _pesq(16000, g16, e16, "nb")
    except ImportError:
        from sound_bubble_tpu_torch.metrics.pesq import pesq_nb

        def one(g16, e16):
            return pesq_nb(g16, e16, fs=16000)
    out = np.empty(est.shape[:-1])
    flat_e = est.reshape(-1, est.shape[-1])
    flat_g = gt.reshape(-1, gt.shape[-1])
    for i, (e, g) in enumerate(zip(flat_e, flat_g)):
        out.flat[i] = one(resample_poly_np(g, 16000, fs),
                          resample_poly_np(e, 16000, fs))
    return out


def stoi_metric(est, gt, fs):
    from sound_bubble_tpu_torch.metrics.stoi import stoi_batch
    return torch.from_numpy(np.asarray(stoi_batch(_np(est), _np(gt), fs)))


def pesq_metric(est, gt, fs):
    return torch.from_numpy(_pesq_impl(_np(est), _np(gt), fs))


_METRICS = {
    "snr": lambda est, gt, mix: snr(est, gt),
    "snr_i": lambda est, gt, mix: snr(est, gt) - snr(mix, gt),
    "si_snr": lambda est, gt, mix: si_snr(est, gt),
    "si_snr_i": lambda est, gt, mix: si_snr(est, gt) - si_snr(mix, gt),
    "si_sdr": lambda est, gt, mix: si_sdr(est, gt),
    "si_sdr_i": lambda est, gt, mix: si_sdr(est, gt) - si_sdr(mix, gt),
}


_HOST = {"STOI": stoi_metric, "PESQ": pesq_metric}


class Metrics:
    """Name-dispatched metric: __call__(est, gt, mix) with [*, C, T] inputs,
    returns channel-averaged [*] values (reference `Metrics`). STOI and
    PESQ score est against gt at the sample rate `fs`.
    `Multi_Reso_L1` is `MultiResoFuseLoss(**kwargs)(est, gt)` as it is."""

    def __init__(self, name: str, fs: int = 24000, **kwargs):
        if name not in _METRICS and name not in _HOST \
                and name != "Multi_Reso_L1":
            raise NotImplementedError(f"Metric {name} not implemented!")
        self.name = name
        self.fs = fs
        self.kwargs = kwargs

    def __call__(self, est, gt, mix):
        if self.name == "Multi_Reso_L1":
            from sound_bubble_tpu_torch.losses.multires_stft import (
                MultiResoFuseLoss)
            return MultiResoFuseLoss(**self.kwargs)(_t(est), _t(gt))
        if self.name in _HOST:
            # averaged in float32, as the JAX package averages them
            return _HOST[self.name](est, gt, self.fs).float().mean(dim=-1)
        return _METRICS[self.name](est, gt, mix).mean(dim=-1)
