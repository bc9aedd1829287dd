"""Short-Time Objective Intelligibility (STOI), Taal et al. 2011 (port copy
of `sound_bubble_tpu/metrics/stoi.py`, numpy only).

Own numpy implementation following the published algorithm with the standard
constants (10 kHz analysis rate, 256/512 frames, 15 one-third-octave bands
from 150 Hz, 384 ms segments, -15 dB clipping), so scores are comparable to
the torchmetrics/pystoi values used by the reference
(its `src/metrics/metrics.py:58`). Host-side, eval-only.
"""
from __future__ import annotations

import numpy as np

FS = 10000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30          # 384 ms at 10 kHz / hop 128
BETA = -15.0        # clipping (dB)
DYN_RANGE = 40.0    # silent-frame removal (dB)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_i:hi_i] = 1.0
    return obm, cf


def _stft_frames(x: np.ndarray) -> np.ndarray:
    hop = N_FRAME // 2
    n = (len(x) - N_FRAME) // hop + 1
    if n < 1:
        return np.zeros((0, NFFT // 2 + 1))
    w = np.hanning(N_FRAME + 2)[1:-1]
    idx = np.arange(N_FRAME)[None, :] + hop * np.arange(n)[:, None]
    return np.fft.rfft(x[idx] * w, NFFT, axis=-1)


def _remove_silent(x: np.ndarray, y: np.ndarray):
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    n = (len(x) - N_FRAME) // hop + 1
    if n < 1:
        return x, y
    idx = np.arange(N_FRAME)[None, :] + hop * np.arange(n)[:, None]
    xw = x[idx] * w
    energies = 20 * np.log10(np.linalg.norm(xw, axis=1) + 1e-12)
    mask = energies > energies.max() - DYN_RANGE
    xk = x[idx][mask] * w
    yk = y[idx][mask] * w
    m = xk.shape[0]
    xs = np.zeros((m - 1) * hop + N_FRAME if m else 0)
    ys = np.zeros_like(xs)
    for i in range(m):
        xs[i * hop:i * hop + N_FRAME] += xk[i]
        ys[i * hop:i * hop + N_FRAME] += yk[i]
    return xs, ys


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Scalar STOI score; clean/processed are 1-D at sample rate fs."""
    from sound_bubble_tpu_torch.data.resample import resample_poly_np

    if fs != FS:
        clean = resample_poly_np(clean, FS, fs)
        processed = resample_poly_np(processed, FS, fs)
    clean, processed = _remove_silent(clean, processed)
    X = _stft_frames(clean)
    Y = _stft_frames(processed)
    if X.shape[0] < N_SEG:
        return float("nan")
    obm, _ = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    Xb = np.sqrt(obm @ (np.abs(X.T) ** 2))      # [bands, frames]
    Yb = np.sqrt(obm @ (np.abs(Y.T) ** 2))
    clip = 10 ** (-BETA / 20)
    scores = []
    for m in range(N_SEG, Xb.shape[1] + 1):
        xs = Xb[:, m - N_SEG:m]
        ys = Yb[:, m - N_SEG:m]
        alpha = np.sqrt(np.sum(xs ** 2, axis=1, keepdims=True)
                        / (np.sum(ys ** 2, axis=1, keepdims=True) + 1e-12))
        ysn = np.minimum(ys * alpha, xs * (1 + clip))
        xm = xs - xs.mean(axis=1, keepdims=True)
        ym = ysn - ysn.mean(axis=1, keepdims=True)
        num = np.sum(xm * ym, axis=1)
        den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
        scores.append(np.mean(num / den))
    return float(np.mean(scores))


def stoi_batch(est: np.ndarray, gt: np.ndarray, fs: int) -> np.ndarray:
    """est/gt: [..., T]; STOI(gt as clean, est as processed) per row."""
    lead = est.shape[:-1]
    out = np.empty(int(np.prod(lead)) if lead else 1)
    fe = est.reshape(-1, est.shape[-1])
    fg = gt.reshape(-1, gt.shape[-1])
    for i in range(fe.shape[0]):
        out[i] = stoi(fg[i], fe[i], fs)
    return out.reshape(lead) if lead else out[0]
