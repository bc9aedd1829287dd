"""Shoebox image-source room simulation (port of
`sound_bubble_tpu/datagen/ism.py`).

From-scratch Allen & Berkley ISM with pyroomacoustics-equivalent semantics
(the reference's simulator), numpy copies of the JAX package's:
- shoebox room at the origin, uniform energy `absorption` on all walls
  (reflection coefficient rho = sqrt(1 - absorption) per bounce),
- images up to `max_order` TOTAL reflections, amplitude rho^n / (4 pi d),
- fractional delays via an 81-tap Hann-windowed sinc (`compute_rir`,
  accumulated through `np.bincount`),
- `ShoeBox.simulate(return_premix=True)` -> [n_src, n_mic, T] per-source mic
  signals (`scipy.signal.fftconvolve`),
- Schroeder-integration RT60 measurement.

`compute_rirs_torch` is the frequency-domain variant on tensors (the JAX
package's `compute_rirs_jax`): one complex sum over every image at once, on
the device of its inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SPEED_OF_SOUND = 343.0
FDL = 81  # fractional delay filter length (odd)


def shoebox_images(room_dim, source, max_order: int):
    """Image positions + reflection counts for a shoebox at the origin.

    Returns (positions [N,3], n_reflections [N])."""
    room_dim = np.asarray(room_dim, np.float64)
    source = np.asarray(source, np.float64)
    per_axis = []
    for ax in range(3):
        q = np.arange(-(max_order // 2 + 1), max_order // 2 + 2)
        # family +s: x = 2qL + s, n = |2q| ; family -s: x = 2qL - s, n = |2q-1|
        pos = np.concatenate([2 * q * room_dim[ax] + source[ax],
                              2 * q * room_dim[ax] - source[ax]])
        refl = np.concatenate([np.abs(2 * q), np.abs(2 * q - 1)])
        keep = refl <= max_order
        per_axis.append((pos[keep], refl[keep]))
    px, nx = per_axis[0]
    py, ny = per_axis[1]
    pz, nz = per_axis[2]
    NX, NY, NZ = np.meshgrid(nx, ny, nz, indexing="ij")
    total = NX + NY + NZ
    mask = total <= max_order
    PX, PY, PZ = np.meshgrid(px, py, pz, indexing="ij")
    positions = np.stack([PX[mask], PY[mask], PZ[mask]], axis=-1)
    return positions, total[mask]


def compute_rir(images, n_refl, mic, fs: int, rir_len: int,
                absorption: float, c: float = SPEED_OF_SOUND) -> np.ndarray:
    """Time-domain RIR at one mic from precomputed images."""
    rho = np.sqrt(1.0 - absorption)
    d = np.linalg.norm(images - np.asarray(mic)[None, :], axis=-1)
    d = np.maximum(d, 1e-3)
    amp = (rho ** n_refl) / (4.0 * np.pi * d)
    delay = d / c * fs
    di = np.floor(delay).astype(np.int64)
    frac = delay - di
    half = FDL // 2
    k = np.arange(FDL)[None, :]
    # Hann-windowed sinc centered at `half + frac`
    t = k - half - frac[:, None]
    win = 0.5 * (1 + np.cos(np.pi * (k - half - frac[:, None]) / (half + 1)))
    win = np.clip(win, 0.0, None)
    taps = np.sinc(t) * win * amp[:, None]
    idx = di[:, None] - half + k
    valid = (idx >= 0) & (idx < rir_len)
    rir = np.bincount(np.where(valid, idx, 0).ravel(),
                      weights=np.where(valid, taps, 0.0).ravel(),
                      minlength=rir_len)
    return rir[:rir_len]


def irfft_real(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """irfft along the last axis of the spectrum re + j im [..., n // 2 + 1]
    with the imaginary parts of the DC bin and, for an even n, the Nyquist
    bin dropped: a real signal's spectrum has none there, the CPU's FFT
    ignores them and cuFFT does not, so an image sum, which has them, would
    give another RIR on the card."""
    im = im.clone()
    im[..., 0] = 0.0
    if n % 2 == 0:
        im[..., -1] = 0.0
    return torch.fft.irfft(torch.complex(re, im), n=n, dim=-1)


def compute_rirs_torch(images, n_refl, mics, fs, rir_len, absorption,
                       c: float = SPEED_OF_SOUND, device="cuda"):
    """Frequency-domain image sum (the JAX package's `compute_rirs_jax`):
    H[f] = sum_i a_i * exp(-2 pi i f tau_i); RIR = irfft(H), in float32 /
    complex64 on `device`, every image in one sum.
    images [N,3], mics [M,3] -> [M, rir_len]."""
    rho = np.sqrt(1.0 - absorption)
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                           device=device)
    mics = torch.as_tensor(np.asarray(mics), dtype=torch.float32,
                           device=device)
    nr = torch.as_tensor(np.asarray(n_refl), dtype=torch.float32,
                         device=device)
    diff = imgs[None, :, :] - mics[:, None, :]
    sq = diff * diff
    # the root in float64, rounded once: PyTorch's float32 root on the card
    # is not correctly rounded, the CPU's is
    d = torch.sqrt((sq[..., 0] + sq[..., 1] + sq[..., 2]).double()).float()
    d = torch.clamp(d, min=1e-3)
    amp = (float(rho) ** nr)[None, :] / (4 * math.pi * d)
    tau = d / torch.tensor(c, dtype=torch.float32, device=device)
    nf = rir_len // 2 + 1
    freqs = torch.arange(nf, dtype=torch.float32, device=device) * (
        fs / rir_len)
    phase = 2 * math.pi * tau[..., None] * freqs[None, None, :]  # [M, N, F]
    h = torch.sum(amp[..., None] * torch.exp(
        -1j * phase.to(torch.complex64)), dim=1)
    return irfft_real(h.real, h.imag, rir_len)


class ShoeBox:
    """Minimal pyroomacoustics.ShoeBox-compatible surface:
    add_microphone_array / add_source / simulate(return_premix) /
    measure_rt60."""

    def __init__(self, p, fs: int = 24000, max_order: int = 17,
                 absorption: float = 0.3):
        self.dim = list(p) if len(p) == 3 else list(p) + [3.0]
        self.fs = fs
        self.max_order = max_order
        self.absorption = absorption
        self.mics = None
        self.sources = []
        self._rirs = None

    def add_microphone_array(self, mic_positions, directivity=None):
        self.mics = np.asarray(mic_positions, np.float64).T  # [M, 3]

    def add_source(self, position, signal=None):
        self.sources.append((np.asarray(position, np.float64),
                             np.asarray(signal, np.float64)))

    def _rir_len(self):
        diag = np.linalg.norm(self.dim)
        max_d = (self.max_order + 1) * diag
        return int(max_d / SPEED_OF_SOUND * self.fs) + FDL + 8

    def compute_rirs(self):
        rir_len = self._rir_len()
        self._rirs = []
        for src, _ in self.sources:
            images, n_refl = shoebox_images(self.dim, src, self.max_order)
            per_mic = [compute_rir(images, n_refl, mic, self.fs, rir_len,
                                   self.absorption) for mic in self.mics]
            self._rirs.append(np.stack(per_mic))
        return self._rirs

    def simulate(self, return_premix: bool = True):
        import scipy.signal

        if self._rirs is None:
            self.compute_rirs()
        premix = []
        for (src, sig), rirs in zip(self.sources, self._rirs):
            out = scipy.signal.fftconvolve(sig[None, :], rirs, axes=-1)
            premix.append(out)
        n = max(p.shape[-1] for p in premix)
        premix = np.stack([np.pad(p, ((0, 0), (0, n - p.shape[-1])))
                           for p in premix])
        if return_premix:
            return premix
        return premix.sum(axis=0)

    def measure_rt60(self):
        if self._rirs is None:
            self.compute_rirs()
        vals = []
        for rirs in self._rirs:
            for rir in rirs:
                vals.append(measure_rt60(rir, self.fs))
        return np.asarray(vals)


def measure_rt60(rir: np.ndarray, fs: int, decay_db: float = 60.0) -> float:
    """Schroeder-integration RT60 (extrapolated from the -5..-25 dB slope)."""
    energy = rir ** 2
    edc = np.cumsum(energy[::-1])[::-1]
    edc = edc / (edc[0] + 1e-30)
    db = 10 * np.log10(edc + 1e-30)
    try:
        i5 = np.where(db <= -5)[0][0]
        i25 = np.where(db <= -25)[0][0]
    except IndexError:
        return 0.0
    if i25 <= i5:
        return 0.0
    slope = (db[i25] - db[i5]) / ((i25 - i5) / fs)  # dB per second
    return float(-decay_db / slope)
