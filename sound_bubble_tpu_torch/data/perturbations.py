"""Training-time audio perturbations (port copy of
`sound_bubble_tpu/data/perturbations.py`; numpy, host-side).

Mirrors the reference's perturbation chain
(`src/datasets/perturbations/`): each entry of the config list
is `{"type": <class path>, "prob": p, "params": {...}}`; with probability p the
perturbation is applied to (mixture [C,T], gt [R,T]), gt following the
reference channels. The sox-based SpeedPerturbation is replaced by exact
polyphase resampling (no sox dependency).
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np



# colored (1/f^beta) noise, Timmer & Koenig (1995): copy of
# `sound_bubble_tpu/ops/noise.py:powerlaw_psd_gaussian`
def powerlaw_psd_gaussian(exponent: float, size, fmin: float = 0.0,
                          rng: np.random.Generator | None = None) -> np.ndarray:
    if rng is None:
        rng = np.random.default_rng()
    size = list(size) if not isinstance(size, int) else [size]
    samples = size[-1]
    f = np.fft.rfftfreq(samples)
    if not 0 <= fmin <= 0.5:
        raise ValueError("fmin must be chosen between 0 and 0.5.")
    fmin = max(fmin, 1.0 / samples)
    s_scale = f.copy()
    ix = int(np.sum(s_scale < fmin))
    if ix and ix < len(s_scale):
        s_scale[:ix] = s_scale[ix]
    s_scale = s_scale ** (-exponent / 2.0)
    w = s_scale[1:].copy()
    w[-1] *= (1 + (samples % 2)) / 2.0
    sigma = 2 * np.sqrt(np.sum(w ** 2)) / samples
    size[-1] = len(f)
    sr = rng.normal(scale=s_scale, size=size)
    si = rng.normal(scale=s_scale, size=size)
    if not (samples % 2):
        si[..., -1] = 0
        sr[..., -1] *= np.sqrt(2)
    si[..., 0] = 0
    sr[..., 0] *= np.sqrt(2)
    y = np.fft.irfft(sr + 1j * si, n=samples, axis=-1) / sigma
    return y


class ChannelDropPerturbation:
    """Zero 1..max random non-reference channels."""

    def __init__(self, max_channel_drops: int):
        self.max_channel_drops = max_channel_drops

    def __call__(self, audio, gt):
        c = audio.shape[0]
        n = np.random.randint(1, self.max_channel_drops + 1)
        drop = 1 + np.random.permutation(c - 1)[:n]
        audio = audio.copy()
        audio[drop] = 0.0
        return audio, gt


class ChannelGainPerturbation:
    """Per-channel random gain in ±max_db; gt follows reference channels."""

    def __init__(self, max_channel_gain_db: float, reference_channels=(0,),
                 unique: bool = False):
        self.max_db = max_channel_gain_db
        self.unique = unique
        self.ref = list(reference_channels)

    def __call__(self, audio, gt):
        c = audio.shape[0]
        if self.unique:
            gains = np.full(c, 10 ** ((np.random.rand() * 2 - 1)
                                      * self.max_db / 20))
        else:
            gains = 10 ** ((np.random.rand(c) * 2 - 1) * self.max_db / 20)
        audio = audio * gains[:, None]
        gt = gt.copy()
        for gi, ch in enumerate(self.ref):
            gt[gi] = gt[gi] * gains[ch]
        return audio, gt


class SampleShiftPerturbation:
    """Per-channel circular shift of up to ±max_shift samples."""

    def __init__(self, max_shift: int, reference_channels=(0,),
                 unique: bool = False):
        self.max_shift = max_shift
        self.unique = unique
        self.ref = list(reference_channels)

    def __call__(self, audio, gt):
        c = audio.shape[0]
        if self.unique:
            shifts = np.full(c, np.random.randint(-self.max_shift,
                                                  self.max_shift + 1))
        else:
            shifts = np.random.randint(-self.max_shift, self.max_shift + 1, c)
        audio = np.stack([np.roll(audio[i], shifts[i]) for i in range(c)])
        gt = gt.copy()
        for gi, ch in enumerate(self.ref):
            gt[gi] = np.roll(gt[gi], shifts[ch])
        return audio, gt


class PeakNormPerturbation:
    """Random peak renormalization of mixture+gt (reference draws the scale
    from a *normal* distribution — mirrored)."""

    def __init__(self, min_scale: float, max_scale: float):
        self.min_scale, self.max_scale = min_scale, max_scale

    def __call__(self, audio, gt):
        peak = np.abs(audio).max()
        scale = (np.random.randn() * (self.max_scale - self.min_scale)
                 + self.min_scale) / (peak + 1e-6)
        return audio * scale, gt * scale


class SpeedPerturbation:
    """Speed change (pitch+tempo) via polyphase resampling, then pad/trim to
    the original length (replaces sox `speed`+`rate`)."""

    def __init__(self, min_speed: float, max_speed: float,
                 sample_rate: int = 24000):
        self.min_speed, self.max_speed = min_speed, max_speed
        self.sample_rate = sample_rate

    def __call__(self, audio, gt):
        import scipy.signal

        t = audio.shape[-1]
        factor = np.random.rand() * (self.max_speed - self.min_speed) + self.min_speed
        frac = Fraction(factor).limit_denominator(1000)
        up, down = frac.denominator, frac.numerator

        def proc(x):
            y = scipy.signal.resample_poly(x, up, down, axis=-1)
            if y.shape[-1] > t:
                return y[..., :t]
            pad = [(0, 0)] * (y.ndim - 1) + [(0, t - y.shape[-1])]
            return np.pad(y, pad)

        return proc(audio).astype(audio.dtype), proc(gt).astype(gt.dtype)


def _stft_np(x, nfft, hop):
    """torch.stft(center=True, rect window) equivalent."""
    xp = np.pad(x, (nfft // 2, nfft // 2), mode="reflect")
    n = (len(xp) - nfft) // hop + 1
    idx = np.arange(nfft)[None, :] + hop * np.arange(n)[:, None]
    return np.fft.rfft(xp[idx], axis=-1).T  # [F, frames]


def _istft_np(spec, nfft, hop, length):
    frames = np.fft.irfft(spec.T, n=nfft, axis=-1)
    n = frames.shape[0]
    total = (n - 1) * hop + nfft
    y = np.zeros(total)
    norm = np.zeros(total)
    for i in range(n):
        y[i * hop:i * hop + nfft] += frames[i]
        norm[i * hop:i * hop + nfft] += 1.0
    y = y / np.maximum(norm, 1e-12)
    return y[nfft // 2:nfft // 2 + length]


class FrequencyMaskingPerturbation:
    """Zero random STFT bins (nfft 4096); gt follows reference channels."""

    def __init__(self, min_freq_masks: int, max_freq_masks: int,
                 unique: bool = False, nfft: int = 4096,
                 reference_channels=(0,)):
        self.min_m, self.max_m = min_freq_masks, max_freq_masks
        self.unique = unique
        self.nfft = nfft
        self.ref = list(reference_channels)

    def __call__(self, audio, gt):
        c, t = audio.shape
        nbin = self.nfft // 2 + 1
        hop = self.nfft // 4

        def pick():
            n = np.random.randint(self.min_m, self.max_m + 1)
            return np.random.permutation(nbin)[:n]

        masks = [pick()] * c if self.unique else [pick() for _ in range(c)]
        audio = audio.copy()
        gt = gt.copy()
        gi = 0
        for i in range(c):
            s = _stft_np(audio[i], self.nfft, hop)
            s[masks[i]] = 0
            audio[i] = _istft_np(s, self.nfft, hop, t)
            if i in self.ref:
                s = _stft_np(gt[gi], self.nfft, hop)
                s[masks[i]] = 0
                gt[gi] = _istft_np(s, self.nfft, hop, t)
                gi += 1
        return audio, gt


class WhitePinkBrownPerturbation:
    """Add white + pink + brown noise at random levels to the mixture only."""

    def __init__(self, max_white_level=1e-3, max_pink_level=5e-3,
                 max_brown_level=5e-3):
        self.levels = (max_white_level, max_pink_level, max_brown_level)

    def __call__(self, audio, gt):
        wl, pl, bl = self.levels
        shape = audio.shape
        noise = (wl * np.random.rand()) * np.random.normal(size=shape)
        noise += (pl * np.random.rand()) * powerlaw_psd_gaussian(1, shape)
        noise += (bl * np.random.rand()) * powerlaw_psd_gaussian(2, shape)
        return audio + noise.astype(audio.dtype), gt


class AudioPerturbations:
    """Config-driven chain (reference `audio_perturbations.py:4-33`)."""

    def __init__(self, perturbations_list):
        from sound_bubble_tpu_torch.utils import import_attr

        self.perturbations = []
        self.probs = []
        for desc in perturbations_list:
            assert "type" in desc, "Perturbation has no specified type!"
            assert "prob" in desc, "Perturbation has no specified probability!"
            params = desc.get("params", {})
            self.perturbations.append(import_attr(desc["type"])(**params))
            self.probs.append(desc["prob"])

    def apply_random_perturbations(self, audio, gt):
        for prob, pert in zip(self.probs, self.perturbations):
            if np.random.rand() < prob:
                audio, gt = pert(audio, gt)
        return audio, gt
