"""Colored (1/f^beta) noise, Timmer & Koenig (1995) (port of
`sound_bubble_tpu/ops/noise.py`).

- `powerlaw_psd_gaussian`: numpy, one exponent, from an
  `np.random.Generator` (the reference's `helpers/pink_noise.py`, unit
  variance; pink beta=1, brown beta=2);
- `powerlaw_draws` / `powerlaw_noise`: the same synthesis on tensors, one
  exponent for the whole batch (the JAX package's
  `powerlaw_psd_gaussian_jax`);
- `colored_noise_draws` / `colored_noise`: a per-row exponent
  (`colored_noise_traced`).

The tensor versions are split into the draws (from an explicit
`torch.Generator`) and the synthesis, so a caller can hand the synthesis
other draws of the same distribution.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _envelope(exponent: float, samples: int, fmin: float):
    """The 1/f^(exponent/2) amplitude envelope [samples // 2 + 1] (bins
    under fmin take fmin's value) and the unit-variance normalizer."""
    f = np.fft.rfftfreq(samples)
    fmin = max(fmin, 1.0 / samples)
    s_scale = f.copy()
    ix = int(np.sum(s_scale < fmin))
    if ix and ix < len(s_scale):
        s_scale[:ix] = s_scale[ix]
    s_scale = s_scale ** (-exponent / 2.0)
    w = s_scale[1:].copy()
    w[-1] *= (1 + (samples % 2)) / 2.0
    return s_scale, 2 * np.sqrt(np.sum(w ** 2)) / samples


def powerlaw_psd_gaussian(exponent: float, size, fmin: float = 0.0,
                          rng: np.random.Generator | None = None
                          ) -> np.ndarray:
    """Gaussian noise of one exponent, [*size] (numpy; the JAX package's
    `powerlaw_psd_gaussian`, the same `rng` draws)."""
    if rng is None:
        rng = np.random.default_rng()
    size = list(size) if not isinstance(size, int) else [size]
    samples = size[-1]
    if not 0 <= fmin <= 0.5:
        raise ValueError("fmin must be chosen between 0 and 0.5.")
    s_scale, sigma = _envelope(exponent, samples, fmin)
    size[-1] = len(s_scale)
    sr = rng.normal(scale=s_scale, size=size)
    si = rng.normal(scale=s_scale, size=size)
    if not (samples % 2):
        si[..., -1] = 0
        sr[..., -1] *= np.sqrt(2)
    si[..., 0] = 0
    sr[..., 0] *= np.sqrt(2)
    y = np.fft.irfft(sr + 1j * si, n=samples, axis=-1) / sigma
    return y


def powerlaw_draws(gen: torch.Generator, shape, n: int,
                   device="cuda") -> dict:
    """The draws of `powerlaw_noise`: `colored_noise_draws` on `device`."""
    return colored_noise_draws(gen, shape, n, device)


def powerlaw_noise(exponent: float, draws: dict, n: int) -> torch.Tensor:
    """[*shape, n] noise of one exponent (0 white, 1 pink, 2 brown), unit
    variance per row asymptotically, from the draws of `powerlaw_draws`, on
    their device. The spectral envelope and its normalizer are numpy
    constants, as in `powerlaw_psd_gaussian_jax`."""
    s_scale, sigma = _envelope(exponent, n, 0.0)
    scale = torch.as_tensor(s_scale, dtype=torch.float32,
                            device=draws["re"].device)
    sr = draws["re"] * scale
    si = draws["im"] * scale
    if not n % 2:
        si = torch.cat([si[..., :-1], torch.zeros_like(si[..., -1:])], -1)
        sr = torch.cat([sr[..., :-1], sr[..., -1:] * math.sqrt(2)], -1)
    si = torch.cat([torch.zeros_like(si[..., :1]), si[..., 1:]], -1)
    sr = torch.cat([sr[..., :1] * math.sqrt(2), sr[..., 1:]], -1)
    return torch.fft.irfft(torch.complex(sr, si), n=n, dim=-1) / float(sigma)


def colored_noise_draws(gen: torch.Generator, shape, n: int,
                        device="cpu") -> dict:
    """The two standard-normal spectra, {"re", "im"}: [*shape, n // 2 + 1]."""
    size = tuple(shape) + (n // 2 + 1,)
    return {"re": torch.randn(size, generator=gen, device=device),
            "im": torch.randn(size, generator=gen, device=device)}


def colored_noise(beta: torch.Tensor, draws: dict, n: int) -> torch.Tensor:
    """[..., n] noise of exponent beta [...] (0 white, 1 pink, 2 brown),
    unit variance per row asymptotically, from the draws of
    `colored_noise_draws`."""
    f = np.fft.rfftfreq(n)
    f_c = torch.as_tensor(np.maximum(f, 1.0 / n), dtype=torch.float32,
                          device=beta.device)
    s_scale = f_c ** (-beta.float()[..., None] / 2.0)        # [..., nf]
    w = s_scale[..., 1:]
    if not n % 2:
        w = torch.cat([w[..., :-1], w[..., -1:] * 0.5], dim=-1)
    sigma = 2.0 * torch.sqrt(torch.sum(w ** 2, dim=-1, keepdim=True)) / n
    sr = draws["re"] * s_scale
    si = draws["im"] * s_scale
    if not n % 2:
        si = torch.cat([si[..., :-1], torch.zeros_like(si[..., -1:])], -1)
        sr = torch.cat([sr[..., :-1], sr[..., -1:] * math.sqrt(2)], -1)
    si = torch.cat([torch.zeros_like(si[..., :1]), si[..., 1:]], -1)
    sr = torch.cat([sr[..., :1] * math.sqrt(2), sr[..., 1:]], -1)
    return torch.fft.irfft(torch.complex(sr, si), n=n, dim=-1) / sigma
