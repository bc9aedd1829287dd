"""Colored (1/f^beta) noise with a per-row exponent, Timmer & Koenig (1995)
(port of `sound_bubble_tpu/ops/noise.py:colored_noise_traced`).

Split into the draws (`colored_noise_draws`, from an explicit
`torch.Generator`) and the synthesis (`colored_noise`), so a caller can hand
the synthesis other draws of the same distribution.
"""
from __future__ import annotations

import math

import numpy as np
import torch


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
