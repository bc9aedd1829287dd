"""FFT-domain convolution for long room impulse responses (port of
`sound_bubble_tpu/ops/fft_conv.py:fft_conv`)."""
from __future__ import annotations

import torch


def fft_conv(signal: torch.Tensor, kernel: torch.Tensor,
             mode: str = "full") -> torch.Tensor:
    """Linear convolution along the last axis via rfft (leading dims
    broadcast). mode: 'full' | 'same' | 'valid'."""
    n = signal.shape[-1] + kernel.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    out = torch.fft.irfft(torch.fft.rfft(signal, nfft)
                          * torch.fft.rfft(kernel, nfft), nfft)[..., :n]
    if mode == "full":
        return out
    if mode == "same":
        start = (kernel.shape[-1] - 1) // 2
        return out[..., start:start + signal.shape[-1]]
    if mode == "valid":
        k = kernel.shape[-1]
        return out[..., k - 1:signal.shape[-1]]
    raise ValueError(mode)
