"""STFT analysis/synthesis as framed matmuls (port of `sound_bubble_tpu/ops/stft.py`).

Semantics follow the reference's asteroid STFTFB encoder/decoder
(`make_enc_dec('stft', n_filters=nfft, kernel_size=nfft, stride=chunk)`):

- analysis window: periodic sqrt-Hann of length K;
- filter rows: `[Re(DFT), Im(DFT)]` of the N-point DFT basis truncated to
  F = N//2+1 bins, globally scaled by `1 / (0.5*sqrt(K*N/stride))`, with the
  DC and Nyquist rows additionally divided by sqrt(2);
- decoder = transposed convolution with the same filters (overlap-add).

Layout is `[..., T, 2F]` (frames-major, real||imag channels minor), the same
as the JAX package, so the two can be compared array for array.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


def stft_filterbank(n_fft: int, kernel_size: int, stride: int) -> np.ndarray:
    """Build the (2F, K) analysis/synthesis filter matrix (float64 numpy)."""
    if n_fft < kernel_size:
        raise ValueError(f"n_fft ({n_fft}) < kernel_size ({kernel_size})")
    cutoff = n_fft // 2 + 1
    window = np.hanning(kernel_size + 1)[:-1] ** 0.5
    dft = np.fft.fft(np.eye(n_fft))
    dft /= 0.5 * np.sqrt(kernel_size * n_fft / stride)
    filters = np.vstack([np.real(dft[:cutoff, :]), np.imag(dft[:cutoff, :])])
    filters[0, :] /= np.sqrt(2)
    filters[n_fft // 2, :] /= np.sqrt(2)
    return (filters * window[None, :]).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class STFT:
    """Precomputed filterbank. `filters`: (2F, K) float32 tensor."""

    n_fft: int
    kernel_size: int
    stride: int
    filters: torch.Tensor

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def make_stft(n_fft: int, stride: int, kernel_size: int | None = None,
              device="cpu") -> STFT:
    kernel_size = n_fft if kernel_size is None else kernel_size
    filt = torch.as_tensor(stft_filterbank(n_fft, kernel_size, stride),
                           dtype=torch.float32, device=device)
    return STFT(n_fft, kernel_size, stride, filt)


def frame(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """[..., N] -> [..., T, K] overlapping frames, T = (N-K)//stride + 1."""
    if x.shape[-1] < kernel_size:
        raise ValueError(f"signal ({x.shape[-1]}) shorter than kernel "
                         f"({kernel_size})")
    return x.unfold(-1, kernel_size, stride)


def overlap_add(frames: torch.Tensor, stride: int) -> torch.Tensor:
    """[..., T, K] -> [..., (T-1)*stride + K] by summing shifted frames."""
    t, k = frames.shape[-2], frames.shape[-1]
    n = (t - 1) * stride + k
    n_pieces = -(-k // stride)
    lead = frames.shape[:-2]
    fpad = F.pad(frames, (0, n_pieces * stride - k))
    total = frames.new_zeros(lead + (n + n_pieces * stride,))
    for i in range(n_pieces):
        piece = fpad[..., :, i * stride:(i + 1) * stride]
        total[..., i * stride:(i + t) * stride] += piece.reshape(
            lead + (t * stride,))
    return total[..., :n]


def stft(fb: STFT, x: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., T, 2F] (real spectrum rows then imag rows, minor)."""
    return frame(x, fb.kernel_size, fb.stride) @ fb.filters.T


def istft(fb: STFT, spec: torch.Tensor) -> torch.Tensor:
    """[..., T, 2F] -> [..., (T-1)*stride + K] via transposed filterbank."""
    return overlap_add(spec @ fb.filters, fb.stride)


def mod_pad(x: torch.Tensor, chunk_size: int, pad: tuple[int, int]):
    """Pad [..., N] up to a chunk multiple, then by (back, front) lookahead.

    Returns the padded signal and the number of appended mod samples."""
    n = x.shape[-1]
    mod = (chunk_size - n % chunk_size) % chunk_size
    return F.pad(x, (pad[0], mod + pad[1])), mod
