"""WAV I/O (port copy of `sound_bubble_tpu/data/audio_io.py`; scipy only).

Semantics match the reference's readers: `torchaudio.load` returns float32 in
[-1, 1] ([C, T]); `write_audio_file` takes (C, T) float and writes PCM_16 or
float.
"""
from __future__ import annotations

import numpy as np


def read_audio(path) -> tuple[np.ndarray, int]:
    """Read a wav into float32 [C, T] in [-1, 1], and its sample rate."""
    import scipy.io.wavfile

    sr, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # scipy gives [T, C]
    return np.ascontiguousarray(data), int(sr)


def read_audio_file(path, downsample: int = 1) -> np.ndarray:
    """Read a wav into float32 [C, T] in [-1, 1]; optional integer
    downsample factor (polyphase, like the reference's resample path)."""
    data, sr = read_audio(path)
    if downsample > 1:
        from sound_bubble_tpu_torch.data.resample import resample_poly_np
        data = resample_poly_np(data, sr // downsample, sr)
    return np.ascontiguousarray(data)


def write_audio_file(path, data: np.ndarray, sr: int,
                     subtype: str = "PCM_16") -> None:
    """data: [C, T] float. subtype: PCM_16 | FLOAT."""
    import scipy.io.wavfile

    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None]
    out = data.T  # [T, C]
    if subtype == "PCM_16":
        out = np.clip(out, -1.0, 1.0)
        out = (out * 32767.0).astype(np.int16)
    else:
        out = out.astype(np.float32)
    scipy.io.wavfile.write(path, sr, out)
