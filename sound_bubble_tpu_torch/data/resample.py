"""Polyphase resampling (port copy of `sound_bubble_tpu/data/resample.py`)."""
from __future__ import annotations

import math

import numpy as np


def resample_poly_np(x: np.ndarray, target_sr: int, orig_sr: int) -> np.ndarray:
    """Resample along the last axis via scipy polyphase filtering."""
    if target_sr == orig_sr:
        return x
    import scipy.signal

    g = math.gcd(int(target_sr), int(orig_sr))
    return scipy.signal.resample_poly(x, target_sr // g, orig_sr // g, axis=-1)
