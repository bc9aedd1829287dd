"""Torch-compatible parameter initialisers (port of `sound_bubble_tpu/ops/init.py`).

The distributions of PyTorch's defaults, which the JAX package also draws
from, here from an explicit `torch.Generator` (the values differ from the
JAX package's: the random generators differ):
- Linear / Conv: U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for kernel and bias;
- LSTM: every weight and bias U(-1/sqrt(hidden), +1/sqrt(hidden));
- PReLU: 0.25. LayerNorm: ones / zeros.
"""
from __future__ import annotations

import torch


def uniform_fan(shape, fan_in: int, generator: torch.Generator,
                dtype=torch.float32) -> torch.Tensor:
    bound = 1.0 / (fan_in ** 0.5)
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def linear_init(fan_in: int):
    def init(shape, generator, dtype=torch.float32):
        return uniform_fan(shape, fan_in, generator, dtype)
    return init


def lstm_init(hidden: int):
    def init(shape, generator, dtype=torch.float32):
        return uniform_fan(shape, hidden, generator, dtype)
    return init
