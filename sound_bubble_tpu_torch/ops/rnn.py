"""LSTM primitives with PyTorch cell semantics (port of `sound_bubble_tpu/ops/rnn.py`).

fp32. A scan with T >= 2 goes through `ops/kernels/lstm_slab.py:lstm_slab`,
as the JAX package's `_run_fused` routes it to the slab kernels: x moves to
scan-major [T, R, C] with the lead dims folded into R, the reverse direction
runs `reverse=True` on the same x (no flips), and hT, cT come back. On the
card that is the CUDA slab kernels, forward and backward; on the CPU their
plain PyTorch versions. T == 1 (the streaming step) is a single `_cell`.

Params per direction: {"w_ih": [C, 4H], "w_hh": [H, 4H], "b": [4H]} (JAX
layout: weights stored transposed for right-matmuls, the two torch biases
folded into one), gate order `[i, f, g, o]`.
"""
from __future__ import annotations

import math

import torch

from sound_bubble_tpu_torch.ops.kernels.lstm_slab import lstm_slab


def _cell(h, c, gates_x, w_hh, hidden):
    """One LSTM step. gates_x = x@W_ih + b precomputed. [..., 4H]."""
    gates = gates_x + h @ w_hh
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden:2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden:])
    c = f * c + i * g
    h = o * torch.tanh(c)
    return h, c


def lstm(params, x, h0=None, c0=None, reverse: bool = False):
    """Run an LSTM along axis -2 of `x` ([..., T, C]).

    Returns (y [..., T, H], (hT, cT) [..., H])."""
    hidden = params["w_hh"].shape[0]
    lead = x.shape[:-2]
    t_len = x.shape[-2]
    h = x.new_zeros(lead + (hidden,)) if h0 is None else h0
    c = x.new_zeros(lead + (hidden,)) if c0 is None else c0
    if t_len == 1:
        gates_x = x[..., 0, :] @ params["w_ih"] + params["b"]
        h, c = _cell(h, c, gates_x, params["w_hh"], hidden)
        return h[..., None, :], (h, c)
    r = math.prod(lead)
    x_t = x.movedim(-2, 0).reshape(t_len, r, x.shape[-1])
    ys, hT, cT = lstm_slab(reverse, params["w_ih"], params["w_hh"],
                           params["b"], x_t, h.reshape(r, hidden),
                           c.reshape(r, hidden))
    y = ys.reshape((t_len,) + lead + (hidden,)).movedim(0, -2)
    return y, (hT.reshape(lead + (hidden,)), cT.reshape(lead + (hidden,)))


def blstm(params, x):
    """Bidirectional LSTM over axis -2; concat outputs -> [..., T, 2H]."""
    yf, _ = lstm(params["fwd"], x)
    yb, _ = lstm(params["bwd"], x, reverse=True)
    return torch.cat([yf, yb], dim=-1)
