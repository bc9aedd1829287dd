"""LSTM primitives with PyTorch cell semantics (port of `sound_bubble_tpu/ops/rnn.py`).

fp32 only: plain torch loops over time, used by the offline and streaming
`Net` forward and as the readable statement of the cell math that the CUDA
stack kernel is held against. The bf16/mixed modes and the training scans
of the JAX package are not ported yet.

Params per direction: {"w_ih": [C, 4H], "w_hh": [H, 4H], "b": [4H]} (JAX
layout: weights stored transposed for right-matmuls, the two torch biases
folded into one), gate order `[i, f, g, o]`.
"""
from __future__ import annotations

import torch


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
    gates_x = x @ params["w_ih"] + params["b"]        # [..., T, 4H]
    lead = x.shape[:-2]
    h = x.new_zeros(lead + (hidden,)) if h0 is None else h0
    c = x.new_zeros(lead + (hidden,)) if c0 is None else c0
    t_len = x.shape[-2]
    ys = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        h, c = _cell(h, c, gates_x[..., t, :], params["w_hh"], hidden)
        ys[t] = h
    return torch.stack(ys, dim=-2), (h, c)


def blstm(params, x):
    """Bidirectional LSTM over axis -2; concat outputs -> [..., T, 2H]."""
    yf, _ = lstm(params["fwd"], x)
    yb, _ = lstm(params["bwd"], x, reverse=True)
    return torch.cat([yf, yb], dim=-1)
