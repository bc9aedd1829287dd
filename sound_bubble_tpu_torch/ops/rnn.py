"""LSTM primitives with PyTorch cell semantics (port of `sound_bubble_tpu/ops/rnn.py`).

Two kernel routes for a scan, chosen per call by `scan` (never a module
global):

- `scan="slab"` (the default): a scan with T >= 2 goes through
  `ops/kernels/lstm_slab.py:lstm_slab`, as the JAX package's `_run_fused`
  routes it to the slab kernels: x moves to scan-major [T, R, C] with the
  lead dims folded into R, the reverse direction runs `reverse=True` on the
  same x (no flips), and hT, cT come back. `blstm` is two such scans.
- `scan="seq"`: the JAX package's custom-VJP kernel route (`SB_LSTM_FUSED=0
  SB_LSTM_CUSTOM_VJP=1 SB_LSTM_PALLAS_TRAIN=1`, `rnn.py:_run_cvjp` and the
  `_PALLAS_TRAIN` branch of its `blstm`): a forward scan with T >= 2 goes
  through `ops/kernels/lstm_train_kernel.py:lstm_seq`, `blstm` through
  `blstm_seq` (both directions in one walk, any T). `reverse=True` raises
  NotImplementedError: JAX runs that case on its XLA scan.

On the card each route is its CUDA kernels, forward and backward; on the
CPU their plain PyTorch versions. T == 1 of `lstm` (the streaming step) is a
single `_cell` on either route. `scan_from_env` gives the training CLIs'
default route from the JAX package's environment switches.

`blstm(..., pallas_blstm=True)` (the JAX package's `SB_PALLAS_BLSTM=1` /
`set_pallas_blstm` branch, an argument here and never a module global)
sends every 3-D input, whatever its size, to the fused inference BLSTM of
`ops/kernels/lstm_kernel.py` (row 5's kernel): float32 only, no gradients.
JAX's 8 MB VMEM gate does not carry over (see that module).
`pallas_blstm_from_env` reads the switch from the environment.

Mixed precision (the JAX package's rule): when the weights or the
activations are bfloat16 the (h, c) carry is float32, the recurrence matmul
takes bf16(h) with float32 accumulation, and the gates are rounded to bf16
(`bf16_gates=True`, the JAX package's `SB_LSTM_BF16_GATES=1` default). The
outputs y come back in x's dtype and (hT, cT) in the state's. A bf16 scan
with `bf16_gates=False` raises NotImplementedError on both routes: the JAX
package runs that corner through its XLA scans, not its kernels.

Params per direction: {"w_ih": [C, 4H], "w_hh": [H, 4H], "b": [4H]} (JAX
layout: weights stored transposed for right-matmuls, the two torch biases
folded into one), gate order `[i, f, g, o]`.
"""
from __future__ import annotations

import math
import os

import torch

from sound_bubble_tpu_torch.ops.kernels.lstm_kernel import blstm_infer
from sound_bubble_tpu_torch.ops.kernels.lstm_slab import (
    act, lstm_slab, tanh_q)
from sound_bubble_tpu_torch.ops.kernels.lstm_train_kernel import (
    blstm_seq, lstm_seq)

SCANS = ("slab", "seq")


def scan_from_env(env=None) -> str:
    """The route the JAX package's training takes under its environment:
    "seq" exactly when SB_LSTM_FUSED=0, SB_LSTM_CUSTOM_VJP=1 and
    SB_LSTM_PALLAS_TRAIN=1, else "slab"."""
    env = os.environ if env is None else env
    seq = (env.get("SB_LSTM_FUSED", "1") == "0"
           and env.get("SB_LSTM_CUSTOM_VJP", "0") == "1"
           and env.get("SB_LSTM_PALLAS_TRAIN", "0") == "1")
    return "seq" if seq else "slab"


def pallas_blstm_from_env(env=None) -> bool:
    """The JAX package's opt-in fused inference BLSTM switch:
    SB_PALLAS_BLSTM=1."""
    env = os.environ if env is None else env
    return env.get("SB_PALLAS_BLSTM", "0") == "1"


def _check_scan(scan):
    if scan not in SCANS:
        raise ValueError(f"scan={scan!r}: one of {SCANS}")


def _check_gates(mixed, bf16_gates):
    if mixed and not bf16_gates:
        raise NotImplementedError(
            "a bfloat16 LSTM scan with bf16_gates=False is not ported: the "
            "kernels round the gates to bf16 (ROADMAP Queue 2)")


def matmul(a, b):
    """`a @ b` with JAX's type promotion: both operands go to the promoted
    dtype first (torch.matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _cell(h, c, gates_x, w_hh, hidden, bf16_gates: bool = True):
    """One LSTM step. gates_x = x@W_ih + b precomputed. [..., 4H].

    Mixed precision (bf16 weights, float32 carry): the recurrence matmul
    takes bf16(h) with float32 accumulation; the gates are rounded to bf16
    when `bf16_gates`, and the nonlinearities run in the gates' dtype."""
    if w_hh.dtype != h.dtype:
        gates = gates_x.float() + h.to(w_hh.dtype).float() @ w_hh.float()
        if bf16_gates:
            gates = gates.bfloat16()
    else:
        gates = gates_x + h @ w_hh
    i, f, g, o = act(gates, hidden)
    c = (f * c).to(c.dtype) + i * g
    h = o * tanh_q(c.to(gates.dtype))
    return (h.float() if h.dtype != c.dtype else h), c


def lstm(params, x, h0=None, c0=None, reverse: bool = False,
         bf16_gates: bool = True, scan: str = "slab"):
    """Run an LSTM along axis -2 of `x` ([..., T, C]) on the kernel route
    `scan` ("slab" or "seq").

    Returns (y [..., T, H] in x's dtype, (hT, cT) [..., H] in the state's
    dtype: h0's, or x's when h0 is None)."""
    _check_scan(scan)
    w_ih, w_hh, b = params["w_ih"], params["w_hh"], params["b"]
    hidden = w_hh.shape[0]
    lead = x.shape[:-2]
    t_len = x.shape[-2]
    mixed = torch.bfloat16 in (w_hh.dtype, x.dtype)
    carry = torch.float32 if mixed else x.dtype
    state_dtype = x.dtype if h0 is None else h0.dtype
    h = x.new_zeros(lead + (hidden,), dtype=carry) if h0 is None \
        else h0.to(carry)
    c = x.new_zeros(lead + (hidden,), dtype=carry) if c0 is None \
        else c0.to(carry)
    if t_len == 1:
        gates_x = matmul(x[..., 0, :], w_ih) + b
        h, c = _cell(h, c, gates_x, w_hh, hidden, bf16_gates)
        return (h.to(x.dtype)[..., None, :],
                (h.to(state_dtype), c.to(state_dtype)))
    _check_gates(mixed, bf16_gates)
    r = math.prod(lead)
    x_t = x.movedim(-2, 0).reshape(t_len, r, x.shape[-1])
    h, c = h.reshape(r, hidden), c.reshape(r, hidden)
    if scan == "slab":
        ys, hT, cT = lstm_slab(reverse, w_ih, w_hh, b, x_t, h, c)
    elif reverse:
        raise NotImplementedError(
            "reverse=True on the seq route: the JAX package runs a reversed "
            "scan of its custom-VJP route on its XLA scan, not its kernels")
    else:
        ys, hT, cT = lstm_seq(w_ih, w_hh, b, x_t, h, c)
    y = ys.reshape((t_len,) + lead + (hidden,)).movedim(0, -2)
    return y, (hT.reshape(lead + (hidden,)).to(state_dtype),
               cT.reshape(lead + (hidden,)).to(state_dtype))


def blstm(params, x, bf16_gates: bool = True, scan: str = "slab",
          pallas_blstm: bool = False):
    """Bidirectional LSTM over axis -2; concat outputs -> [..., T, 2H].
    `pallas_blstm` with a 3-D x: the fused inference kernel (row 5)."""
    _check_scan(scan)
    if pallas_blstm and x.dim() == 3:
        return blstm_infer(params, x)
    if scan == "slab":
        yf, _ = lstm(params["fwd"], x, bf16_gates=bf16_gates, scan=scan)
        yb, _ = lstm(params["bwd"], x, reverse=True, bf16_gates=bf16_gates,
                     scan=scan)
        return torch.cat([yf, yb], dim=-1)
    fwd, bwd = params["fwd"], params["bwd"]
    _check_gates(torch.bfloat16 in (fwd["w_hh"].dtype, x.dtype), bf16_gates)
    lead, t_len = x.shape[:-2], x.shape[-2]
    x_t = x.movedim(-2, 0).reshape(t_len, math.prod(lead), x.shape[-1])
    y = blstm_seq(fwd, bwd, x_t)
    return y.reshape((t_len,) + lead + (y.shape[-1],)).movedim(0, -2)
