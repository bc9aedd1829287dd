"""Fused-direction inference BLSTM: port of
`sound_bubble_tpu/ops/pallas/lstm_kernel.py` (`_pack_weights`,
`blstm_pallas`), row 5 of PERF.md's kernel table.

Both directions of a bidirectional LSTM from zero states in one launch, for
inference (no backward, as `blstm_pallas` has no VJP), in float32:

- `blstm_infer(params, x)`: x [R, T, C] -> y [R, T, 2H] = [y_f | y_b], both
  in original time order, from the port's own `{fwd, bwd: {w_ih, w_hh, b}}`
  params, so a checkpoint of either package serves on this route with no
  other conversion. It runs `blstm_recur`: the hand-written CUDA kernel of
  `sound_bubble_tpu_torch/csrc/lstm_infer.cu` for tensors on the card (one
  launch a call, projection included; `blstm_infer.launches` counts them),
  the plain version for tensors on the CPU. A CUDA tensor goes to the kernel
  or the call raises: a hidden width other than the one the kernel is built
  for (`HIDDEN`, the width of every config of the repo) raises ValueError,
  never the plain version.
- `blstm_infer_ref`: the plain version (of the kernel and of the whole
  function): `pack_blstm_infer`, the gate-major pack of `_pack_weights`; the
  input projection of both directions as one product, x @ (w_ih[0] +
  w_ih[1]) + b (their columns are disjoint), as the JAX package computes it
  outside its `pallas_call`; then `blstm_recur_ref`, the Pallas body's walk
  over the pack. The CPU tests' reference.

The kernel reads the six tensors as they are, with no pack: pack column
g*2H + d*H + j is column g*H + j of direction d's tensors. It walks each
direction in a block of its own (the backward one reversed) and projects
x inside the walk, 8 frames at a time; rows a block from `row_tile`.

Differences from the JAX route, by design:
- No VMEM gate. `ops/rnn.py:blstm` takes this route for every 3-D input when
  the caller asks for it; the JAX package falls back to its scans when
  R*T*(8H+2H)*4 bytes exceed 8 MB, a TPU VMEM limit. Here x streams from
  device memory, so no size falls back.
- bf16 raises NotImplementedError: the Pallas kernel keeps bf16 h and c
  scratch for a bf16 input, another rounding than float32, and bf16 serving
  is not ported (ROADMAP Queue 2).
- Gradients: a call with grad enabled on x or a weight raises RuntimeError
  (run it under `torch.no_grad()`).
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.ops.kernels import _build
from sound_bubble_tpu_torch.ops.kernels.lstm_slab import (
    BF16, F32, N_SM, _check, _check_fwd_dims, _dispatch, _n_sm, _stream,
    fwd_row_tiles)

HIDDEN = 64              # the hidden width the kernel is built for


def pack_blstm_infer(params):
    """{fwd, bwd: {w_ih [C, 4H], w_hh [H, 4H], b [4H]}} -> (w_ih [2, C, 8H],
    w_hh [2H, 8H], b [8H]) with gate-major columns ([i_f i_b | f_f f_b |
    g_f g_b | o_f o_b]), the JAX package's `_pack_weights`: w_ih[0] holds
    the forward direction's columns and w_ih[1] the backward's (zeros
    elsewhere); w_hh is block-diagonal."""
    fwd, bwd = params["fwd"], params["bwd"]
    c, h = fwd["w_ih"].shape[0], fwd["w_hh"].shape[0]
    w_ih = fwd["w_ih"].new_zeros(2, c, 4, 2, h)
    w_ih[0, :, :, 0] = fwd["w_ih"].reshape(c, 4, h)
    w_ih[1, :, :, 1] = bwd["w_ih"].reshape(c, 4, h)
    w_hh = fwd["w_hh"].new_zeros(2, h, 4, 2, h)
    w_hh[0, :, :, 0] = fwd["w_hh"].reshape(h, 4, h)
    w_hh[1, :, :, 1] = bwd["w_hh"].reshape(h, 4, h)
    b = torch.stack([fwd["b"].reshape(4, h), bwd["b"].reshape(4, h)], dim=1)
    return (w_ih.reshape(2, c, 8 * h), w_hh.reshape(2 * h, 8 * h),
            b.reshape(8 * h))


def _check_call(params, x):
    tensors = [x] + [params[d][k] for d in ("fwd", "bwd")
                     for k in ("w_ih", "w_hh", "b")]
    if any(t.dtype == BF16 for t in tensors):
        raise NotImplementedError(
            "bf16 on the fused inference BLSTM is not ported: the JAX kernel "
            "keeps bf16 h and c for a bf16 input (ROADMAP Queue 2, bf16 "
            "serving)")
    if any(t.dtype != F32 for t in tensors):
        raise TypeError("the fused inference BLSTM takes float32 x and "
                        "weights")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the fused inference BLSTM has no backward (the JAX kernel has "
            "no VJP): call it under torch.no_grad()")
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}: expected [R, T, C]")


def _project(w_ih, b, x):
    """gx [R, T, 8H]: both directions' x @ W_ih + b at each original time."""
    return (x @ w_ih.sum(0) + b).contiguous()


def blstm_recur_ref(gx, w_hh):
    """The Pallas body `_kernel`'s walk, the recurrence of the plain
    version: over gx [R, T, 8H] with the whole pack w_hh [2H, 8H]; step n
    takes the forward columns at time n and the backward columns at T-1-n.
    Returns y [R, T, 2H] in original time order."""
    r, t_len, h8 = gx.shape
    h2, hidden = h8 // 4, h8 // 8
    bwd_col = (torch.arange(h8, device=gx.device) // hidden) % 2 == 1
    gx_walk = torch.where(bwd_col, gx.flip(1), gx)
    h = c = gx.new_zeros(r, h2)
    y = gx.new_empty(r, t_len, h2)
    for n in range(t_len):
        gates = gx_walk[:, n] + h @ w_hh
        i = torch.sigmoid(gates[:, :h2])
        f = torch.sigmoid(gates[:, h2:2 * h2])
        g = torch.tanh(gates[:, 2 * h2:3 * h2])
        o = torch.sigmoid(gates[:, 3 * h2:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        y[:, n, :hidden] = h[:, :hidden]
        y[:, t_len - 1 - n, hidden:] = h[:, hidden:]
    return y


def row_tile(r: int, c_in: int, n_sm: int = N_SM) -> tuple[int, int]:
    """(rows a block, blocks) of the kernel for R = r rows at input width
    c_in: each direction a grid half of ceil(r / rows) blocks, the fewest
    rows that keep both halves within one wave of n_sm blocks."""
    return fwd_row_tiles(r, c_in, HIDDEN, n_sm, nd=2)


def _launch(params, x):
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}: expected [R, T, C]")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    r, t_len, c_in = x.shape
    hidden = params["fwd"]["w_hh"].shape[0]
    if hidden != HIDDEN:
        raise ValueError(f"H={hidden}: the kernel is built for H={HIDDEN}")
    shapes = {"w_ih": (c_in, 4 * hidden), "w_hh": (hidden, 4 * hidden),
              "b": (4 * hidden,)}
    weights = []
    for d in ("fwd", "bwd"):
        for k, shape in shapes.items():
            _check(f"{d}.{k}", params[d][k], shape, dev, F32)
            weights.append(params[d][k])
    _check_fwd_dims(x.transpose(0, 1), hidden)   # it reads [T, R, C]
    lib = _build.load_library()
    rows = row_tile(r, c_in, _n_sm(dev))[0]
    y = torch.empty((r, t_len, 2 * hidden), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sbt_blstm_infer(x.data_ptr(),
                                 *(w.data_ptr() for w in weights),
                                 y.data_ptr(), t_len, r, c_in, hidden, rows,
                                 _stream(dev))
    if rc != 0:
        raise RuntimeError(f"blstm_infer kernel launch failed: CUDA error "
                           f"{rc}")
    blstm_infer.launches += 1
    return y


def _plain(params, x):
    w_ih, w_hh, b = pack_blstm_infer(params)
    return blstm_recur_ref(_project(w_ih, b, x), w_hh)


def blstm_recur(params, x):
    """Row 5: the CUDA kernel for CUDA tensors (one launch: projection and
    walk), the plain version for CPU tensors. x [R, T, C] -> y [R, T, 2H]."""
    return _dispatch(x, _launch, _plain, (params, x))


def blstm_infer_ref(params, x):
    """Plain version of `blstm_infer` (of `blstm_pallas`): x [R, T, C] ->
    y [R, T, 2H]."""
    _check_call(params, x)
    return _plain(params, x)


def blstm_infer(params, x):
    """Fused bidirectional LSTM over axis -2 for inference: x [R, T, C] ->
    [R, T, 2H]; one launch of the row-5 kernel for CUDA tensors."""
    _check_call(params, x)
    return blstm_recur(params, x)


blstm_infer.launches = 0
