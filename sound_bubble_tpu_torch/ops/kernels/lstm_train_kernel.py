"""LSTM training recurrences, one timestep per step, forward and backward:
port of `sound_bubble_tpu/ops/pallas/lstm_train_kernel.py`, the JAX
package's custom-VJP kernel route (`lstm_pallas_train`,
`blstm_pallas_train`), in float32 and in the mixed mode.

Four entry points, each launching a hand-written CUDA kernel
(`sound_bubble_tpu_torch/csrc/lstm_seq.cu`, `lstm_seq_fwd_mixed.cu`,
`lstm_seq_bwd.cu`) for tensors on the card and running its plain PyTorch
version (`*_ref`, the same arithmetic and the same roundings as the Pallas
body) for tensors on the CPU. A CUDA tensor goes to the kernel or the call
raises.

- `lstm_seq_fwd` (Pallas `lstm_seq_fwd`): one direction over scan-major
  x [T, R, C] with x@W_ih + b fused into each step; returns y [T, R, H] in
  x's dtype, the post-activation gates [T, R, 4H] ([i | f | g | o]) in the
  gate dtype and the cell states c [T, R, H] in float32.
- `lstm_seq_bwd` (Pallas `lstm_seq_bwd`): the backward walk from the saved
  gates and c; returns the gate gradients dgates [T, R, 4H] in `out_dtype`
  and dh0, dc0 [R, H] in float32.
- `blstm_seq_fwd` (Pallas `_blstm_fwd`): both directions in one launch on the
  pack of `_blstm_pack` (W_hh block-diagonal [2H, 8H], direction-major; the
  kernel multiplies only its two diagonal blocks); the backward direction
  reads x at the mirrored time. Returns y [T, R, 2H] = [y_fwd | y_bwd], both
  in original time order, the gates [T, R, 8H] gate-major with the
  direction inside ([i_f | i_b | f_f | f_b | ...]) and c [T, R, 2H], both at
  the walk's step (the backward direction's step t is original time T-1-t).
- `blstm_seq_bwd` (the walk of Pallas `_bpt_bwd`): dgates [T, R, 8H]
  direction-major ([di_f, df_f, dg_f, do_f | di_b, ...]) at the walk's step;
  dy_b is read at the mirrored time.

Both forwards launch the walk of `csrc/lstm_fwd32.cuh`, which they share
with the slab scan's forward: rows a block from `lstm_slab.fwd_row_tiles`
(one wave of the card's SMs; `blstm_seq_fwd` walks each direction in a grid
half of its own), each slab's input projection as one product into shared
memory before its walk, W_hh in registers, four rows at a time on the serial
chain; they take H in 8, 16, 32, 64 and C a multiple of 4 (mixed: of 8, and
C <= 64 with bf16 weights). Their mixed mode keeps gx in bf16 at 4 frames a
slab, so that 9 rows a block fit one wave at the inter LSTM's R = 1160 and
38 at the intra BLSTM's R = 2504. Both backwards launch the backward walk
of `csrc/lstm_seq_bwd.cu`: W_hh^T in registers, rows a block from
`seq_bwd_row_tiles` (one wave; `blstm_seq_bwd` walks each direction in a
grid half of its own), the next frame's gates, c and dy copied into shared
memory while a frame is walked; H in 8, 16, 32, 64 (any other H raises
ValueError before anything is built or launched: ROADMAP Queue 2 item 11).
`lstm_seq_bwd` enters from (dhT, dcT), takes c0 as the entering cell state
of its last step and writes (dh0, dc0).

`lstm_seq` and `blstm_seq` are the `torch.autograd.Function`s, the
counterparts of `lstm_pallas_train` and `blstm_pallas_train`: their
backward runs the kernel walk, then dW_ih, dW_hh, db and dx as the plain
products that `_lpt_bwd` / `_bpt_bwd` compute outside Pallas.

Dtypes: the (x, weights) pairs of `lstm_slab.DTYPES`. bf16 anywhere is the
mixed mode, which rounds where the Pallas kernels round, and not where the
slab kernels do: gx = bf16(x@W_ih) + b (bf16 when b is, float32 when b is
float32); gates = bf16(gx + bf16(h)@W_hh); each sigmoid is the Pallas body's
`jax.nn.sigmoid` as XLA and Mosaic expand it on a bf16 vector,
1 / (1 + exp(-v)) with each of the three ops rounded to bf16 (`sigmoid_x`;
the slab kernels round a float32 sigmoid once); each tanh is taken in
float32 on the bf16 value and rounded; c_t = f*c + bf16(i*g) in float32;
h_t = bf16(o * bf16(tanh(bf16(c_t)))). The backward keeps its carries in
float32, rounds the gate gradients to bf16 for the dh chain and stores them
in x's dtype, so db is the float32 sum of bf16 values. hT is the last y
(bf16 in the mixed mode) in h0's dtype.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.ops.kernels import _build
from sound_bubble_tpu_torch.ops.kernels.lstm_slab import (
    BF16, DTYPES, F32, FWD32_HIDDEN, N_SM, SMEM_LIMIT_BYTES, _check,
    _check_fwd_dims, _dispatch, _mm, _n_sm, _stream, fwd_row_tiles,
    is_mixed, tanh_q)

SEQ_BWD_ROWS_MAX = 48        # rows of a backward block (csrc: ROWS_MAX)


def sigmoid_x(v):
    """`jax.nn.sigmoid` on v as XLA (and Mosaic's lowering) computes it:
    1 / (1 + exp(-v)), each op in v's dtype; in bf16, three roundings."""
    if v.dtype != BF16:
        return torch.sigmoid(v)
    e = torch.exp(-v.float()).to(BF16)
    return (1.0 / (e.float() + 1.0).to(BF16).float()).to(BF16)


def _gate_dtype(x, w_hh):
    return BF16 if is_mixed(x, w_hh) else x.dtype


def _proj(x, w_ih, b, mixed):
    """gx = x@W_ih + b for every step at once, rounded as the Pallas
    forward rounds it."""
    gx = _mm(x, w_ih)
    return gx.to(BF16) + b if mixed else gx + b


def _recur(gx_t, h, w_hh, mixed):
    """Pre-activation gates of one step from gx_t and the float32 h."""
    if mixed:
        return (gx_t.float() + _mm(h.to(BF16), w_hh)).to(BF16)
    return gx_t + h @ w_hh


def _cell(c, i, f, g, o, gdt):
    c = f.float() * c + (i * g).float()
    return c, o * tanh_q(c.to(gdt))


def _dgates(gts, ct, cp, dy_t, dh, dc, gdt):
    """One backward step: (di, df, dg, do) and the carried dc, from the
    step's saved gates (float32 [R, 4W] gate-major, W = nd*H), cell state,
    entering cell state and dy."""
    w = gts.shape[-1] // 4
    i, f, g, o = (gts[:, k * w:(k + 1) * w] for k in range(4))
    tc = tanh_q(ct.to(gdt)).float()
    d = dy_t.float() + dh
    do = d * tc
    dc = dc + d * o * (1.0 - tc * tc)
    grads = (dc * g * i * (1.0 - i), dc * cp * f * (1.0 - f),
             dc * i * (1.0 - g * g), do * o * (1.0 - o))
    return grads, dc * f


# ------------------------------------------------------ plain PyTorch ----

def lstm_seq_fwd_ref(w_ih, w_hh, b, x, h0, c0):
    """Plain version of the forward kernel (Pallas `_fwd_kernel`). Returns
    (y [T, R, H] in x's dtype, gates [T, R, 4H] in the gate dtype, c
    [T, R, H] float32)."""
    t_len, r, _ = x.shape
    hidden = w_hh.shape[0]
    mixed, gdt = is_mixed(x, w_hh), _gate_dtype(x, w_hh)
    gx = _proj(x, w_ih, b, mixed)
    y = x.new_empty(t_len, r, hidden)
    gates = x.new_empty(t_len, r, 4 * hidden, dtype=gdt)
    c_seq = x.new_empty(t_len, r, hidden, dtype=F32)
    h, c = h0.float(), c0.float()
    for t in range(t_len):
        pre = _recur(gx[t], h, w_hh, mixed)
        i, f, g, o = (sigmoid_x(pre[:, :hidden]),
                      sigmoid_x(pre[:, hidden:2 * hidden]),
                      tanh_q(pre[:, 2 * hidden:3 * hidden]),
                      sigmoid_x(pre[:, 3 * hidden:]))
        c, h_t = _cell(c, i, f, g, o, gdt)
        y[t], c_seq[t] = h_t, c
        gates[t] = torch.cat([i, f, g, o], dim=-1)
        h = h_t.float()
    return y, gates, c_seq


def lstm_seq_bwd_ref(gates, c_seq, c0, dy, dhT, dcT, w_hh, out_dtype):
    """Plain version of the backward kernel (Pallas `_bwd_kernel`). Returns
    (dgates [T, R, 4H] in out_dtype, dh0, dc0 [R, H] float32)."""
    t_len = c_seq.shape[0]
    mixed = BF16 in (w_hh.dtype, out_dtype)
    gdt = BF16 if mixed else F32
    dg = torch.empty(gates.shape, dtype=out_dtype, device=gates.device)
    dh, dc = dhT.float(), dcT.float()
    for t in range(t_len - 1, -1, -1):
        cp = c_seq[t - 1] if t else c0.float()
        grads, dc = _dgates(gates[t].float(), c_seq[t], cp, dy[t], dh, dc,
                            gdt)
        dgates = torch.cat(grads, dim=-1)
        dh = _mm(dgates.to(gdt), w_hh.T)
        dg[t] = dgates
    return dg, dh, dc


def _blstm_pack(fwd, bwd):
    """(w_ih_f [C, 4H], w_ih_b [C, 4H], w_hh [2H, 8H] block-diagonal
    direction-major, b [8H]): the operands of the fused-direction kernels
    (the JAX package's `_blstm_pack`, b flat)."""
    h = fwd["w_hh"].shape[0]
    w_hh = fwd["w_hh"].new_zeros(2 * h, 8 * h)
    w_hh[:h, :4 * h] = fwd["w_hh"]
    w_hh[h:, 4 * h:] = bwd["w_hh"]
    return fwd["w_ih"], bwd["w_ih"], w_hh, torch.cat([fwd["b"], bwd["b"]])


def blstm_seq_fwd_ref(w_ih_f, w_ih_b, w_hh, b, x):
    """Plain version of the fused-direction forward kernel (Pallas
    `_blstm_fwd_kernel`, the recurrence on the whole packed W_hh). Returns
    (y [T, R, 2H] in x's dtype, gates [T, R, 8H] in the gate dtype, c
    [T, R, 2H] float32)."""
    t_len, r, _ = x.shape
    h2 = w_hh.shape[0]
    hidden = h2 // 2
    mixed, gdt = is_mixed(x, w_hh), _gate_dtype(x, w_hh)
    gx = _mm(x, w_ih_f), _mm(x.flip(0), w_ih_b)
    if mixed:
        gx = [g.to(BF16) for g in gx]
    gx = torch.cat(gx, dim=-1) + b
    y = x.new_empty(t_len, r, h2)
    gates = x.new_empty(t_len, r, 4 * h2, dtype=gdt)
    c_seq = x.new_empty(t_len, r, h2, dtype=F32)
    h = c = x.new_zeros(r, h2, dtype=F32)

    def both(pre, k):        # gate k of the two directions, [R, 2H]
        return torch.cat([pre[:, k * hidden:(k + 1) * hidden],
                          pre[:, (4 + k) * hidden:(5 + k) * hidden]], dim=-1)

    for t in range(t_len):
        pre = _recur(gx[t], h, w_hh, mixed)
        i, f, g, o = (sigmoid_x(both(pre, 0)), sigmoid_x(both(pre, 1)),
                      tanh_q(both(pre, 2)), sigmoid_x(both(pre, 3)))
        c, h_t = _cell(c, i, f, g, o, gdt)
        y[t, :, :hidden] = h_t[:, :hidden]
        y[t_len - 1 - t, :, hidden:] = h_t[:, hidden:]
        gates[t] = torch.cat([i, f, g, o], dim=-1)
        c_seq[t] = c
        h = h_t.float()
    return y, gates, c_seq


def blstm_seq_bwd_ref(w_hh, gates, c_seq, dy, out_dtype):
    """Plain version of the fused-direction backward kernel (Pallas
    `_blstm_bwd_kernel`). dy [T, R, 2H] in original time order. Returns
    dgates [T, R, 8H] in out_dtype, direction-major, at the walk's step."""
    t_len, r, h2 = c_seq.shape
    hidden = h2 // 2
    mixed = BF16 in (w_hh.dtype, out_dtype)
    gdt = BF16 if mixed else F32
    dg = torch.empty(gates.shape, dtype=out_dtype, device=gates.device)
    dh = dc = c_seq.new_zeros(r, h2)
    for t in range(t_len - 1, -1, -1):
        cp = c_seq[t - 1] if t else torch.zeros_like(dc)
        # the forward direction's dy at time t, the backward's at T-1-t
        dy_t = torch.cat([dy[t, :, :hidden], dy[t_len - 1 - t, :, hidden:]],
                         dim=-1)
        grads, dc = _dgates(gates[t].float(), c_seq[t], cp, dy_t, dh, dc,
                            gdt)
        dgates = torch.cat([gd[:, s] for s in (slice(0, hidden),
                                                slice(hidden, h2))
                            for gd in grads], dim=-1)
        dh = _mm(dgates.to(gdt), w_hh.T)
        dg[t] = dgates
    return dg


# --------------------------------------------------------- CUDA kernels ----

def _dtype_code(xdt, w_hh) -> int:
    """Index into DTYPES of (x dtype, w_hh.dtype); any other pair raises."""
    pair = (xdt, w_hh.dtype)
    if pair not in DTYPES:
        raise TypeError(
            f"x {xdt} with weights {w_hh.dtype}: the seq kernels take "
            "(x, weights) in " + ", ".join(f"({a}, {b})" for a, b in DTYPES))
    return DTYPES.index(pair)


def seq_bwd_smem(hidden: int, rows: int, code: int = 0) -> int:
    """Shared memory of one block of `rows` rows of the backward walk (rows
    7 and 9 alike; bytes), as csrc/lstm_seq_bwd.cu's `bwd_layout` lays it
    out for the (x, weights) pair `code` of DTYPES: the gate tiles
    [2][rows][4H + 8] (mixed: bf16, 4H + 16), the c tiles [3][rows][H + 8]
    float32, the dy tiles [2][rows][H + 8] (x's dtype), the dg tiles
    [2][rp][4H + 8] float32 and the dc slots [rp][H + 8] float32 (rp: rows
    rounded up to 4); with bf16 weights (code 1, the tensor cores' chain)
    the dg tiles bf16 and rp rows rounded up to 16."""
    tc = code == 1
    rp = -(-rows // (16 if tc else 4)) * (16 if tc else 4)
    eb = 2 if code else 4
    return (2 * rows * (4 * hidden + (16 if code else 8)) * eb
            + 12 * rows * (hidden + 8) + 2 * rows * (hidden + 8) * eb
            + 2 * rp * (4 * hidden + 8) * (2 if tc else 4)
            + 4 * rp * (hidden + 8))


def seq_bwd_row_tiles(r: int, hidden: int, code: int = 0,
                      n_sm: int = N_SM, nd: int = 2) -> tuple[int, int]:
    """(rows a block, blocks) of the backward walk for R = r rows and nd
    directions (row 7: 1, row 9: 2), each direction a grid part of
    ceil(r / rows) blocks: the fewest rows that keep the grid within one
    wave of n_sm blocks (one block an SM), up to SEQ_BWD_ROWS_MAX, fewer
    where the block's shared memory would not fit (then the grid takes more
    waves)."""
    rows = min(SEQ_BWD_ROWS_MAX, -(-nd * r // n_sm))
    while rows < SEQ_BWD_ROWS_MAX and nd * -(-r // rows) > n_sm:
        rows += 1
    while rows > 1 and seq_bwd_smem(hidden, rows, code) > SMEM_LIMIT_BYTES:
        rows -= 1
    return rows, nd * -(-r // rows)


def _count(fn, code):
    if code:
        fn.mixed_launches += 1
    else:
        fn.launches += 1


def _launch_fwd(fn, x, w_ihs, w_hh, b, h0, c0):
    """The forward kernel for nd = len(w_ihs) directions."""
    nd, dev = len(w_ihs), x.device
    _check("x", x, x.shape, dev, x.dtype)
    _check("w_hh", w_hh, w_hh.shape, dev, w_hh.dtype)
    if x.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}, w_hh {tuple(w_hh.shape)}: "
                         "expected [T, R, C] and [nd*H, nd*4H]")
    code = _dtype_code(x.dtype, w_hh)
    wdt = w_hh.dtype
    t_len, r, c_in = x.shape
    hidden = w_ihs[0].shape[-1] // 4
    # the mixed walk keeps gx in bf16 (rows 6b and 8b)
    _check_fwd_dims(x, hidden, code, bseq=bool(code))
    operands = [(f"w_ih[{k}]", w, (c_in, 4 * hidden), wdt)
                for k, w in enumerate(w_ihs)]
    operands += [("w_hh", w_hh, (nd * hidden, nd * 4 * hidden), wdt),
                 ("b", b, (nd * 4 * hidden,), wdt)]
    if nd == 1:
        operands += [("h0", h0, (r, hidden), F32), ("c0", c0, (r, hidden),
                                                    F32)]
    for name, t, shape, dt in operands:
        _check(name, t, shape, dev, dt)
    rows = fwd_row_tiles(r, c_in, hidden, _n_sm(dev), nd, code,
                         bseq=bool(code))[0]
    lib = _build.load_library()
    y = torch.empty((t_len, r, nd * hidden), dtype=x.dtype, device=dev)
    gates = torch.empty((t_len, r, nd * 4 * hidden),
                        dtype=BF16 if code else F32, device=dev)
    c_seq = torch.empty((t_len, r, nd * hidden), dtype=F32, device=dev)
    w_ih_b = w_ihs[-1]
    with torch.cuda.device(dev):
        rc = lib.sbt_lstm_seq_fwd(
            x.data_ptr(), w_ihs[0].data_ptr(), w_ih_b.data_ptr(),
            w_hh.data_ptr(), b.data_ptr(),
            h0.data_ptr() if nd == 1 else None,
            c0.data_ptr() if nd == 1 else None, y.data_ptr(),
            gates.data_ptr(), c_seq.data_ptr(), t_len, r, c_in, hidden, nd,
            code, rows, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{rc}")
    _count(fn, code)
    return y, gates, c_seq


def _launch_bwd(fn, nd, gates, c_seq, c0, dy, dhT, dcT, w_hh, out_dtype):
    """The backward kernel for nd directions."""
    dev = c_seq.device
    code = _dtype_code(out_dtype, w_hh)
    gdt = BF16 if code else F32
    _check("c_seq", c_seq, c_seq.shape, dev, F32)
    if c_seq.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"c_seq {tuple(c_seq.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}: expected [T, R, nd*H] and "
                         "[nd*H, nd*4H]")
    t_len, r, width = c_seq.shape
    hidden = width // nd
    if hidden not in FWD32_HIDDEN:
        raise ValueError(f"H={hidden}: the backward walk takes H in "
                         f"{', '.join(map(str, FWD32_HIDDEN))} (ROADMAP "
                         "Queue 2 item 11)")
    operands = [("gates", gates, (t_len, r, nd * 4 * hidden), gdt),
                ("dy", dy, (t_len, r, nd * hidden), out_dtype),
                ("w_hh", w_hh, (nd * hidden, nd * 4 * hidden), w_hh.dtype)]
    if nd == 1:
        operands += [(name, t, (r, hidden), F32) for name, t in
                     (("c0", c0), ("dhT", dhT), ("dcT", dcT))]
    for name, t, shape, dt in operands:
        _check(name, t, shape, dev, dt)
    if t_len < 1 or r < 1:
        raise ValueError(f"empty scan: c_seq {tuple(c_seq.shape)}")
    # the walk copies its tiles (and row 7's c0) in 16-byte pieces
    for name, t in (("gates", gates), ("c_seq", c_seq), ("dy", dy),
                    ("c0", c0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: not aligned to 16 bytes")
    rows = seq_bwd_row_tiles(r, hidden, code, _n_sm(dev), nd)[0]
    lib = _build.load_library()
    dg = torch.empty((t_len, r, nd * 4 * hidden), dtype=out_dtype,
                     device=dev)
    dh0 = dc0 = None
    if nd == 1:
        dh0 = torch.empty((r, hidden), dtype=F32, device=dev)
        dc0 = torch.empty_like(dh0)
    with torch.cuda.device(dev):
        if nd == 2:
            rc = lib.sbt_blstm_seq_bwd(
                gates.data_ptr(), c_seq.data_ptr(), dy.data_ptr(),
                w_hh.data_ptr(), dg.data_ptr(), t_len, r, hidden, code, rows,
                _stream(dev))
        else:
            rc = lib.sbt_lstm_seq_bwd(
                gates.data_ptr(), c_seq.data_ptr(), c0.data_ptr(),
                dy.data_ptr(), w_hh.data_ptr(), dhT.data_ptr(),
                dcT.data_ptr(), dg.data_ptr(), dh0.data_ptr(),
                dc0.data_ptr(), t_len, r, hidden, code, rows, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{rc}")
    _count(fn, code)
    return dg, dh0, dc0


def _lstm_fwd_kernel(w_ih, w_hh, b, x, h0, c0):
    return _launch_fwd(lstm_seq_fwd, x, (w_ih,), w_hh, b, h0, c0)


def _lstm_bwd_kernel(*args):
    return _launch_bwd(lstm_seq_bwd, 1, *args)


def _blstm_fwd_kernel(w_ih_f, w_ih_b, w_hh, b, x):
    return _launch_fwd(blstm_seq_fwd, x, (w_ih_f, w_ih_b), w_hh, b, None,
                       None)


def _blstm_bwd_kernel(w_hh, gates, c_seq, dy, out_dtype):
    return _launch_bwd(blstm_seq_bwd, 2, gates, c_seq, None, dy, None, None,
                       w_hh, out_dtype)[0]


def lstm_seq_fwd(w_ih, w_hh, b, x, h0, c0):
    """Row 6: the CUDA kernel for CUDA tensors (`lstm_seq_fwd.launches`
    counts the float32 instantiation's launches, `.mixed_launches` the
    mixed ones'), the plain version for CPU tensors. h0, c0: the float32
    carry. Returns (y, gates, c_seq)."""
    return _dispatch(x, _lstm_fwd_kernel, lstm_seq_fwd_ref,
                     (w_ih, w_hh, b, x, h0, c0))


def lstm_seq_bwd(gates, c_seq, c0, dy, dhT, dcT, w_hh, out_dtype):
    """Row 7: the backward walk in one direction, kernel or plain version
    as `lstm_seq_fwd`. c0, dhT, dcT: [R, H] float32. Returns (dgates, dh0,
    dc0)."""
    return _dispatch(c_seq, _lstm_bwd_kernel, lstm_seq_bwd_ref,
                     (gates, c_seq, c0, dy, dhT, dcT, w_hh, out_dtype))


def blstm_seq_fwd(w_ih_f, w_ih_b, w_hh, b, x):
    """Row 8: the fused-direction forward on the pack of `_blstm_pack`,
    kernel or plain version as `lstm_seq_fwd`. Returns (y, gates, c_seq)."""
    return _dispatch(x, _blstm_fwd_kernel, blstm_seq_fwd_ref,
                     (w_ih_f, w_ih_b, w_hh, b, x))


def blstm_seq_bwd(w_hh, gates, c_seq, dy, out_dtype):
    """Row 9: the fused-direction backward walk, kernel or plain version as
    `lstm_seq_fwd`. Returns dgates."""
    return _dispatch(c_seq, _blstm_bwd_kernel, blstm_seq_bwd_ref,
                     (w_hh, gates, c_seq, dy, out_dtype))


for _fn in (lstm_seq_fwd, lstm_seq_bwd, blstm_seq_fwd, blstm_seq_bwd):
    _fn.launches = _fn.mixed_launches = 0


# ------------------------------------------------------- autograd -------

def _aligned(t):
    """t, or a copy of it where its data is off 16-byte alignment."""
    return t.clone() if t.data_ptr() % 16 else t


class _LstmSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_ih, w_hh, b, x, h0, c0):
        y, gates, c_seq = lstm_seq_fwd(w_ih, w_hh, b, x, h0, c0)
        ctx.save_for_backward(w_ih, w_hh, x, h0, c0, y, gates, c_seq)
        return (y, y[-1].to(h0.dtype, copy=True),
                c_seq[-1].to(c0.dtype, copy=True))

    @staticmethod
    def backward(ctx, dy, dhT, dcT):
        w_ih, w_hh, x, h0, c0, y, gates, c_seq = ctx.saved_tensors
        hidden = w_hh.shape[0]
        # the walk copies c0 and dy in 16-byte pieces
        c0f, dy = (_aligned(t) for t in (c0.float().contiguous(),
                                         dy.to(x.dtype).contiguous()))
        dgates, dh0, dc0 = lstm_seq_bwd(
            gates, c_seq, c0f, dy, dhT.float().contiguous(),
            dcT.float().contiguous(), w_hh, x.dtype)
        # the weight and input gradients: large products outside the walk
        h_prev = torch.cat([h0[None].to(y.dtype), y[:-1]], dim=0)
        dgf = dgates.reshape(-1, 4 * hidden)
        dw_hh = _mm(h_prev.reshape(-1, hidden).T, dgf).to(w_hh.dtype)
        dw_ih = _mm(x.reshape(-1, x.shape[-1]).T, dgf).to(w_ih.dtype)
        db = dgf.float().sum(dim=0).to(w_ih.dtype)
        dx = _mm(dgates, w_ih.T).to(x.dtype)
        return dw_ih, dw_hh, db, dx, dh0.to(h0.dtype), dc0.to(c0.dtype)


def lstm_seq(w_ih, w_hh, b, x, h0, c0):
    """(y [T, R, H] in x's dtype, hT, cT [R, H] in h0's / c0's) for
    scan-major x [T, R, C] (`lstm_pallas_train`); the backward runs the
    row-7 walk."""
    return _LstmSeq.apply(w_ih, w_hh, b, x.contiguous(), h0.contiguous(),
                          c0.contiguous())


class _BlstmSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_ih_f, w_hh_f, b_f, w_ih_b, w_hh_b, b_b, x):
        w_ih_f, w_ih_b, w_hh, b = _blstm_pack(
            {"w_ih": w_ih_f, "w_hh": w_hh_f, "b": b_f},
            {"w_ih": w_ih_b, "w_hh": w_hh_b, "b": b_b})
        y, gates, c_seq = blstm_seq_fwd(w_ih_f, w_ih_b, w_hh, b, x)
        ctx.save_for_backward(w_ih_f, w_ih_b, w_hh, x, y, gates, c_seq)
        ctx.dtypes = (w_hh_f.dtype, b_f.dtype, w_hh_b.dtype, b_b.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        w_ih_f, w_ih_b, w_hh, x, y, gates, c_seq = ctx.saved_tensors
        whh_f_dt, b_f_dt, whh_b_dt, b_b_dt = ctx.dtypes
        hidden = w_hh.shape[0] // 2
        # the walk copies dy in 16-byte pieces
        dy = _aligned(dy.to(x.dtype).contiguous())
        dgates = blstm_seq_bwd(w_hh, gates, c_seq, dy, x.dtype)
        dgf = dgates[..., :4 * hidden]     # walk step == original time
        dgb = dgates[..., 4 * hidden:]     # walk step == mirrored time
        # h entering each walk step, per direction; the backward direction's
        # step s holds y_b at original time T-1-s
        y_f, y_b = y[..., :hidden], y[..., hidden:]
        hf_prev = torch.cat([torch.zeros_like(y_f[:1]), y_f[:-1]], dim=0)
        hb_prev = torch.cat([y_b[1:], torch.zeros_like(y_b[:1])],
                            dim=0).flip(0)
        x_rev = x.flip(0)                  # x at each backward step

        def flat(a, w):
            return a.reshape(-1, w)

        dwhh_f = _mm(flat(hf_prev, hidden).T, flat(dgf, 4 * hidden))
        dwhh_b = _mm(flat(hb_prev, hidden).T, flat(dgb, 4 * hidden))
        c_in = x.shape[-1]
        dwih_f = _mm(flat(x, c_in).T, flat(dgf, 4 * hidden))
        dwih_b = _mm(flat(x_rev, c_in).T, flat(dgb, 4 * hidden))
        db_f = dgf.float().sum(dim=(0, 1))
        db_b = dgb.float().sum(dim=(0, 1))
        dx = (_mm(dgf, w_ih_f.T) + _mm(dgb, w_ih_b.T).flip(0)).to(x.dtype)
        return (dwih_f.to(w_ih_f.dtype), dwhh_f.to(whh_f_dt),
                db_f.to(b_f_dt), dwih_b.to(w_ih_b.dtype),
                dwhh_b.to(whh_b_dt), db_b.to(b_b_dt), dx)


def blstm_seq(fwd, bwd, x):
    """Fused bidirectional LSTM over scan-major x [T, R, C] -> [T, R, 2H]
    ([y_fwd | y_bwd], both in original time order; zero initial states)
    (`blstm_pallas_train`); the backward runs the row-9 walk."""
    return _BlstmSeq.apply(fwd["w_ih"], fwd["w_hh"], fwd["b"], bwd["w_ih"],
                           bwd["w_hh"], bwd["b"], x.contiguous())
