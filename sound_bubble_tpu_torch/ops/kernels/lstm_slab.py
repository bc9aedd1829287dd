"""Single-direction LSTM training scans over K-frame slabs, forward and
backward: port of `sound_bubble_tpu/ops/pallas/lstm_train_slab.py`
(`lstm_slab_fwd`, `lstm_slab_bwd`, the custom-VJP `lstm_slab`), fp32.

`lstm_slab_fwd` / `lstm_slab_bwd` launch the hand-written CUDA kernels of
`sound_bubble_tpu_torch/csrc/lstm_slab.cu` for tensors on the card and run
`lstm_slab_fwd_ref` / `lstm_slab_bwd_ref`, their plain PyTorch versions (the
same slab algorithm), for tensors on the CPU. A CUDA tensor goes to the kernel
or the call raises: bf16 raises NotImplementedError (the mixed mode of the
TPU kernel is not ported yet). `lstm_slab` is the `torch.autograd.Function`
over the two; `ops/rnn.py` routes every LSTM scan with T >= 2 through it.

Layouts (JAX package): x [T, R, C] scan-major, w_ih [C, 4H], w_hh [H, 4H],
one folded bias b [4H], gate order [i, f, g, o]; h0/c0 [R, H]. The forward
also returns c_ckpt [nb, R, H], the cell state entering each slab's first
processed frame (its last index in the reverse direction), nb = ceil(T/K)
with K = min(8, T).
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.ops.kernels import _build

K = 8                        # frames per slab (the TPU kernel's K)
SMEM_LIMIT_BYTES = 232448    # dynamic shared memory one H100 block can use
DW_CHUNKS = 128              # row chunks of the weight-gradient partials


def n_slabs(t_len: int) -> tuple[int, int]:
    """(frames per slab, number of slabs) for a scan of t_len frames."""
    kf = min(K, t_len)
    return kf, -(-t_len // kf)


def _act(gates, hidden):
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden:2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden:])
    return i, f, g, o


# ------------------------------------------------------ plain PyTorch ----

def lstm_slab_fwd_ref(w_ih, w_hh, b, x, h0, c0, reverse: bool):
    """Plain version of the forward kernel. Returns (ys [T, R, H], hT, cT
    [R, H], c_ckpt [nb, R, H])."""
    t_len, r, _ = x.shape
    hidden = w_hh.shape[0]
    kf, nb = n_slabs(t_len)
    ys = x.new_empty(t_len, r, hidden)
    c_ckpt = x.new_empty(nb, r, hidden)
    h, c = h0, c0
    for js in range(nb):
        blk = nb - 1 - js if reverse else js
        lo, hi = blk * kf, min(t_len, blk * kf + kf)
        c_ckpt[blk] = c
        gx = x[lo:hi] @ w_ih + b                     # one slab projection
        for t in (range(hi - 1, lo - 1, -1) if reverse else range(lo, hi)):
            i, f, g, o = _act(gx[t - lo] + h @ w_hh, hidden)
            c = f * c + i * g
            h = o * torch.tanh(c)
            ys[t] = h
    return ys, h, c, c_ckpt


def lstm_slab_bwd_ref(w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT,
                      reverse: bool):
    """Plain version of the backward kernel. hp [T, R, H] is the h entering
    each frame. Returns (dx [T, R, C], dw_ih, dw_hh, db, dh0, dc0)."""
    t_len, r, c_in = x.shape
    hidden = w_hh.shape[0]
    kf, nb = n_slabs(t_len)
    dx = torch.empty_like(x)
    dw_ih = torch.zeros_like(w_ih)
    dw_hh = torch.zeros_like(w_hh)
    db = torch.zeros_like(b)
    dh, dc = dhT, dcT
    for js in range(nb):
        blk = js if reverse else nb - 1 - js
        lo, hi = blk * kf, min(t_len, blk * kf + kf)
        order = list(range(hi - 1, lo - 1, -1) if reverse else range(lo, hi))
        # re-forward the slab's cell states from its checkpoint
        acts = _act(x[lo:hi] @ w_ih + hp[lo:hi] @ w_hh + b, hidden)
        c = c_ckpt[blk]
        c_prev = {}
        for t in order:
            i, f, g, _ = (a[t - lo] for a in acts)
            c_prev[t] = c
            c = f * c + i * g
        # reverse walk: gate gradients and the (dh, dc) chain
        dgs = x.new_empty(hi - lo, r, 4 * hidden)
        for t in reversed(order):
            i, f, g, o = (a[t - lo] for a in acts)
            cp = c_prev[t]
            tc = torch.tanh(f * cp + i * g)
            d = dy[t] + dh
            dc = dc + d * o * (1.0 - tc * tc)
            dgs[t - lo] = torch.cat([dc * g * i * (1.0 - i),
                                     dc * cp * f * (1.0 - f),
                                     dc * i * (1.0 - g * g),
                                     d * tc * o * (1.0 - o)], dim=-1)
            dh = dgs[t - lo] @ w_hh.T
            dc = dc * f
        dx[lo:hi] = dgs @ w_ih.T
        dg2 = dgs.reshape(-1, 4 * hidden)
        dw_ih += x[lo:hi].reshape(-1, c_in).T @ dg2
        dw_hh += hp[lo:hi].reshape(-1, hidden).T @ dg2
        db += dg2.sum(dim=0)
    return dx, dw_ih, dw_hh, db, dh, dc


# --------------------------------------------------------- CUDA kernels ----

def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{name}: bfloat16 (the mixed mode of the slab kernels) is not "
            "ported yet; the CUDA kernels take float32")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_dims(x, w_hh, smem_fn):
    t_len, r, c_in = x.shape
    hidden = w_hh.shape[0]
    if 4 * hidden > 256:
        raise ValueError(f"H={hidden}: the kernels run 4H threads a block, "
                         "at most 256")
    if c_in > 2 * hidden:
        raise ValueError(f"C={c_in} > 2H={2 * hidden}: the forward kernel's "
                         "x prefetch needs C <= 2H")
    smem = smem_fn(c_in, hidden)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"C={c_in}, H={hidden}: needs {smem} B of shared "
                         f"memory, more than {SMEM_LIMIT_BYTES}")
    if t_len < 1 or r < 1:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    return t_len, r, c_in, hidden


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_fwd(w_ih, w_hh, b, x, h0, c0, reverse):
    dev = x.device
    _check("x", x, x.shape, dev)
    lib = _build.load_library()
    t_len, r, c_in, hidden = _check_dims(x, w_hh, lib.sbt_lstm_slab_fwd_smem)
    for name, t, shape in (("w_ih", w_ih, (c_in, 4 * hidden)),
                           ("w_hh", w_hh, (hidden, 4 * hidden)),
                           ("b", b, (4 * hidden,)), ("h0", h0, (r, hidden)),
                           ("c0", c0, (r, hidden))):
        _check(name, t, shape, dev)
    kf, nb = n_slabs(t_len)
    ys = torch.empty((t_len, r, hidden), dtype=torch.float32, device=dev)
    hT = torch.empty((r, hidden), dtype=torch.float32, device=dev)
    cT = torch.empty_like(hT)
    c_ckpt = torch.empty((nb, r, hidden), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sbt_lstm_slab_fwd(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), hT.data_ptr(),
            cT.data_ptr(), c_ckpt.data_ptr(), t_len, r, c_in, hidden, kf,
            int(bool(reverse)), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"lstm_slab_fwd kernel launch failed: CUDA error "
                           f"{rc}")
    lstm_slab_fwd.launches += 1
    return ys, hT, cT, c_ckpt


def _launch_bwd(w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT, reverse):
    dev = x.device
    _check("x", x, x.shape, dev)
    lib = _build.load_library()
    t_len, r, c_in, hidden = _check_dims(x, w_hh, lib.sbt_lstm_slab_bwd_smem)
    kf, nb = n_slabs(t_len)
    for name, t, shape in (("w_ih", w_ih, (c_in, 4 * hidden)),
                           ("w_hh", w_hh, (hidden, 4 * hidden)),
                           ("b", b, (4 * hidden,)),
                           ("hp", hp, (t_len, r, hidden)),
                           ("c_ckpt", c_ckpt, (nb, r, hidden)),
                           ("dy", dy, (t_len, r, hidden)),
                           ("dhT", dhT, (r, hidden)),
                           ("dcT", dcT, (r, hidden))):
        _check(name, t, shape, dev)
    n_rows = t_len * r
    n_chunks = max(1, min(DW_CHUNKS, -(-n_rows // 256)))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(x)
    dw_ih, dw_hh, db = empty(c_in, 4 * hidden), empty(hidden, 4 * hidden), \
        empty(4 * hidden)
    dh0, dc0 = empty(r, hidden), empty(r, hidden)
    dg = empty(n_rows, 4 * hidden)                          # scratch
    part = empty(n_chunks, c_in + hidden + 1, 4 * hidden)   # scratch
    with torch.cuda.device(dev):
        rc = lib.sbt_lstm_slab_bwd(
            x.data_ptr(), hp.data_ptr(), c_ckpt.data_ptr(), dy.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(), dhT.data_ptr(),
            dcT.data_ptr(), dx.data_ptr(), dw_ih.data_ptr(),
            dw_hh.data_ptr(), db.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            dg.data_ptr(), part.data_ptr(), t_len, r, c_in, hidden, kf,
            int(bool(reverse)), n_chunks, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"lstm_slab_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    lstm_slab_bwd.launches += 1
    return dx, dw_ih, dw_hh, db, dh0, dc0


def _dispatch(x, kernel, plain, args):
    if x.device.type == "cuda":
        return kernel(*args)
    if x.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"unsupported device {x.device}")


def lstm_slab_fwd(w_ih, w_hh, b, x, h0, c0, reverse: bool):
    """Forward scan: the CUDA kernel for CUDA tensors
    (`lstm_slab_fwd.launches` counts its launches), the plain version for
    CPU tensors. Returns (ys, hT, cT, c_ckpt)."""
    return _dispatch(x, _launch_fwd, lstm_slab_fwd_ref,
                     (w_ih, w_hh, b, x, h0, c0, reverse))


def lstm_slab_bwd(w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT,
                  reverse: bool):
    """Backward scan: the CUDA kernels for CUDA tensors
    (`lstm_slab_bwd.launches` counts the calls), the plain version for CPU
    tensors. Returns (dx, dw_ih, dw_hh, db, dh0, dc0)."""
    return _dispatch(x, _launch_bwd, lstm_slab_bwd_ref,
                     (w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT, reverse))


lstm_slab_fwd.launches = 0
lstm_slab_bwd.launches = 0


# ------------------------------------------------------- autograd -------

def shift_prev(ys, h0, reverse: bool):
    """h entering each frame: the output of the previously processed frame,
    h0 entering the first one."""
    if reverse:
        return torch.cat([ys[1:], h0[None]], dim=0)
    return torch.cat([h0[None], ys[:-1]], dim=0)


class _LstmSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, reverse, w_ih, w_hh, b, x, h0, c0):
        ys, hT, cT, c_ckpt = lstm_slab_fwd(w_ih, w_hh, b, x, h0, c0, reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(w_ih, w_hh, b, x, h0, ys, c_ckpt)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dy, dhT, dcT):
        w_ih, w_hh, b, x, h0, ys, c_ckpt = ctx.saved_tensors
        hp = shift_prev(ys, h0, ctx.reverse)
        dx, dw_ih, dw_hh, db, dh0, dc0 = lstm_slab_bwd(
            w_ih, w_hh, b, x, hp, c_ckpt, dy.contiguous(), dhT.contiguous(),
            dcT.contiguous(), ctx.reverse)
        return None, dw_ih, dw_hh, db, dx, dh0, dc0


def lstm_slab(reverse: bool, w_ih, w_hh, b, x, h0, c0):
    """(ys [T, R, H], hT, cT [R, H]) for scan-major x [T, R, C]; the
    backward runs the slab backward scan."""
    return _LstmSlab.apply(bool(reverse), w_ih, w_hh, b, x.contiguous(),
                           h0.contiguous(), c0.contiguous())
