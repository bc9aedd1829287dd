"""Single-direction LSTM training scans over K-frame slabs, forward and
backward: port of `sound_bubble_tpu/ops/pallas/lstm_train_slab.py`
(`lstm_slab_fwd`, `lstm_slab_bwd`, the custom-VJP `lstm_slab`), in float32
and in the mixed mode.

`lstm_slab_fwd` / `lstm_slab_bwd` launch the hand-written CUDA kernels of
`sound_bubble_tpu_torch/csrc/lstm_slab.cu` for tensors on the card and run
`lstm_slab_fwd_ref` / `lstm_slab_bwd_ref`, their plain PyTorch versions (the
same slab algorithm), for tensors on the CPU. A CUDA tensor goes to the kernel
or the call raises. `lstm_slab` is the `torch.autograd.Function` over the
two; `ops/rnn.py` routes every LSTM scan with T >= 2 through it.

The forward is the walk of `csrc/lstm_fwd32.cuh`, which the seq route's
forwards share: one block of 4H threads a tile of `fwd_row_tiles` rows (the
fewest that keep the grid within one wave of the card's SMs), each K-frame
slab's input projection as one product into shared memory before its walk,
W_hh in registers, four rows at a time on the serial chain. It takes H in
8, 16, 32, 64 and C a multiple of 4; the mixed mode (bf16 x, its own
roundings) C a multiple of 8, and with bf16 weights, whose slab projection
runs on the tensor cores, C <= 64 (`_check_fwd_dims`).

Layouts (JAX package): x [T, R, C] scan-major, w_ih [C, 4H], w_hh [H, 4H],
one folded bias b [4H], gate order [i, f, g, o]; h0/c0 [R, H]. The forward
also returns c_ckpt [nb, R, H], the cell state entering each slab's first
processed frame (its last index in the reverse direction), nb = ceil(T/K)
with K = min(8, T).

Dtypes. The operands the two recipes hand the scans (`DTYPES`): all float32;
bf16 activations and weights (`cast_bf16` on the params, as the campaign
trainer `train_stream --bf16` runs); bf16 activations with float32 weights
(`train_pt --bf16`: the trunk is bf16, the params stay float32). bf16
anywhere is the mixed mode, which rounds where the Pallas kernel rounds:
gx = x@W_ih + b stays float32; gates = bf16(gx + bf16(h)@W_hh); every
sigmoid / tanh is taken in float32 on the bf16 value and rounded to bf16;
c_t = f*c + bf16(i*g) in float32; h_t = bf16(o * bf16(tanh(bf16(c_t)))).
The backward recomputes the gates the same way, keeps the gate gradients
in float32 for db, and rounds them to bf16 for dh = dg@W_hh^T, dx = dg@W_ih^T
and the weight gradients (float32 accumulation throughout). ys and dx come
back in x's dtype; hT, cT, c_ckpt, dW, db, dh0, dc0 in float32.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.ops.kernels import _build

K = 8                        # frames per slab (the TPU kernel's K)
SMEM_LIMIT_BYTES = 232448    # dynamic shared memory one H100 block can use
N_SM = 132                   # streaming multiprocessors of an H100 SXM
BWD_ROWS_MAX = 24            # rows of a backward block (csrc: BWD_ROWS_MAX)
BWD_THREADS = 512            # threads of a backward block (csrc: BT)
BWD_MA = 12                  # dW inputs of a backward thread (csrc: MA)
FWD_ROWS_MAX = 24            # rows of an fp32 forward block (csrc: ROWS_MAX)
FWD_ROWS_MAX_MIXED = 48      # rows of a mixed one (csrc: ROWS_MAX_MIXED)
MIXED_TC_C_MAX = 64          # C of the tensor cores' projection (16 KS_MAX)
FWD32_HIDDEN = (8, 16, 32, 64)   # H the fp32 forwards take
F32, BF16 = torch.float32, torch.bfloat16
# (x dtype, weight dtype) pairs the kernels take; the code the C entry points
# dispatch on is the pair's index
DTYPES = ((F32, F32), (BF16, BF16), (BF16, F32))


def n_slabs(t_len: int) -> tuple[int, int]:
    """(frames per slab, number of slabs) for a scan of t_len frames."""
    kf = min(K, t_len)
    return kf, -(-t_len // kf)


def is_mixed(x, w_hh) -> bool:
    return BF16 in (x.dtype, w_hh.dtype)


def sigmoid_q(v):
    """sigmoid in float32 on v, rounded to v's dtype (the Pallas `_sig`)."""
    return torch.sigmoid(v.float()).to(v.dtype)


def tanh_q(v):
    """tanh in float32 on v, rounded to v's dtype (the Pallas `_tanh`)."""
    return torch.tanh(v.float()).to(v.dtype)


def act(gates, hidden):
    """(i, f, g, o) of the gate pre-activations, in the gates' dtype."""
    return (sigmoid_q(gates[..., :hidden]),
            sigmoid_q(gates[..., hidden:2 * hidden]),
            tanh_q(gates[..., 2 * hidden:3 * hidden]),
            sigmoid_q(gates[..., 3 * hidden:]))


def _mm(a, b):
    """a @ b with float32 accumulation (exact products of bf16 operands)."""
    return a.float() @ b.float()


# ------------------------------------------------------ plain PyTorch ----

def lstm_slab_fwd_ref(w_ih, w_hh, b, x, h0, c0, reverse: bool):
    """Plain version of the forward kernel. Returns (ys [T, R, H] in x's
    dtype, hT, cT [R, H], c_ckpt [nb, R, H] float32)."""
    t_len, r, _ = x.shape
    hidden = w_hh.shape[0]
    kf, nb = n_slabs(t_len)
    gdt = BF16 if is_mixed(x, w_hh) else F32
    ys = x.new_empty(t_len, r, hidden)
    c_ckpt = torch.empty(nb, r, hidden, dtype=F32, device=x.device)
    h, c = h0.float(), c0.float()
    for js in range(nb):
        blk = nb - 1 - js if reverse else js
        lo, hi = blk * kf, min(t_len, blk * kf + kf)
        c_ckpt[blk] = c
        gx = _mm(x[lo:hi], w_ih) + b.float()         # one slab projection
        for t in (range(hi - 1, lo - 1, -1) if reverse else range(lo, hi)):
            gates = (gx[t - lo] + _mm(h.to(gdt), w_hh)).to(gdt)
            i, f, g, o = act(gates, hidden)
            c = f.float() * c + (i * g).float()
            h_t = o * tanh_q(c.to(gdt))
            ys[t] = h_t
            h = h_t.float()
    return ys, h, c, c_ckpt


def lstm_slab_bwd_ref(w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT,
                      reverse: bool):
    """Plain version of the backward kernel. hp [T, R, H] is the h entering
    each frame. Returns (dx [T, R, C] in x's dtype, dw_ih, dw_hh, db, dh0,
    dc0 float32)."""
    t_len, r, c_in = x.shape
    hidden = w_hh.shape[0]
    kf, nb = n_slabs(t_len)
    gdt = BF16 if is_mixed(x, w_hh) else F32
    dx = torch.empty_like(x)
    dw_ih = torch.zeros(w_ih.shape, dtype=F32, device=x.device)
    dw_hh = torch.zeros(w_hh.shape, dtype=F32, device=x.device)
    db = torch.zeros(b.shape, dtype=F32, device=x.device)
    dh, dc = dhT.float(), dcT.float()
    for js in range(nb):
        blk = js if reverse else nb - 1 - js
        lo, hi = blk * kf, min(t_len, blk * kf + kf)
        order = list(range(hi - 1, lo - 1, -1) if reverse else range(lo, hi))
        # re-forward the slab's cell states from its checkpoint
        gates = ((_mm(x[lo:hi], w_ih) + _mm(hp[lo:hi], w_hh)) + b.float()
                 ).to(gdt)
        acts = act(gates, hidden)
        c = c_ckpt[blk]
        c_prev = {}
        for t in order:
            i, f, g, _ = (a[t - lo] for a in acts)
            c_prev[t] = c
            c = f.float() * c + (i * g).float()
        acts = [a.float() for a in acts]
        # reverse walk: gate gradients and the (dh, dc) chain
        dgs = torch.empty(hi - lo, r, 4 * hidden, dtype=gdt, device=x.device)
        for t in reversed(order):
            i, f, g, o = (a[t - lo] for a in acts)
            cp = c_prev[t]
            tc = tanh_q((f * cp + i * g).to(gdt)).float()
            d = dy[t].float() + dh
            dc = dc + d * o * (1.0 - tc * tc)
            dgates = torch.cat([dc * g * i * (1.0 - i),
                                dc * cp * f * (1.0 - f),
                                dc * i * (1.0 - g * g),
                                d * tc * o * (1.0 - o)], dim=-1)
            db += dgates.sum(dim=0)
            dgs[t - lo] = dgates
            dh = _mm(dgs[t - lo], w_hh.T)
            dc = dc * f
        dx[lo:hi] = _mm(dgs, w_ih.T)
        dg2 = dgs.reshape(-1, 4 * hidden)
        dw_ih += _mm(x[lo:hi].reshape(-1, c_in).to(gdt).T, dg2)
        dw_hh += _mm(hp[lo:hi].reshape(-1, hidden).T, dg2)
    return dx, dw_ih, dw_hh, db, dh, dc


# --------------------------------------------------------- CUDA kernels ----

def _check(name, t, shape, device, dtype):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _dtype_code(x, w_hh) -> int:
    """Index into DTYPES of (x.dtype, w_hh.dtype); any other pair raises."""
    pair = (x.dtype, w_hh.dtype)
    if pair not in DTYPES:
        raise TypeError(
            f"x {x.dtype} with weights {w_hh.dtype}: the slab kernels take "
            "(x, weights) in " + ", ".join(f"({a}, {b})" for a, b in DTYPES))
    return DTYPES.index(pair)


def fwd_smem(c_in: int, hidden: int, rows: int, code: int = 0,
             bseq: bool = False) -> int:
    """Shared memory of one forward block of `rows` rows (bytes), as
    csrc/lstm_fwd32.cuh's `smem_bytes` (fp32, code 0) and `mixed_layout`
    (the mixed pairs of DTYPES; bseq: the bf16-gx layout of rows 8b and 6b)
    lay it out: W_ih (fp32 gate-interleaved; for bf16 weights (code 1)
    bf16, transposed, each of its 4H rows C rounded up to 16, plus 8), the
    slab's gx (K frames x rows, each row H + 2 float 4-vectors; bseq: K / 2
    frames, H + 8 bf16 4-vectors), its x tile (fp32, or bf16 at W_ih's row
    stride), and h (double-buffered) and c at rows rounded up to 4, each row
    H + 8 floats."""
    r4 = -(-rows // 4) * 4
    hc = 12 * r4 * (hidden + 8)
    if code == 0:
        return (16 * c_in * hidden + 16 * K * rows * (hidden + 2)
                + 4 * K * rows * c_in + hc)
    xs = -(-c_in // 16) * 16 + 8 if code == 1 else c_in
    n = (K // 2 if bseq else K) * rows
    w = 8 * hidden * xs if code == 1 else 16 * c_in * hidden
    gx = 8 * n * (hidden + 8) if bseq else 16 * n * (hidden + 2)
    return w + gx + 2 * n * xs + hc


def fwd_row_tiles(r: int, c_in: int, hidden: int, n_sm: int = N_SM,
                  nd: int = 1, code: int = 0,
                  bseq: bool = False) -> tuple[int, int]:
    """(rows a block, blocks) of the forward walk for R = r rows and nd
    directions (rows 6, 10: one; rows 5, 8: two, each direction a grid of
    its own ceil(r / rows) row tiles), code the (x, weights) pair of DTYPES
    and bseq the bf16-gx layout of rows 8b and 6b (`fwd_smem`): the fewest
    rows that keep the grid within one wave of n_sm blocks (one block an
    SM), up to FWD_ROWS_MAX (fp32) or FWD_ROWS_MAX_MIXED, fewer where the
    block's shared memory would not fit (then the grid takes more waves). A
    block walks its rows' T frames in series, so its rows set the kernel's
    time."""
    cap = FWD_ROWS_MAX_MIXED if code else FWD_ROWS_MAX
    rows = min(cap, -(-nd * r // n_sm))
    while rows < cap and nd * -(-r // rows) > n_sm:
        rows += 1
    while rows > 1 and fwd_smem(c_in, hidden, rows, code,
                                bseq) > SMEM_LIMIT_BYTES:
        rows -= 1
    return rows, nd * -(-r // rows)


def _check_fwd_dims(x, hidden, code=0, bseq=False):
    """What the forward walk takes for the (x, weights) pair `code` of
    DTYPES (bseq: the bf16-gx layout of rows 8b and 6b): H in FWD32_HIDDEN;
    C a multiple of 4, or of 8 in the mixed mode (its bf16 x tile is copied in
    16-byte pieces too), and with bf16 weights (code 1, the tensor cores'
    projection) C <= MIXED_TC_C_MAX; one row's shared memory within a
    block's limit; x 16-byte aligned."""
    t_len, r, c_in = x.shape
    kind = "mixed" if code else "fp32"
    if hidden not in FWD32_HIDDEN:
        raise ValueError(f"H={hidden}: the {kind} forward kernels take H in "
                         f"{', '.join(map(str, FWD32_HIDDEN))}")
    step = 8 if code else 4
    if c_in < step or c_in % step:
        raise ValueError(f"C={c_in}: the {kind} forward kernels take C a "
                         f"multiple of {step}")
    if code == 1 and c_in > MIXED_TC_C_MAX:
        raise ValueError(f"C={c_in}: the mixed forward with bf16 weights "
                         f"takes C <= {MIXED_TC_C_MAX} (its tensor-core "
                         "projection)")
    smem = fwd_smem(c_in, hidden, 1, code, bseq)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"C={c_in}, H={hidden}: the {kind} forward needs "
                         f"{smem} B of shared memory, more than "
                         f"{SMEM_LIMIT_BYTES}")
    if x.data_ptr() % 16:
        raise ValueError("x: not aligned to 16 bytes")
    if t_len < 1 or r < 1:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    return t_len, r, c_in, hidden


def bwd_smem(c_in: int, hidden: int, rows: int, code: int) -> int:
    """Shared memory of one backward block of `rows` rows (bytes), as
    csrc/lstm_slab.cu's `bwd_layout` lays it out: the weights (transposed,
    rows padded, for the tensor cores when they are bf16), the slab's x | hp
    rows (both in the weights' type), its gate tile (float, bf16 in the mixed
    mode), the cell states entering each frame and, in the mixed mode, one
    frame's float gate gradients."""
    def al16(n):
        return -(-n // 16) * 16
    wb = 2 if code == 1 else 4
    ch, n = c_in + hidden, K * rows
    xs = al16(ch) + 8 if code == 1 else ch
    w = 4 * hidden * xs * wb if code == 1 else ch * hidden * 4 * wb
    return (al16(w) + al16(n * xs * wb)
            + al16(n * hidden * 4 * (2 if code else 4)) + al16(n * hidden * 4)
            + (rows * hidden * 16 if code else 0))


def bwd_row_tiles(r: int, c_in: int, hidden: int, code: int,
                  n_sm: int = N_SM) -> tuple[int, int]:
    """(rows a block, blocks) of the backward kernel for R = r rows: the
    fewest rows that keep the grid within one wave of n_sm blocks (one block
    an SM), fewer where the block's shared memory would not fit. A block's
    walk is serial in T, so its rows set the kernel's time."""
    rows = min(BWD_ROWS_MAX, -(-r // n_sm))
    while rows > 1 and bwd_smem(c_in, hidden, rows, code) > SMEM_LIMIT_BYTES:
        rows -= 1
    return rows, -(-r // rows)


def _check_bwd_dims(x, w_hh, code):
    t_len, r, c_in = x.shape
    hidden = w_hh.shape[0]
    if hidden not in (8, 16, 32, 64):
        raise ValueError(f"H={hidden}: the backward kernel takes H in 8, 16, "
                         "32, 64")
    if c_in % 8 or not 8 <= c_in <= 2 * hidden:
        raise ValueError(f"C={c_in}: the backward kernel takes C a multiple "
                         f"of 8 in [8, 2H={2 * hidden}]")
    if c_in + hidden > BWD_MA * (BWD_THREADS // hidden):
        raise ValueError(f"C+H={c_in + hidden}: the backward kernel's dW "
                         f"threads hold at most "
                         f"{BWD_MA * (BWD_THREADS // hidden)} inputs")
    smem = bwd_smem(c_in, hidden, 1, code)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"C={c_in}, H={hidden}: the backward needs {smem} B "
                         f"of shared memory, more than {SMEM_LIMIT_BYTES}")
    if t_len < 1 or r < 1:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    return t_len, r, c_in, hidden


def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_fwd(w_ih, w_hh, b, x, h0, c0, reverse):
    dev = x.device
    _check("x", x, x.shape, dev, x.dtype)
    _check("w_hh", w_hh, w_hh.shape, dev, w_hh.dtype)
    code = _dtype_code(x, w_hh)
    wdt = w_hh.dtype
    lib = _build.load_library()
    t_len, r, c_in, hidden = _check_fwd_dims(x, w_hh.shape[0], code)
    rows = fwd_row_tiles(r, c_in, hidden, _n_sm(dev), code=code)[0]
    for name, t, shape, dt in (("w_ih", w_ih, (c_in, 4 * hidden), wdt),
                               ("w_hh", w_hh, (hidden, 4 * hidden), wdt),
                               ("b", b, (4 * hidden,), wdt),
                               ("h0", h0, (r, hidden), F32),
                               ("c0", c0, (r, hidden), F32)):
        _check(name, t, shape, dev, dt)
    kf, nb = n_slabs(t_len)
    ys = torch.empty((t_len, r, hidden), dtype=x.dtype, device=dev)
    hT = torch.empty((r, hidden), dtype=F32, device=dev)
    cT = torch.empty_like(hT)
    c_ckpt = torch.empty((nb, r, hidden), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sbt_lstm_slab_fwd(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), hT.data_ptr(),
            cT.data_ptr(), c_ckpt.data_ptr(), t_len, r, c_in, hidden, kf,
            int(bool(reverse)), code, rows, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"lstm_slab_fwd kernel launch failed: CUDA error "
                           f"{rc}")
    if code:
        lstm_slab_fwd.mixed_launches += 1
    else:
        lstm_slab_fwd.launches += 1
    return ys, hT, cT, c_ckpt


def _launch_bwd(w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT, reverse):
    dev = x.device
    _check("x", x, x.shape, dev, x.dtype)
    _check("w_hh", w_hh, w_hh.shape, dev, w_hh.dtype)
    code = _dtype_code(x, w_hh)
    xdt, wdt = x.dtype, w_hh.dtype
    t_len, r, c_in, hidden = _check_bwd_dims(x, w_hh, code)
    kf, nb = n_slabs(t_len)
    for name, t, shape, dt in (("w_ih", w_ih, (c_in, 4 * hidden), wdt),
                               ("w_hh", w_hh, (hidden, 4 * hidden), wdt),
                               ("b", b, (4 * hidden,), wdt),
                               ("hp", hp, (t_len, r, hidden), wdt),
                               ("c_ckpt", c_ckpt, (nb, r, hidden), F32),
                               ("dy", dy, (t_len, r, hidden), xdt),
                               ("dhT", dhT, (r, hidden), F32),
                               ("dcT", dcT, (r, hidden), F32)):
        _check(name, t, shape, dev, dt)
    for name, t in (("x", x), ("hp", hp)):     # read as 4-vectors
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name}: not aligned to {4 * t.element_size()} "
                             "bytes")
    lib = _build.load_library()
    rows, n_blocks = bwd_row_tiles(r, c_in, hidden, code, _n_sm(dev))

    def empty(*shape):
        return torch.empty(shape, dtype=F32, device=dev)

    dx = torch.empty_like(x)
    dw_ih, dw_hh, db = empty(c_in, 4 * hidden), empty(hidden, 4 * hidden), \
        empty(4 * hidden)
    dh0, dc0 = empty(r, hidden), empty(r, hidden)
    # scratch: one partial (dW_ih; dW_hh; db) a block, summed in block order
    part = empty(n_blocks, c_in + hidden + 1, 4 * hidden)
    with torch.cuda.device(dev):
        rc = lib.sbt_lstm_slab_bwd(
            x.data_ptr(), hp.data_ptr(), c_ckpt.data_ptr(), dy.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(), dhT.data_ptr(),
            dcT.data_ptr(), dx.data_ptr(), dw_ih.data_ptr(),
            dw_hh.data_ptr(), db.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            part.data_ptr(), t_len, r, c_in, hidden, kf, int(bool(reverse)),
            rows, code, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"lstm_slab_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    if code:
        lstm_slab_bwd.mixed_launches += 1
    else:
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
    (`lstm_slab_fwd.launches` counts the float32 instantiation's launches,
    `lstm_slab_fwd.mixed_launches` the mixed ones'), the plain version for
    CPU tensors. Returns (ys, hT, cT, c_ckpt)."""
    return _dispatch(x, _launch_fwd, lstm_slab_fwd_ref,
                     (w_ih, w_hh, b, x, h0, c0, reverse))


def lstm_slab_bwd(w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT,
                  reverse: bool):
    """Backward scan: the CUDA kernels for CUDA tensors
    (`lstm_slab_bwd.launches` / `.mixed_launches` count the calls of the
    float32 / mixed instantiation), the plain version for CPU tensors.
    Returns (dx, dw_ih, dw_hh, db, dh0, dc0)."""
    return _dispatch(x, _launch_bwd, lstm_slab_bwd_ref,
                     (w_ih, w_hh, b, x, hp, c_ckpt, dy, dhT, dcT, reverse))


lstm_slab_fwd.launches = lstm_slab_fwd.mixed_launches = 0
lstm_slab_bwd.launches = lstm_slab_bwd.mixed_launches = 0


# ------------------------------------------------------- autograd -------

def shift_prev(ys, h0, reverse: bool, mdt=None):
    """h entering each frame: the output of the previously processed frame,
    h0 entering the first one (cast to ys' dtype), all in `mdt` (the
    recurrence-matmul dtype, the weights'; default ys' dtype)."""
    h0r = h0[None].to(ys.dtype)
    if reverse:
        hp = torch.cat([ys[1:], h0r], dim=0)
    else:
        hp = torch.cat([h0r, ys[:-1]], dim=0)
    return hp if mdt is None else hp.to(mdt)


class _LstmSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, reverse, w_ih, w_hh, b, x, h0, c0):
        ys, hT, cT, c_ckpt = lstm_slab_fwd(w_ih, w_hh, b, x, h0, c0, reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(w_ih, w_hh, b, x, h0, c0, ys, c_ckpt)
        return ys, hT.to(h0.dtype), cT.to(c0.dtype)

    @staticmethod
    def backward(ctx, dy, dhT, dcT):
        w_ih, w_hh, b, x, h0, c0, ys, c_ckpt = ctx.saved_tensors
        hp = shift_prev(ys, h0, ctx.reverse, w_hh.dtype)
        dx, dw_ih, dw_hh, db, dh0, dc0 = lstm_slab_bwd(
            w_ih, w_hh, b, x, hp, c_ckpt, dy.to(x.dtype).contiguous(),
            dhT.float().contiguous(), dcT.float().contiguous(), ctx.reverse)
        # grads in each input's dtype, as the JAX custom VJP returns them
        return (None, dw_ih.to(w_ih.dtype), dw_hh.to(w_hh.dtype),
                db.to(b.dtype), dx, dh0.to(h0.dtype), dc0.to(c0.dtype))


def lstm_slab(reverse: bool, w_ih, w_hh, b, x, h0, c0):
    """(ys [T, R, H] in x's dtype, hT, cT [R, H] in h0's / c0's) for
    scan-major x [T, R, C]; the backward runs the slab backward scan."""
    return _LstmSlab.apply(bool(reverse), w_ih, w_hh, b, x.contiguous(),
                           h0.contiguous(), c0.contiguous())
