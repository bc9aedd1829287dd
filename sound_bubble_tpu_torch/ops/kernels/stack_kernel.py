"""The whole GridNet block stack in ONE kernel for a streaming step (T=1,
batch 1): port of `sound_bubble_tpu/ops/pallas/stack_kernel.py`
(`pack_stack_params`, `pack_attn_params`, `attn_ring_bytes`,
`gridnet_stack_step` with the plain intra BLSTM, `_kernel`, and the
conv_lstm intra, `_kernel_conv`; `gridnet_stack_step_attn`, the same with
local causal attention after each block's inter step, `_kernel_attn` and
`_kernel_conv_attn`).

`gridnet_stack_step` and `gridnet_stack_step_attn` launch hand-written CUDA
kernels for tensors on the card and run `gridnet_stack_step_ref` /
`gridnet_stack_step_attn_ref`, their plain PyTorch versions, for tensors on
the CPU. There is no fallback between the two: a CUDA tensor goes to the
kernel or the call raises. Every pack launches `stack_walk_kernel<H, kAttn,
kConv>` of `sound_bubble_tpu_torch/csrc/stack_walk.cu`: one cluster of eight
blocks a call (`walk_plan`), two of which walk the intra BLSTM's directions
while all eight share the row-parallel phases; the plain intra BLSTM (rows 1
and 3 of PERF.md's table) and, on a conv_lstm pack (rows 2 and 4, kConv),
the down conv and the up conv as row phases and the walk over the conv
frames (`conv_walk_plan`). `walk_phases_ref` / `conv_walk_phases_ref` run
the same phases in plain PyTorch, in the kernel's order. The design notes
and the bounds of the kernels are in their source.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from sound_bubble_tpu_torch.ops.kernels import _build
from sound_bubble_tpu_torch.ops.kernels.lstm_slab import FWD32_HIDDEN, fwd_smem

SMEM_LIMIT_BYTES = 232448    # dynamic shared memory one H100 block can use
CLUSTER = 8                  # blocks of the stack kernel's cluster


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def pack_stack_params(cfg, params) -> dict:
    """Model params (block{i} subtrees, nested dicts of arrays or tensors) ->
    stacked [B, ...] float32 kernel operands on the CPU.

    Fused BLSTM packing: gate g occupies columns [g*2H, g*2H+H) forward and
    [g*2H+H, (g+1)*2H) backward; the recurrent matrix is block-diagonal so the
    forward state only drives forward columns and vice versa.

    conv_lstm: the down conv is phase-split, `down_cat [B, C, s*C]` with
    column block j holding the stride-phase-j tap (row j*C+ci of the
    [s*C, C] kernel goes to [ci, j*C+co]); the up conv is `up_flat
    [B, 2H, s*C]`; `alpha [B, 1]` is the PReLU slope. These replace `proj_w`
    / `proj_b`; s is `down_cat`'s width over its height."""
    B, D, H = cfg.B, cfg.D, cfg.H
    if cfg.conv_lstm != ("down" in params["block0"]["intra"]):
        raise ValueError(f"conv_lstm={cfg.conv_lstm}, but the parameters "
                         "are those of the other intra variant")

    def gather(*path):
        out = []
        for i in range(B):
            node = params[f"block{i}"]
            for k in path:
                node = node[k]
            out.append(_np(node))
        return np.stack(out)

    wih_f = np.zeros((B, D, 8 * H), np.float32)
    wih_b = np.zeros((B, D, 8 * H), np.float32)
    whh = np.zeros((B, 2 * H, 8 * H), np.float32)
    b8 = np.zeros((B, 8 * H), np.float32)
    for i in range(B):
        bl = params[f"block{i}"]["intra"]["blstm"]
        fwd = {k: _np(v) for k, v in bl["fwd"].items()}
        bwd = {k: _np(v) for k, v in bl["bwd"].items()}
        for g in range(4):
            lo = g * 2 * H
            sl = slice(g * H, (g + 1) * H)
            wih_f[i, :, lo:lo + H] = fwd["w_ih"][:, sl]
            wih_b[i, :, lo + H:lo + 2 * H] = bwd["w_ih"][:, sl]
            whh[i, :H, lo:lo + H] = fwd["w_hh"][:, sl]
            whh[i, H:, lo + H:lo + 2 * H] = bwd["w_hh"][:, sl]
            b8[i, lo:lo + H] = fwd["b"][sl]
            b8[i, lo + H:lo + 2 * H] = bwd["b"][sl]

    packed = {
        "i_ln": np.stack([gather("intra", "norm", "scale"),
                          gather("intra", "norm", "bias")], axis=1),
        "wih_f": wih_f, "wih_b": wih_b, "whh": whh, "b8": b8,
        "t_ln": np.stack([gather("inter_norm", "scale"),
                          gather("inter_norm", "bias")], axis=1),
        "wih2": gather("inter_lstm", "w_ih"),
        "whh2": gather("inter_lstm", "w_hh"),
        "b2": gather("inter_lstm", "b"),
        "proj2_w": gather("inter_proj", "kernel"),
        "proj2_b": gather("inter_proj", "bias"),
    }
    if cfg.conv_lstm:
        s = cfg.lstm_down
        packed["down_cat"] = gather("intra", "down", "kernel").reshape(
            B, s, D, D).transpose(0, 2, 1, 3).reshape(B, D, s * D)
        packed["down_b"] = gather("intra", "down", "bias")
        packed["alpha"] = gather("intra", "act", "alpha").reshape(B, 1)
        packed["up_flat"] = gather("intra", "up_kernel").reshape(
            B, 2 * H, s * D)
        packed["up_b"] = gather("intra", "up_bias")
    else:
        packed["proj_w"] = gather("intra", "proj", "kernel")
        packed["proj_b"] = gather("intra", "proj", "bias")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in packed.items()}


def lstm_down(packed):
    """s of a conv_lstm pack (`down_cat [B, C, s*C]`), None otherwise."""
    if "down_cat" not in packed:
        return None
    _, d, sd = packed["down_cat"].shape
    return sd // d


def pack_attn_params(cfg, params) -> dict:
    """Attention weights (block{i}.attn_* subtrees) -> stacked [B, ...]
    float32 operands of the attention stack step, on the CPU. The JAX
    package's keys and layouts: per projection (q, k: width E per head; v:
    D // L) the Linear kernel [B, D, L*width], its bias, the PReLU slope
    [B, 1] and the per-head LayerNorm affine [B, 2, F, width] (scale, bias;
    shared by the heads); the output Linear [B, D, D], its bias, PReLU and
    the LayerNorm over the [F, D] frame as [B, 2, F, D]."""
    B, F, vd = cfg.B, cfg.n_freqs, cfg.D // cfg.L

    def gather(name, *path):
        out = []
        for i in range(B):
            node = params[f"block{i}"][name]
            for k in path:
                node = node[k]
            out.append(_np(node))
        return np.stack(out)

    packed = {}
    for tag, width in (("q", cfg.E), ("k", cfg.E), ("v", vd)):
        nm = f"attn_{tag}"
        packed[f"{tag}_w"] = gather(nm, "proj", "kernel")
        packed[f"{tag}_b"] = gather(nm, "proj", "bias")
        packed[f"{tag}_a"] = gather(nm, "act", "alpha").reshape(B, 1)
        packed[f"{tag}_ln"] = np.stack(
            [gather(nm, "norm", "scale"), gather(nm, "norm", "bias")],
            axis=1).reshape(B, 2, F, width)
    packed["o_w"] = gather("attn_out_proj", "kernel")
    packed["o_b"] = gather("attn_out_proj", "bias")
    packed["o_a"] = gather("attn_out_act", "alpha").reshape(B, 1)
    packed["o_ln"] = np.stack(
        [gather("attn_out_norm", "scale"), gather("attn_out_norm", "bias")],
        axis=1).reshape(B, 2, F, cfg.D)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in packed.items()}


def attn_ring_bytes(cfg, f_len: int) -> int:
    """fp32 bytes of the whole stack's K/V rings: B blocks x L heads x W
    slots x F x (E + D // L) floats (13.9 MB at the flagship width, 5.57 MB
    at the Orange Pi width)."""
    vd = cfg.D // cfg.L
    return cfg.B * cfg.L * cfg.local_atten_len * f_len * (cfg.E + vd) * 4


# operand order of the kernels' C entry points (after x, film_w, film_b): a
# conv_lstm pack gives its up conv in proj_w's and proj_b's places and its
# down conv and PReLU slope after proj2_b (null for a plain pack)
_WEIGHTS = ("i_ln", "wih_f", "wih_b", "whh", "b8", "proj_w", "proj_b",
            "t_ln", "wih2", "whh2", "b2", "proj2_w", "proj2_b")
_UP = {"proj_w": "up_flat", "proj_b": "up_b"}
_DOWN = ("down_cat", "down_b", "alpha")
# the attention operands, after the weights
_ATTN = ("q_w", "q_b", "q_a", "q_ln", "k_w", "k_b", "k_a", "k_ln",
         "v_w", "v_b", "v_a", "v_ln", "o_w", "o_b", "o_a", "o_ln")
# the attention LayerNorms take flax's default eps, not cfg.eps (JAX model
# `AttnProj.norm`, `attn_out_norm`; Pallas `_attn_step`)
ATTN_LN_EPS = 1e-5


# ------------------------------------------------------ plain PyTorch ----

def _ln(x, s, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def _fused_blstm(p, b, z, hidden):
    """Both directions of the intra BLSTM over the n rows of z [n, D] in
    one recurrence: the backward direction reads row n-1-f at step f and
    stores its h there. Returns y [n, 2H] (fwd | bwd)."""
    H, h2 = hidden, 2 * hidden
    F = z.shape[0]
    gxf = z @ p["wih_f"][b] + p["b8"][b]               # [n, 8H]
    gxb = z @ p["wih_b"][b]
    h1 = z.new_zeros(1, h2)
    c1 = z.new_zeros(1, h2)
    yf, yb = [None] * F, [None] * F
    for f in range(F):
        rev = F - 1 - f
        gates = gxf[f] + gxb[rev] + h1 @ p["whh"][b]
        ig = torch.sigmoid(gates[:, 0:h2])
        fg = torch.sigmoid(gates[:, h2:2 * h2])
        gg = torch.tanh(gates[:, 2 * h2:3 * h2])
        og = torch.sigmoid(gates[:, 3 * h2:])
        c1 = fg * c1 + ig * gg
        h1 = og * torch.tanh(c1)
        yf[f] = h1[0, :H]                              # fwd h at row f
        yb[rev] = h1[0, H:]                            # bwd h at mirrored row
    return torch.cat([torch.stack(yf), torch.stack(yb)], dim=-1)


def _intra_blstm(p, b, x, hidden, eps):
    """Fused-direction intra BLSTM over frequency + residual proj (one
    block). x: [F, D]; returns the updated x."""
    z = _ln(x, p["i_ln"][b, 0], p["i_ln"][b, 1], eps)
    y2h = _fused_blstm(p, b, z, hidden)
    return x + y2h @ p["proj_w"][b] + p["proj_b"][b]


def _intra_conv(p, b, x, hidden, eps):
    """conv_lstm intra for one block (the Pallas `_intra_conv`): the
    phase-split down conv, PReLU, LayerNorm, the fused BLSTM over the
    k = F // s frames, the up conv added to rows < k*s; rows from k*s on keep
    x. x: [F, D]; returns the updated x (a new tensor)."""
    s = lstm_down(p)
    F, C = x.shape
    k = F // s
    taps = x @ p["down_cat"][b]                        # [F, s*C]
    z = p["down_b"][b].expand(k, C)
    for j in range(s):                                 # frame f sums rows f*s+j
        z = z + taps[j:k * s:s, j * C:(j + 1) * C]
    alpha = p["alpha"][b, 0]
    z = torch.clamp(z, min=0) + alpha * torch.clamp(z, max=0)
    z = _ln(z, p["i_ln"][b, 0], p["i_ln"][b, 1], eps)
    y2h = _fused_blstm(p, b, z, hidden)                # [k, 2H]
    up = (y2h @ p["up_flat"][b]).reshape(k * s, C)     # row f*s+j: phase j
    return torch.cat([x[:k * s] + up + p["up_b"][b], x[k * s:]])


def _inter_step(p, b, x, h0, c0, hidden, eps):
    """ONE stateful inter-LSTM step, all F frequency lanes in parallel."""
    H = hidden
    z2 = _ln(x, p["t_ln"][b, 0], p["t_ln"][b, 1], eps)
    g2 = z2 @ p["wih2"][b] + p["b2"][b] + h0[b] @ p["whh2"][b]
    i2 = torch.sigmoid(g2[:, 0:H])
    f2 = torch.sigmoid(g2[:, H:2 * H])
    gg2 = torch.tanh(g2[:, 2 * H:3 * H])
    o2 = torch.sigmoid(g2[:, 3 * H:])
    c_new = f2 * c0[b] + i2 * gg2
    h_new = o2 * torch.tanh(c_new)
    return x + h_new @ p["proj2_w"][b] + p["proj2_b"][b], h_new, c_new


def _prelu(z, alpha):
    return torch.clamp(z, min=0) + alpha * torch.clamp(z, max=0)


def _ln2d(x, s, b):
    """LayerNorm whose statistics span the whole 2-D slab (the model's
    LayerNorm over a flattened [F*e] row), affine [F, e]."""
    mu = x.mean()
    var = (x - mu).square().mean()
    return (x - mu) * torch.rsqrt(var + ATTN_LN_EPS) * s + b


def _attn_step(pa, b, x, pos, k_ring, v_ring, heads):
    """Local causal attention of block b at streaming T=1 (the Pallas
    `_attn_step`): q, k, v = PReLU(x @ W + b) with a per-head LayerNorm over
    the [F, e] slab; this frame's k, v written to slot `pos` of the rings
    (in place); each head's scores over the W slots, scaled by
    1/sqrt(F*E), and a softmax with no mask (slots not written yet hold
    zeros and are attended, as the model attends its zero K_buf); the
    probability-weighted values, head-minor ([F, D], channel l*vd + j);
    output Linear -> PReLU -> LayerNorm over the [F, D] frame ->
    residual. x: [F, D]; k_ring [B, L*E, W, F], v_ring [B, D, W, F]."""
    F, C = x.shape
    e, vd = k_ring.shape[1] // heads, C // heads
    scale = 1.0 / math.sqrt(F * e)
    zq, zk, zv = (_prelu(x @ pa[f"{t}_w"][b] + pa[f"{t}_b"][b],
                         pa[f"{t}_a"][b, 0]) for t in "qkv")
    outs = []
    for h in range(heads):
        qh = _ln2d(zq[:, h * e:(h + 1) * e], *pa["q_ln"][b])     # [F, e]
        kh = _ln2d(zk[:, h * e:(h + 1) * e], *pa["k_ln"][b])
        vh = _ln2d(zv[:, h * vd:(h + 1) * vd], *pa["v_ln"][b])  # [F, vd]
        k_ring[b, h * e:(h + 1) * e, pos] = kh.T
        v_ring[b, h * vd:(h + 1) * vd, pos] = vh.T
        scores = torch.einsum("fj,jwf->w", qh,
                              k_ring[b, h * e:(h + 1) * e]) * scale
        outs.append(torch.einsum("w,jwf->fj", scores.softmax(dim=0),
                                 v_ring[b, h * vd:(h + 1) * vd]))
    o = _prelu(torch.cat(outs, dim=-1) @ pa["o_w"][b] + pa["o_b"][b],
               pa["o_a"][b, 0])
    return x + _ln2d(o, *pa["o_ln"][b])


def gridnet_stack_step_ref(packed, x, h0, c0, film_w=None, film_b=None,
                           eps: float = 1e-5):
    """Plain PyTorch version of the kernel, the same math step by step.

    x: [F, D]; h0/c0: [B, F, H]; film_w/film_b: [B-1, F, D] or None.
    Returns (x_out [F, D], h0' [B, F, H], c0' [B, F, H])."""
    x, h0, c0, _, _ = _stack_ref(packed, None, x, h0, c0, film_w, film_b,
                                 eps)
    return x, h0, c0


def gridnet_stack_step_attn_ref(packed, packed_attn, x, h0, c0, k_ring,
                                v_ring, pos, heads, film_w=None, film_b=None,
                                eps: float = 1e-5):
    """Plain PyTorch version of the attention stack step: each block's
    intra and inter parts as in `gridnet_stack_step_ref`, then
    `_attn_step`. Writes slot pos mod W of k_ring / v_ring in place, as
    the kernel does, and returns (x_out, h0', c0', k_ring, v_ring)."""
    return _stack_ref(packed, (packed_attn, k_ring, v_ring,
                               int(pos) % k_ring.shape[2], heads),
                      x, h0, c0, film_w, film_b, eps)


def _stack_ref(packed, attn, x, h0, c0, film_w, film_b, eps):
    n_blocks, _, hidden4 = packed["wih2"].shape
    hidden = hidden4 // 4
    intra = _intra_blstm if lstm_down(packed) is None else _intra_conv
    hs, cs = [], []
    for b in range(n_blocks):
        if film_w is not None and b > 0:
            x = x * film_w[b - 1] + film_b[b - 1]
        x = intra(packed, b, x, hidden, eps)
        x, h_new, c_new = _inter_step(packed, b, x, h0, c0, hidden, eps)
        if attn is not None:
            pa, k_ring, v_ring, pos, heads = attn
            x = _attn_step(pa, b, x, pos, k_ring, v_ring, heads)
        hs.append(h_new)
        cs.append(c_new)
    rings = (None, None) if attn is None else attn[1:3]
    return (x, torch.stack(hs), torch.stack(cs), *rings)


# ------------------------------- the cluster kernel's phases, plain ----

def conv_walk_tiles(f_len: int, s: int) -> list[tuple[int, int, int, int]]:
    """(first frame, frames, first row, rows) owned by each block of the
    stack kernel's cluster, for F = f_len rows and stride s (1: the plain
    intra, a frame a row): ceil(k / 8) consecutive conv frames a block, k =
    F // s, each frame its s rows (the last blocks may own fewer, or none);
    the rows from k*s on, which take only the inter step, go to the block
    after the last frame's (the last block if that one owns frames)."""
    k = f_len // s
    fc = -(-k // CLUSTER)
    tail = min(CLUSTER - 1, -(-k // fc))
    tiles = []
    for c in range(CLUSTER):
        q0 = min(k, c * fc)
        nq = min(k, q0 + fc) - q0
        tiles.append((q0, nq, q0 * s, f_len - q0 * s if c == tail else nq * s))
    return tiles


def walk_tiles(f_len: int) -> list[tuple[int, int]]:
    """(first row, rows) owned by each block of the rows-1/3 kernel's
    cluster: ceil(F / 8) consecutive rows a block (the last ones may own
    fewer, or none)."""
    return [(f0, n) for _, _, f0, n in conv_walk_tiles(f_len, 1)]


def _phase_walk(p, b, z, hidden):
    """Blocks 0 and 1: each direction d of block b's intra BLSTM walks z
    [T, D] on its own columns of the fused pack (gate g at g*2H + d*H of
    w_ih, b8 and the diagonal block of whh), the backward one reversed, from
    zero states. Returns y [T, 2H] (fwd | bwd, original row order)."""
    H = hidden
    ys = []
    for d, w_ih in enumerate((p["wih_f"], p["wih_b"])):
        cols = torch.cat([torch.arange(g * 2 * H + d * H, g * 2 * H + d * H
                                       + H) for g in range(4)])
        wi, bias = w_ih[b][:, cols], p["b8"][b][cols]
        wh = p["whh"][b][d * H:(d + 1) * H][:, cols]
        zd = z.flip(0) if d else z
        gx = zd @ wi + bias
        h = c = z.new_zeros(H)
        out = []
        for f in range(z.shape[0]):
            g = gx[f] + h @ wh
            c = torch.sigmoid(g[H:2 * H]) * c + torch.sigmoid(g[:H]) * \
                torch.tanh(g[2 * H:3 * H])
            h = torch.sigmoid(g[3 * H:]) * torch.tanh(c)
            out.append(h)
        y = torch.stack(out)
        ys.append(y.flip(0) if d else y)
    return torch.cat(ys, dim=-1)


def _phase_head(p, b, x, nq, eps):
    """A block's intra head on its rows x [n, D], the walk's input rows:
    the LayerNorm of every row (plain pack) or, on a conv_lstm pack, the
    down conv of its nq frames (a frame's s rows as one [s*D] row times
    down_cat laid out as [s*D, D]: row j*D + ci holds tap j of input ci),
    PReLU and the LayerNorm."""
    if "down_cat" not in p:
        return _ln(x, p["i_ln"][b, 0], p["i_ln"][b, 1], eps)
    d = x.shape[-1]
    s = p["down_cat"].shape[-1] // d
    w = p["down_cat"][b].reshape(d, s, d).transpose(0, 1).reshape(s * d, d)
    z = _prelu(x[:nq * s].reshape(nq, s * d) @ w + p["down_b"][b],
               p["alpha"][b, 0])
    return _ln(z, p["i_ln"][b, 0], p["i_ln"][b, 1], eps)


def _phase_rows(p, b, x, y, hr, c0, hidden, eps):
    """A block's row phase on its rows x [n, D] from its frames' y [nq,
    2H]: the intra tail, x += y W_proj + b_proj (on a conv_lstm pack the up
    conv, y up_flat + up_b on the first nq*s rows, phase j of frame q to row
    q*s + j; the rows past them keep x); the inter LayerNorm; the gates
    (z2 W_ih2 + b2) + hr (hr = h0 W_hh2, formed during the first walk) and
    cell; x += h' W_proj2 + b_proj2. Returns (x, h', c')."""
    H = hidden
    w, bias = ((p["proj_w"], p["proj_b"]) if "proj_w" in p
               else (p["up_flat"], p["up_b"]))
    d = x.shape[-1]
    m = y.shape[0] * w.shape[-1] // d               # rows the tail reaches
    x = torch.cat([x[:m] + (y @ w[b]).reshape(m, d) + bias[b], x[m:]])
    z2 = _ln(x, p["t_ln"][b, 0], p["t_ln"][b, 1], eps)
    g = (z2 @ p["wih2"][b] + p["b2"][b]) + hr
    c = torch.sigmoid(g[:, H:2 * H]) * c0 + torch.sigmoid(g[:, :H]) * \
        torch.tanh(g[:, 2 * H:3 * H])
    h = torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c)
    return x + h @ p["proj2_w"][b] + p["proj2_b"][b], h, c


def _moments(v):
    """A block's partial of a LayerNorm over values v: (count, mean, sum of
    squared deviations)."""
    if v.numel() == 0:
        return 0, v.new_zeros(()), v.new_zeros(())
    mu = v.mean()
    return v.numel(), mu, (v - mu).square().sum()


def _combine(parts, eps):
    """(mean, 1/sqrt(var + eps)) over all rows from the blocks' partials
    (Chan's pairwise formula, summed)."""
    total = sum(n for n, _, _ in parts)
    mean = sum(n * mu for n, mu, _ in parts) / total
    m2 = sum(m2 + n * (mu - mean) ** 2 for n, mu, m2 in parts)
    return mean, torch.rsqrt(m2 / total + eps)


def _phase_attn(pa, b, xs, tiles, pos, k_ring, v_ring, heads):
    """Block b's attention step as the kernel's four phases, on the rows of
    every block (xs: their x rows); writes slot pos of the rings in place
    and returns the blocks' new x rows."""
    F = sum(n for _, n in tiles)
    d = xs[0].shape[-1]
    e, vd = k_ring.shape[1] // heads, d // heads
    widths = {"q": e, "k": e, "v": vd}
    # 1. q, k, v of each block's rows; each (tensor, head) slab's partials
    qkv = [{t: _prelu(x @ pa[f"{t}_w"][b] + pa[f"{t}_b"][b],
                      pa[f"{t}_a"][b, 0]) for t in "qkv"} for x in xs]
    # 2. the combine; normalise the own rows; the ring slot; partial scores
    for t, w in widths.items():
        for h in range(heads):
            mu, inv = _combine([_moments(m[t][:, h * w:(h + 1) * w])
                                for m in qkv], ATTN_LN_EPS)
            for m, (f0, n) in zip(qkv, tiles):
                sl = m[t][:, h * w:(h + 1) * w]
                m[t][:, h * w:(h + 1) * w] = (sl - mu) * inv * \
                    pa[f"{t}_ln"][b, 0, f0:f0 + n] + \
                    pa[f"{t}_ln"][b, 1, f0:f0 + n]
    for m, (f0, n) in zip(qkv, tiles):
        k_ring[b, :, pos, f0:f0 + n] = m["k"].T
        v_ring[b, :, pos, f0:f0 + n] = m["v"].T
    parts = [torch.stack([torch.einsum(
        "fj,jwf->w", m["q"][:, h * e:(h + 1) * e],
        k_ring[b, h * e:(h + 1) * e, :, f0:f0 + n]) for h in range(heads)])
        for m, (f0, n) in zip(qkv, tiles)]
    # 3. the scores, the softmax, the weighted values, the output Linear
    # and PReLU; partials of the frame's LayerNorm
    prob = (sum(parts) / math.sqrt(F * e)).softmax(dim=-1)      # [L, W]
    zo = []
    for f0, n in tiles:
        o = torch.einsum("cw,cwf->fc", prob.repeat_interleave(vd, dim=0),
                         v_ring[b, :, :, f0:f0 + n])
        zo.append(_prelu(o @ pa["o_w"][b] + pa["o_b"][b], pa["o_a"][b, 0]))
    # 4. the combine, the LayerNorm over the [F, D] frame, the residual
    mu, inv = _combine([_moments(z) for z in zo], ATTN_LN_EPS)
    return [x + (z - mu) * inv * pa["o_ln"][b, 0, f0:f0 + n]
            + pa["o_ln"][b, 1, f0:f0 + n]
            for x, z, (f0, n) in zip(xs, zo, tiles)]


def walk_phases_ref(packed, x, h0, c0, film_w=None, film_b=None,
                    eps: float = 1e-5, attn=None):
    """The stack kernel's phases in plain PyTorch, in its launch order: the
    same function as `gridnet_stack_step_ref` (attn None) or
    `gridnet_stack_step_attn_ref` (attn = (packed_attn, k_ring, v_ring, pos,
    heads); the rings' slot pos mod W written in place) and the same returns,
    computed block by block as the kernel's blocks do: each direction's walk
    on its pack columns, the rows' phases tile by tile (`conv_walk_tiles`),
    every reduction over the frame a partial a tile and a combine. Rows 1/3
    on a plain pack; on a conv_lstm pack see `conv_walk_phases_ref`."""
    n_blocks, _, hidden4 = packed["wih2"].shape
    hidden = hidden4 // 4
    p = packed
    tiles = conv_walk_tiles(x.shape[0], lstm_down(p) or 1)
    rows_of = [(f0, n) for _, _, f0, n in tiles]
    # prologue: each block's x rows and block 0's walk input; blocks 2-7
    # form hr
    xs = [x[f0:f0 + n] for f0, n in rows_of]

    def walk_input(b):
        return torch.cat([_phase_head(p, b, r, nq, eps)
                          for r, (_, nq, _, _) in zip(xs, tiles)])

    z = walk_input(0)
    hr = h0 @ p["whh2"]
    hs, cs = [], []
    for b in range(n_blocks):
        y = _phase_walk(p, b, z, hidden)
        rows = [_phase_rows(p, b, r, y[q0:q0 + nq], hr[b, f0:f0 + n],
                            c0[b, f0:f0 + n], hidden, eps)
                for r, (q0, nq, f0, n) in zip(xs, tiles)]
        xs = [r[0] for r in rows]
        hs.append(torch.cat([r[1] for r in rows]))
        cs.append(torch.cat([r[2] for r in rows]))
        if attn is not None:
            pa, k_ring, v_ring, pos, heads = attn
            xs = _phase_attn(pa, b, xs, rows_of, int(pos) % k_ring.shape[2],
                             k_ring, v_ring, heads)
        if b + 1 < n_blocks:
            if film_w is not None:
                xs = [r * film_w[b, f0:f0 + n] + film_b[b, f0:f0 + n]
                      for r, (f0, n) in zip(xs, rows_of)]
            z = walk_input(b + 1)
    out = (torch.cat(xs), torch.stack(hs), torch.stack(cs))
    return out if attn is None else (*out, attn[1], attn[2])


def conv_walk_phases_ref(packed, x, h0, c0, film_w=None, film_b=None,
                         eps: float = 1e-5, attn=None):
    """Rows 2/4's phases in plain PyTorch, in the kernel's launch order:
    `walk_phases_ref` on a conv_lstm pack, the same function as
    `gridnet_stack_step_ref` / `_attn_ref` there. Each block owns whole
    conv frames (`conv_walk_tiles`): its head is the down conv of its
    frames, PReLU and the LayerNorm; blocks 0 and 1 walk the k = F // s
    frames; its tail is the up conv on its frames' rows; the rest as on a
    plain pack."""
    if lstm_down(packed) is None:
        raise ValueError("conv_walk_phases_ref: not a conv_lstm pack")
    return walk_phases_ref(packed, x, h0, c0, film_w, film_b, eps, attn)


# --------------------------------------------------------- CUDA kernel ----

def walk_plan(f_len: int, d: int, hidden: int, n_blocks: int,
              attn=None, lstm_down: int | None = None) -> dict:
    """The launch of the stack kernel (`csrc/stack_walk.cu`) for F = f_len
    rows of width D = d, H = hidden, B = n_blocks blocks, attn = (heads L,
    E, W) or None and, for a conv_lstm pack, stride s = lstm_down (rows 2/4;
    `conv_walk_plan`): one cluster of `ctas` blocks of `threads` threads,
    at most `rows` rows (and, conv_lstm, `frames` conv frames) a block,
    `smem` bytes of dynamic shared memory a block (the walk's, then the
    block's staged operands, rows and scratch) and `scratch` floats of
    global scratch. Raises ValueError for a width the kernel does not take:
    H outside 8, 16, 32, 64 (ROADMAP Queue 2 item 10), D not a multiple of
    4, F < s (no conv frame), or more shared memory than a block has."""
    if hidden not in FWD32_HIDDEN:
        raise ValueError(
            f"H={hidden}: the stack step's kernel takes H in "
            f"{', '.join(map(str, FWD32_HIDDEN))} (the widths of its walk; "
            "ROADMAP Queue 2 item 10)")
    if d < 4 or d % 4:
        raise ValueError(f"D={d}: the stack step's kernel takes D a "
                         "multiple of 4")
    if f_len < 1 or n_blocks < 1:
        raise ValueError(f"F={f_len}, B={n_blocks}: empty step")
    s = lstm_down or 1
    k = f_len // s
    if k < 1:
        raise ValueError(f"F={f_len} < lstm_down={s}: no conv frame")
    frames = -(-k // CLUSTER)
    rows = frames * s + f_len - k * s

    def al4(floats):    # each part of a block's region is 16-byte aligned
        return -(-floats // 4) * 4

    # staged a block: proj_w (up_flat [2H, s*D]), wih2, proj2_w; proj_b,
    # b2, proj2_b, the inter and the next intra LayerNorm; the rows' c0 and
    # FiLM; conv_lstm: the next down conv [s*D, D], its bias and PReLU
    # slope. The rows: x, z, h'; the frames' y; the gates
    staged = ((2 * s + 5) * hidden * d + 6 * d + 4 * hidden
              + rows * (hidden + 2 * d))
    if lstm_down is not None:
        staged += s * d * d + d + 1
    gates = rows * 4 * hidden
    scratch = k * (d + 2 * hidden) + f_len * 4 * hidden * n_blocks  # z, y, hr
    if attn is not None:
        heads, e_dim, window = attn
        le = heads * e_dim
        # staged: q_w, k_w, v_w, o_w, their biases and PReLU slopes, the
        # rows' LayerNorm affines. In the gates' place, after the inter
        # step: q | k | v, the attention output; the scores; the moments
        staged += (2 * d * (le + d) + 2 * le + 2 * d + 4
                   + 2 * rows * (2 * e_dim + d // heads + d))
        gates = max(gates, al4(rows * (2 * le + d)) + rows * d
                    + heads * window + 2 * (3 * heads + 1))
        scratch += CLUSTER * (2 * (3 * heads + 1) + heads * window)
    own = rows * (2 * d + hidden) + frames * 2 * hidden + al4(gates)
    smem = fwd_smem(d, hidden, 1) + 4 * (al4(staged) + own)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"F={f_len}, D={d}, H={hidden}: a block needs "
                         f"{smem} B of shared memory, more than "
                         f"{SMEM_LIMIT_BYTES}")
    plan = {"ctas": CLUSTER, "threads": 4 * hidden, "rows": rows,
            "smem": smem, "scratch": scratch}
    if lstm_down is not None:
        plan["frames"] = frames
    return plan


def conv_walk_plan(f_len: int, d: int, hidden: int, n_blocks: int, s: int,
                   attn=None) -> dict:
    """`walk_plan` of rows 2/4: a conv_lstm pack of stride s."""
    return walk_plan(f_len, d, hidden, n_blocks, attn, s)


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{name}: bfloat16 is not ported yet; the stack-step kernels "
            "take float32")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_pos(pos, device):
    if not isinstance(pos, torch.Tensor):
        raise TypeError(f"pos: expected an int32 tensor of shape [1], got "
                        f"{type(pos).__name__}")
    if pos.device != device:
        raise ValueError(f"pos: on {pos.device}, expected {device}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos: dtype {pos.dtype}, expected torch.int32")
    if tuple(pos.shape) != (1,):
        raise ValueError(f"pos: shape {tuple(pos.shape)}, expected (1,)")


def _operands(packed):
    """(the pack's weight operands in the C entry points' order, None for a
    null pointer; their shapes by name; s or None)."""
    n_blocks, d, hidden4 = packed["wih2"].shape
    hidden = hidden4 // 4
    G, H2 = 8 * hidden, 2 * hidden
    shapes = {"i_ln": (n_blocks, 2, d), "wih_f": (n_blocks, d, G),
              "wih_b": (n_blocks, d, G), "whh": (n_blocks, H2, G),
              "b8": (n_blocks, G), "t_ln": (n_blocks, 2, d),
              "wih2": (n_blocks, d, hidden4),
              "whh2": (n_blocks, hidden, hidden4),
              "b2": (n_blocks, hidden4), "proj2_w": (n_blocks, hidden, d),
              "proj2_b": (n_blocks, d)}
    s = lstm_down(packed)
    if s is None:
        shapes.update(proj_w=(n_blocks, H2, d), proj_b=(n_blocks, d))
        return [packed[k] for k in _WEIGHTS] + [None] * 3, shapes, None
    if s < 1:
        raise ValueError(f"down_cat: shape {tuple(packed['down_cat'].shape)}"
                         ", expected [B, C, s*C] with s >= 1")
    shapes.update(down_cat=(n_blocks, d, s * d), down_b=(n_blocks, d),
                  alpha=(n_blocks, 1), up_flat=(n_blocks, H2, s * d),
                  up_b=(n_blocks, d))
    weights = [packed[_UP.get(k, k)] for k in _WEIGHTS + _DOWN]
    return weights, shapes, s


def _attn_shapes(n_blocks, f_len, d, heads, e_dim):
    vd = d // heads
    shapes = {}
    for tag, width in (("q", e_dim), ("k", e_dim), ("v", vd)):
        shapes.update({f"{tag}_w": (n_blocks, d, heads * width),
                       f"{tag}_b": (n_blocks, heads * width),
                       f"{tag}_a": (n_blocks, 1),
                       f"{tag}_ln": (n_blocks, 2, f_len, width)})
    shapes.update(o_w=(n_blocks, d, d), o_b=(n_blocks, d), o_a=(n_blocks, 1),
                  o_ln=(n_blocks, 2, f_len, d))
    return shapes


def check_packed(packed, device, packed_attn=None, heads=None):
    """Check the kernel's weight operands once: on `device`, float32,
    contiguous, of the shapes `pack_stack_params` (and `pack_attn_params`
    for `heads` heads) give. The wrappers run this at every call unless the
    caller passes `checked=True`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _, shapes, _ = _operands(packed)
    for k, shape in shapes.items():
        _check(k, packed[k], shape, device)
    if packed_attn is not None:
        n_blocks, d, _ = packed["wih2"].shape
        _, f_len, e_dim = packed_attn["q_ln"].shape[1:]
        if heads is None or heads < 1 or d % heads:
            raise ValueError(f"heads={heads}: must divide D={d}")
        shapes = _attn_shapes(n_blocks, f_len, d, heads, e_dim)
        for k in _ATTN:
            _check(k, packed_attn[k], shapes[k], device)


_fits = {}   # (device, H, attention, conv, smem) -> clusters the card holds


def _cluster_fits(lib, dev, hidden, attn, conv, smem):
    """Raise unless the card holds one cluster of the stack kernel at once
    (its eight blocks wait on each other at cluster barriers; the hardware
    schedules a cluster's blocks together, so one that fits cannot wait on
    a block that is not resident). Asked once a shape."""
    key = (dev, hidden, attn, conv, smem)
    if key not in _fits:
        with torch.cuda.device(dev):
            _fits[key] = lib.sbt_stack_walk_clusters(hidden, int(attn),
                                                     int(conv), smem)
    if _fits[key] < 1:
        raise RuntimeError(
            f"a cluster of {CLUSTER} blocks of {4 * hidden} threads with "
            f"{smem} B of shared memory each does not fit this card "
            f"(cudaOccupancyMaxActiveClusters: {_fits[key]})")


def _launch(packed, x, h0, c0, film_w, film_b, eps, checked, attn=None):
    dev = x.device
    weights, _, s = _operands(packed)
    n_blocks, d, hidden4 = packed["wih2"].shape
    hidden = hidden4 // 4
    f_len = x.shape[0]
    heads = e_dim = window = 0
    if attn is not None:
        packed_attn, k_ring, v_ring, pos, heads = attn
        if heads < 1 or d % heads or k_ring.dim() != 4 or \
                k_ring.shape[1] % heads:
            raise ValueError(f"heads={heads}: must divide D={d} and "
                             "k_ring's L*E planes")
        e_dim = k_ring.shape[1] // heads
        window = k_ring.shape[2]
    plan = walk_plan(f_len, d, hidden, n_blocks,
                     None if attn is None else (heads, e_dim, window), s)
    _check("x", x, (f_len, d), dev)
    _check("h0", h0, (n_blocks, f_len, hidden), dev)
    _check("c0", c0, (n_blocks, f_len, hidden), dev)
    if attn is not None:
        _check("k_ring", k_ring, (n_blocks, heads * e_dim, window, f_len),
               dev)
        _check("v_ring", v_ring, (n_blocks, d, window, f_len), dev)
    if not checked:
        check_packed(packed, dev, *(() if attn is None
                                    else (packed_attn, heads)))
    use_film = film_w is not None
    if use_film:
        film_shape = (n_blocks - 1, f_len, d)
        _check("film_w", film_w, film_shape, dev)
        _check("film_b", film_b, film_shape, dev)
    # the row phases' weights go to shared memory in 16-byte pieces
    staged = [(k, packed[k]) for k in ("proj_w", "up_flat", "down_cat",
                                       "wih2", "proj2_w") if k in packed]
    if attn is not None:
        staged += [(k, packed_attn[k]) for k in ("q_w", "k_w", "v_w", "o_w")]
    for k, t in staged:
        if t.data_ptr() % 16:
            raise ValueError(f"{k}: not aligned to 16 bytes")

    lib = _build.load_library()
    _cluster_fits(lib, dev, hidden, attn is not None, s is not None,
                  plan["smem"])
    x_out = torch.empty_like(x)
    h0_out = torch.empty_like(h0)
    c0_out = torch.empty_like(c0)
    scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=dev)
    entry, counter = "sbt_stack_walk", "launches"
    attn_ptrs, attn_dims = (), ()
    if attn is not None:
        entry, counter = "sbt_stack_walk_attn", "attn_launches"
        attn_ptrs = (*[packed_attn[k].data_ptr() for k in _ATTN],
                     k_ring.data_ptr(), v_ring.data_ptr(), pos.data_ptr())
        attn_dims = (heads, e_dim, window)
    if s is not None:
        counter = "conv_" + counter
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(),
            film_w.data_ptr() if use_film else None,
            film_b.data_ptr() if use_film else None,
            *[None if t is None else t.data_ptr() for t in weights],
            *attn_ptrs, h0.data_ptr(), c0.data_ptr(), x_out.data_ptr(),
            h0_out.data_ptr(), c0_out.data_ptr(), scratch.data_ptr(),
            n_blocks, f_len, d, hidden, s or 0, *attn_dims, int(use_film),
            plan["scratch"], float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    setattr(gridnet_stack_step, counter,
            getattr(gridnet_stack_step, counter) + 1)
    if attn is None:
        return x_out, h0_out, c0_out
    return x_out, h0_out, c0_out, k_ring, v_ring


def gridnet_stack_step(packed, x, h0, c0, film_w=None, film_b=None,
                       eps: float = 1e-5, checked: bool = False):
    """One streaming step of the full block stack.

    x: [F, D] post-conv features for the current chunk; h0/c0: [B, F, H]
    inter-LSTM state; film_w/film_b: [B-1, F, D] precomputed FiLM affines
    (None for unconditional models). Returns (x_out [F, D], h0', c0').

    CUDA tensors launch `stack_walk_kernel<H, false, false>`, one cluster
    a call (`gridnet_stack_step.launches` counts its launches), or
    `stack_walk_kernel<H, false, true>` for a conv_lstm pack
    (`gridnet_stack_step.conv_launches`); CPU tensors run
    `gridnet_stack_step_ref`. `checked=True` skips the weight checks for a
    `packed` that already passed `check_packed` on this device."""
    if x.device.type == "cuda":
        return _launch(packed, x, h0, c0, film_w, film_b, eps, checked)
    if x.device.type == "cpu":
        return gridnet_stack_step_ref(packed, x, h0, c0, film_w, film_b, eps)
    raise ValueError(f"gridnet_stack_step: unsupported device {x.device}")


def gridnet_stack_step_attn(packed, packed_attn, x, h0, c0, k_ring, v_ring,
                            pos, heads, film_w=None, film_b=None,
                            eps: float = 1e-5, checked: bool = False):
    """One streaming step of the full block stack with local causal
    attention after each block's inter step (use_attn=True nets).

    x, h0, c0, film_w, film_b as for `gridnet_stack_step`; packed_attn from
    `pack_attn_params`; k_ring [B, L*E, W, F] / v_ring [B, D, W, F]: the
    K/V rings as per-(head, channel) planes over W slots; pos: the slot this
    frame's k, v go to, an int32 tensor of shape [1] on x's device (JAX's
    SMEM operand; the caller advances it there as (pos + 1) % W, so a
    captured step replays with the slot of its turn); heads: cfg.L. The
    rings are updated IN PLACE and returned: (x_out, h0', c0', k_ring,
    v_ring). The slot written is pos mod W, in [0, W) for any pos: the
    kernel reads pos when it runs and takes it modulo W before it writes
    (no host check of its value, which would need a sync), and the plain
    version does the same.

    CUDA tensors launch `stack_walk_kernel<H, true, false>`, one cluster a
    call (`gridnet_stack_step.attn_launches`), or `stack_walk_kernel<H,
    true, true>` for a conv_lstm pack
    (`gridnet_stack_step.conv_attn_launches`); CPU
    tensors run `gridnet_stack_step_attn_ref`. `checked=True` skips the
    weight checks for packs that already passed `check_packed` on this
    device."""
    _check_pos(pos, x.device)
    attn = (packed_attn, k_ring, v_ring, pos, int(heads))
    if x.device.type == "cuda":
        return _launch(packed, x, h0, c0, film_w, film_b, eps, checked, attn)
    if x.device.type == "cpu":
        return gridnet_stack_step_attn_ref(packed, packed_attn, x, h0, c0,
                                           k_ring, v_ring, pos, heads,
                                           film_w, film_b, eps)
    raise ValueError(
        f"gridnet_stack_step_attn: unsupported device {x.device}")


gridnet_stack_step.launches = 0
gridnet_stack_step.conv_launches = 0
gridnet_stack_step.attn_launches = 0
gridnet_stack_step.conv_attn_launches = 0
