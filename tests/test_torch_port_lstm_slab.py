"""The port's slab LSTM scans against the JAX package's.

- `lstm_slab_fwd_ref` / `lstm_slab_bwd_ref` (the plain versions of the CUDA
  kernels) against the Pallas `lstm_slab_fwd` / `lstm_slab_bwd` run with
  `interpret=True`, both directions, T in {16, 13, 5} (K | T, K does not
  divide T, T < K for K = 8), R = 11 (not a multiple of the CUDA row tile,
  8), fp32: tolerance 1e-5 absolute (the same math in another summation
  order);
- the `torch.autograd.Function` `lstm_slab` through `ops.rnn.lstm` / `blstm`
  against `jax.grad` of `sound_bubble_tpu.ops.rnn.lstm` / `blstm`, as
  `tests/test_lstm_slab.py` holds the JAX slab kernels: 2e-5.
Inputs are drawn with numpy from a seed and handed to both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sound_bubble_tpu.ops.rnn as jrnn
from sound_bubble_tpu.ops.pallas import lstm_train_slab as jslab
from sound_bubble_tpu_torch.ops import rnn as trnn
from sound_bubble_tpu_torch.ops.kernels import lstm_slab as tslab
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
C, H, R = 5, 4, 11


def _draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _case(t_len, seed=3):
    rng = np.random.default_rng(seed)
    return dict(w_ih=_draw(rng, C, 4 * H, scale=0.3),
                w_hh=_draw(rng, H, 4 * H, scale=0.3),
                b=_draw(rng, 4 * H, scale=0.1), x=_draw(rng, t_len, R, C),
                h0=_draw(rng, R, H, scale=0.5), c0=_draw(rng, R, H, scale=0.5),
                dy=_draw(rng, t_len, R, H), dhT=_draw(rng, R, H),
                dcT=_draw(rng, R, H))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, name, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t_len", [16, 13, 5])
def test_fwd_and_bwd_plain_match_pallas(t_len, reverse):
    a = _case(t_len)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = jslab.lstm_slab_fwd(j["w_ih"], j["w_hh"], j["b"], j["x"], j["h0"],
                               j["c0"], reverse, interpret=True)
    got = tslab.lstm_slab_fwd_ref(_t(a["w_ih"]), _t(a["w_hh"]), _t(a["b"]),
                                  _t(a["x"]), _t(a["h0"]), _t(a["c0"]),
                                  reverse)
    for g, w, name in zip(got, want, ("ys", "hT", "cT", "c_ckpt")):
        _close(g, w, name)

    ys = want[0]
    hp = jslab._shift_prev(ys, j["h0"], reverse, jnp.float32)
    want_b = jslab.lstm_slab_bwd(j["w_ih"], j["w_hh"], j["b"], j["x"], hp,
                                 want[3], j["dy"], j["dhT"], j["dcT"],
                                 reverse, interpret=True)
    got_b = tslab.lstm_slab_bwd_ref(
        _t(a["w_ih"]), _t(a["w_hh"]), _t(a["b"]), _t(a["x"]),
        tslab.shift_prev(_t(np.asarray(ys)), _t(a["h0"]), reverse),
        _t(np.asarray(want[3])), _t(a["dy"]), _t(a["dhT"]), _t(a["dcT"]),
        reverse)
    for g, w, name in zip(got_b, want_b,
                          ("dx", "dw_ih", "dw_hh", "db", "dh0", "dc0")):
        _close(g, w, name)


def test_slab_shape_helpers():
    assert tslab.n_slabs(145) == (8, 19)
    assert tslab.n_slabs(313) == (8, 40)
    assert tslab.n_slabs(5) == (5, 1)


def _params(rng, c, h):
    return {"w_ih": _draw(rng, c, 4 * h, scale=0.3),
            "w_hh": _draw(rng, h, 4 * h, scale=0.3),
            "b": _draw(rng, 4 * h, scale=0.1)}


# (code, R) of the training paths: fp32 (train_pt, batch 4: intra 1252,
# inter 580; the ragged 37), the bf16 recipe (train_stream, batch 8: intra
# 2504, inter 1160) and train_pt --bf16 (bf16 x, fp32 weights, batch 4)
ONE_WAVE = [(0, 37), (0, 580), (0, 1160), (0, 1252), (1, 37), (1, 580),
            (1, 1160), (1, 1252), (1, 2504), (2, 37), (2, 580), (2, 1160),
            (2, 1252)]


@pytest.mark.parametrize("code,r", ONE_WAVE)
def test_bwd_row_tiles_fit_one_wave(code, r):
    """The backward's row tiles: the grid fits one wave of the H100's 132
    SMs (one block an SM), covers every row once, leaves no block empty and
    fits the block's shared memory, at the flagship width (C=32, H=64) and
    the edge widths (C=24, 16)."""
    for c_in in (32, 24, 16):
        rows, blocks = tslab.bwd_row_tiles(r, c_in, 64, code)
        assert blocks <= 132
        assert rows * blocks >= r > rows * (blocks - 1)
        assert tslab.bwd_smem(c_in, 64, rows, code) <= tslab.SMEM_LIMIT_BYTES
        assert 1 <= rows <= tslab.BWD_ROWS_MAX


def test_bwd_row_tiles_past_the_budget():
    """Where one wave's tile would not fit the shared memory (fp32 and
    (bf16, fp32) at R = 2504) the helper takes the largest tile that does,
    and the grid spills into a second wave."""
    for code in (0, 2):
        rows, blocks = tslab.bwd_row_tiles(2504, 32, 64, code)
        assert tslab.bwd_smem(32, 64, rows, code) <= tslab.SMEM_LIMIT_BYTES
        assert tslab.bwd_smem(32, 64, rows + 1, code) > \
            tslab.SMEM_LIMIT_BYTES
        assert 132 < blocks <= 264 and rows * blocks >= 2504


# R of the fp32 forwards' paths: train_pt at batch 4 (intra 1252, inter 580)
# and 8 (2504, 1160), and the ragged 37; (rows, blocks) pinned for C = 32
FWD_ONE_WAVE = {37: (1, 37), 580: (5, 116), 1160: (9, 129), 1252: (10, 126),
                2504: (19, 132)}


@pytest.mark.parametrize("r", list(FWD_ONE_WAVE))
def test_fwd_row_tiles_fit_one_wave(r):
    """The fp32 forwards' row tiles (rows 6a, 10a): the fewest rows that fit
    the grid in one wave of the H100's 132 SMs, covering every row once
    with no block empty, within the block's shared memory, at the flagship
    width (C=32, H=64) and the edge widths (C=24, 16)."""
    for c_in in (32, 24, 16):
        rows, blocks = tslab.fwd_row_tiles(r, c_in, 64)
        assert rows == -(-r // 132) and blocks <= 132
        assert rows * blocks >= r > rows * (blocks - 1)
        assert tslab.fwd_smem(c_in, 64, rows) <= tslab.SMEM_LIMIT_BYTES
    assert tslab.fwd_row_tiles(r, 32, 64) == FWD_ONE_WAVE[r]


def test_fwd_row_tiles_past_the_budget():
    """Where one wave's tile would not fit the shared memory (C = 64 at
    R = 2504) the helper takes the largest tile that does and the grid
    spills into a second wave; past FWD_ROWS_MAX rows it stops there."""
    rows, blocks = tslab.fwd_row_tiles(2504, 64, 64)
    assert tslab.fwd_smem(64, 64, rows) <= tslab.SMEM_LIMIT_BYTES < \
        tslab.fwd_smem(64, 64, rows + 1)
    assert 132 < blocks <= 264 and rows * blocks >= 2504
    rows, blocks = tslab.fwd_row_tiles(10 ** 5, 8, 8)
    assert rows == tslab.FWD_ROWS_MAX and rows * blocks >= 10 ** 5


# the mixed forward (row 10b, the walk's mixed mode) at the same R: the
# bf16 recipe's batch 8 (intra 2504, inter 1160) and train_pt --bf16's
# batch 4 (1252, 580); (rows, blocks) pinned for C = 32, and the block's
# shared memory at the recipe's 19 rows: bf16 weights (the tensor cores'
# transposed W_ih, rows of 40) and fp32 weights (gate-interleaved)
MIXED_FWD_SMEM_19 = {1: 210432, 2: 220288}


@pytest.mark.parametrize("code", [1, 2])
def test_mixed_fwd_row_tiles_fit_one_wave(code):
    """Row 10b's row tiles for both mixed pairs: one wave of the H100's 132
    SMs at every training R, C = 32, 24, 16, within the block's shared
    memory; the layout's bytes at 19 rows."""
    for r, want in FWD_ONE_WAVE.items():
        for c_in in (32, 24, 16):
            rows, blocks = tslab.fwd_row_tiles(r, c_in, 64, code=code)
            assert rows == -(-r // 132) and blocks <= 132
            assert rows * blocks >= r > rows * (blocks - 1)
            assert tslab.fwd_smem(c_in, 64, rows, code) <= \
                tslab.SMEM_LIMIT_BYTES
        assert tslab.fwd_row_tiles(r, 32, 64, code=code) == want
    assert tslab.fwd_smem(32, 64, 19, code) == MIXED_FWD_SMEM_19[code]
    # the x tile is bf16: half the fp32 layout's bytes of it at C = 32
    assert tslab.fwd_smem(32, 64, 19, 2) == tslab.fwd_smem(32, 64, 19) - \
        2 * 8 * 19 * 32


def test_mixed_fwd_limits():
    """What the mixed forwards refuse before any launch: H outside 8-64, C
    not a multiple of 8 (bf16 x in 16-byte pieces), C past the tensor
    cores' projection with bf16 weights (fp32 weights take it)."""
    bf = torch.bfloat16
    for shape, hidden, code, match in (((3, 5, 32), 48, 1, "H=48"),
                                       ((3, 5, 12), 64, 2, "C=12"),
                                       ((3, 5, 72), 64, 1, "C=72")):
        with pytest.raises(ValueError, match=match):
            tslab._check_fwd_dims(torch.zeros(shape, dtype=bf), hidden,
                                    code)
    assert tslab._check_fwd_dims(torch.zeros(3, 5, 72, dtype=bf), 64,
                                   2) == (3, 5, 72, 64)
    assert tslab._check_fwd_dims(torch.zeros(3, 5, 8, dtype=bf), 8,
                                   1) == (3, 5, 8, 8)


@pytest.mark.parametrize("t_len", [16, 13])
def test_autograd_through_lstm_and_blstm_matches_jax_grad(t_len):
    """ops.rnn.lstm (with carried state) and blstm through the autograd
    Function, against jax.grad of the JAX package's lstm / blstm."""
    rng = np.random.default_rng(11)
    bp = {"fwd": _params(rng, C, H), "bwd": _params(rng, C, H)}
    lp = _params(rng, C, H)
    x = _draw(rng, 2, 3, t_len, C)
    h0, c0 = _draw(rng, 2, 3, H, scale=0.5), _draw(rng, 2, 3, H, scale=0.5)
    wy = _draw(rng, 2, 3, t_len, 2 * H)
    wl = _draw(rng, 2, 3, t_len, H)
    ws = _draw(rng, 2, 3, H)

    def jloss(bp, lp, x, h0, c0):
        y = jrnn.blstm(bp, x)
        yl, (hT, cT) = jrnn.lstm(lp, x, h0, c0)
        return (jnp.sum(y * wy) + jnp.sum(yl * wl) + jnp.sum(hT * ws)
                + 0.5 * jnp.sum(cT * ws))

    jargs = jax.tree_util.tree_map(jnp.asarray, (bp, lp, x, h0, c0))
    want_loss = jloss(*jargs)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)

    tb = {d: {k: _t(v).requires_grad_() for k, v in p.items()}
          for d, p in bp.items()}
    tl = {k: _t(v).requires_grad_() for k, v in lp.items()}
    tx, th, tc = (_t(v).requires_grad_() for v in (x, h0, c0))
    y = trnn.blstm(tb, tx)
    yl, (hT, cT) = trnn.lstm(tl, tx, th, tc)
    loss = ((y * _t(wy)).sum() + (yl * _t(wl)).sum() + (hT * _t(ws)).sum()
            + 0.5 * (cT * _t(ws)).sum())
    loss.backward()
    _close(loss.detach().numpy(), want_loss, "loss")
    got = ({d: {k: v.grad for k, v in p.items()} for d, p in tb.items()},
           {k: v.grad for k, v in tl.items()}, tx.grad, th.grad, tc.grad)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        _close(g.numpy(), w, "grad", tol=2e-5)
