"""The custom-VJP kernel route (`ops/kernels/lstm_train_kernel.py`,
`scan="seq"` in `ops/rnn.py`) against the JAX package's
`ops/pallas/lstm_train_kernel.py`, on the CPU.

- each plain version (rows 6-9 of PERF.md's kernel table) against its
  Pallas kernel in interpret mode: `lstm_seq_fwd`, `lstm_seq_bwd`,
  `_blstm_fwd` and the walk inside `_bpt_bwd` (its `pallas_call` output,
  read through a wrapper), at T = 6, R = 19 (ragged against both row tiles)
  and C = H = 8;
- both autograd Functions, outputs and every gradient, against `jax.grad`
  of `lstm_pallas_train` / `blstm_pallas_train`;
- in float32 to 1e-5 of each output's peak, and with (x, weights) in
  (bf16, bf16) and (bf16, fp32) to one bf16 ulp of the peak (2^-8): the two
  round at the same points, so they agree bit for bit but for sums taken in
  another order;
- the bar that holds the mixed kernels to their plain versions on the card
  (at most 5% of the bf16 elements differing) catches the mixed slab
  kernels' rounding of the sigmoid and a dropped rounding of tanh(c);
- a small `Net` (B=2, D=8, H=8, plain and conv_lstm intra) on
  `lstm_scan="seq"`, loss and every gradient, against the JAX net with
  `set_fused_scan(False)` and `set_pallas_train(True)` (restored after),
  counting the calls of the JAX kernels' wrappers so that the reference is
  known to have gone through them (JAX's own tests of `set_pallas_train`
  leave the fused scan on, which `lstm()` / `blstm()` take first);
- the NotImplementedError cases, the CLIs' `--lstm_scan` default from the
  JAX package's environment switches, and the resume guard.

The JAX side of a bf16 case is compiled with `xla_allow_excess_precision`
off, so that XLA keeps every bf16 rounding the Pallas body writes."""
import contextlib
import json
import os

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sound_bubble_tpu.ops.rnn as jrnn
from sound_bubble_tpu.models.tfgridnet.model import make_net
from sound_bubble_tpu.ops.pallas import lstm_train_kernel as jk
from sound_bubble_tpu_torch import train_pt, train_stream
from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config
from sound_bubble_tpu_torch.ops import rnn as trnn
from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as tk
from sound_bubble_tpu_torch.ops.kernels.lstm_slab import sigmoid_q
from sound_bubble_tpu_torch.weights import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "syn_experiments", "pretrain_stage.json")
T, R, C, H = 6, 19, 8, 8
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
NET_TOL = 1e-5
EXACT = {"xla_allow_excess_precision": False}
PAIRS = {"fp32": (jnp.float32, jnp.float32),
         "bf16": (jnp.bfloat16, jnp.bfloat16),
         "bf16_fp32w": (jnp.bfloat16, jnp.float32)}
SMALL = dict(stft_chunk_size=32, stft_pad_size=16, D=8, B=2, H=8)


def _jit(f, *args):
    """f compiled by XLA with every bf16 rounding kept, called on args."""
    return jax.jit(f).lower(*args).compile(compiler_options=EXACT)(*args)


def _to_torch(a):
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, name, tol):
    assert (got.dtype == torch.bfloat16) == (jnp.asarray(want).dtype
                                             == jnp.bfloat16), name
    err = _rel(got, want)
    assert err <= tol, (name, err)


def _case(pair, seed=0):
    """Operands of both recurrences in the pair's dtypes, as JAX arrays."""
    xdt, wdt = PAIRS[pair]
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0, dt=jnp.float32):
        return jnp.asarray((rng.standard_normal(shape) * scale).astype(
            np.float32)).astype(dt)

    def params():
        return {"w_ih": draw(C, 4 * H, scale=0.3, dt=wdt),
                "w_hh": draw(H, 4 * H, scale=0.3, dt=wdt),
                "b": draw(4 * H, scale=0.1, dt=wdt)}

    return dict(fwd=params(), bwd=params(), x=draw(T, R, C, dt=xdt),
                h0=draw(R, H, scale=0.5), c0=draw(R, H, scale=0.5),
                dy=draw(T, R, H, dt=xdt), dhT=draw(R, H), dcT=draw(R, H),
                dy2=draw(T, R, 2 * H, dt=xdt))


def _tparams(p, grad=False):
    return {k: _to_torch(v).requires_grad_(grad) for k, v in p.items()}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_versions_match_pallas(pair, monkeypatch):
    j = _case(pair)
    tol = F32_TOL if pair == "fp32" else BF16_TOL
    xdt = j["x"].dtype
    p = j["fwd"]
    # row 6
    want = _jit(lambda p, x, h0, c0: jk.lstm_seq_fwd(
        p["w_ih"], p["w_hh"], p["b"], x, h0, c0, interpret=True),
        p, j["x"], j["h0"], j["c0"])
    tp = _tparams(p)
    got = tk.lstm_seq_fwd_ref(tp["w_ih"], tp["w_hh"], tp["b"],
                              _to_torch(j["x"]), _to_torch(j["h0"]),
                              _to_torch(j["c0"]))
    for g, w, name in zip(got, want, ("y", "gates", "c")):
        _close(g, w, f"row 6 {name}", tol)
    # row 7, on the Pallas forward's residuals
    bargs = (want[1], want[2], j["c0"], j["dy"], j["dhT"], j["dcT"],
             p["w_hh"])
    want_b = _jit(lambda *a: jk.lstm_seq_bwd(*a, xdt, interpret=True),
                  *bargs)
    got_b = tk.lstm_seq_bwd_ref(*(_to_torch(a) for a in bargs),
                                _to_torch(j["x"]).dtype)
    for g, w, name in zip(got_b, want_b, ("dgates", "dh0", "dc0")):
        _close(g, w, f"row 7 {name}", tol)
    # row 8
    want = _jit(lambda f, b, x: jk._blstm_fwd(f, b, x, interpret=True),
                j["fwd"], j["bwd"], j["x"])
    pack = tk._blstm_pack(_tparams(j["fwd"]), _tparams(j["bwd"]))
    got = tk.blstm_seq_fwd_ref(*pack, _to_torch(j["x"]))
    _close(got[0], jnp.concatenate(want[:2], axis=-1), "row 8 y", tol)
    _close(got[1], want[2], "row 8 gates", tol)
    _close(got[2], want[3], "row 8 c", tol)

    # row 9: the walk's output, read from the pallas_call inside _bpt_bwd
    pallas_call = jpl.pallas_call

    def bpt_walk(res, dy):
        seen = []

        def recording(*a, **k):
            call = pallas_call(*a, **k)
            return lambda *args: seen.append(call(*args)) or seen[-1]

        monkeypatch.setattr(jpl, "pallas_call", recording)
        jk._bpt_bwd(res, dy, interpret=True)
        monkeypatch.setattr(jpl, "pallas_call", pallas_call)
        (dg,) = seen
        return dg[:, :R]

    res = (j["fwd"], j["bwd"], j["x"], *want)
    want_dg = _jit(bpt_walk, res, j["dy2"])
    got_dg = tk.blstm_seq_bwd_ref(pack[2], _to_torch(want[2]),
                                  _to_torch(want[3]), _to_torch(j["dy2"]),
                                  _to_torch(j["x"]).dtype)
    _close(got_dg, want_dg, "row 9 dgates", tol)


# the card's bar on the mixed kernels' bf16 outputs (chip_smoke.py's
# SEQ_MIXED_SHARE): the share of elements that may differ from the plain
# versions'
MIXED_SHARE = 0.05


@pytest.mark.parametrize("pair", ["bf16", "bf16_fp32w"])
def test_mixed_share_bar_catches_the_slab_rounding(pair, monkeypatch):
    """The share bar against the Pallas kernels of rows 6 and 7: the plain
    versions pass it, and the same with each sigmoid rounded once (as the
    mixed slab kernels round it) or with tanh(c) left in float32 in the
    backward walk fail it."""
    j = _case(pair, seed=2)
    p, xdt = j["fwd"], j["x"].dtype
    want = _jit(lambda p, x, h0, c0: jk.lstm_seq_fwd(
        p["w_ih"], p["w_hh"], p["b"], x, h0, c0, interpret=True),
        p, j["x"], j["h0"], j["c0"])
    bargs = (want[1], want[2], j["c0"], j["dy"], j["dhT"], j["dcT"],
             p["w_hh"])
    want_dg = _jit(lambda *a: jk.lstm_seq_bwd(*a, xdt, interpret=True),
                   *bargs)[0]
    tp = _tparams(p)
    fargs = (tp["w_ih"], tp["w_hh"], tp["b"],
             *(_to_torch(j[k]) for k in ("x", "h0", "c0")))

    def shares():
        """Shares of y, gates and dgates that differ from the kernels'."""
        y, gates, _ = tk.lstm_seq_fwd_ref(*fargs)
        dg = tk.lstm_seq_bwd_ref(*(_to_torch(a) for a in bargs),
                                 torch.bfloat16)[0]
        return [float((g != _to_torch(w)).float().mean())
                for g, w in ((y, want[0]), (gates, want[1]), (dg, want_dg))]

    assert max(shares()) <= MIXED_SHARE
    monkeypatch.setattr(tk, "sigmoid_x", sigmoid_q)
    assert max(shares()[:2]) > MIXED_SHARE
    monkeypatch.undo()
    monkeypatch.setattr(tk, "tanh_q", lambda v: torch.tanh(v.float()))
    assert shares()[2] > MIXED_SHARE


@pytest.mark.parametrize("pair", list(PAIRS))
def test_functions_match_jax_grad(pair):
    """`lstm_seq` and `blstm_seq` (plain versions on the CPU) against
    `jax.value_and_grad` of `lstm_pallas_train` / `blstm_pallas_train`:
    outputs and the gradients of every input."""
    j = _case(pair, seed=1)
    tol = F32_TOL if pair == "fp32" else BF16_TOL
    rng = np.random.default_rng(2)
    wy, ws, wc, wb = (rng.standard_normal(s).astype(np.float32) for s in
                      ((T, R, H), (R, H), (R, H), (T, R, 2 * H)))

    def loss(fwd, bwd, x, h0, c0):
        y, hT, cT = jk.lstm_pallas_train(fwd["w_ih"], fwd["w_hh"], fwd["b"],
                                         x, h0, c0)
        yb = jk.blstm_pallas_train(fwd, bwd, x)
        outs = (y, hT, cT, yb)
        return sum(jnp.sum(o.astype(jnp.float32) * w)
                   for o, w in zip(outs, (wy, ws, wc, wb))), outs

    jargs = (j["fwd"], j["bwd"], j["x"], j["h0"], j["c0"])
    (_, want), want_g = _jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True), *jargs)

    fwd, bwd = _tparams(j["fwd"], True), _tparams(j["bwd"], True)
    x, h0, c0 = (_to_torch(j[k]).requires_grad_() for k in ("x", "h0", "c0"))
    y, hT, cT = tk.lstm_seq(fwd["w_ih"], fwd["w_hh"], fwd["b"], x, h0, c0)
    yb = tk.blstm_seq(fwd, bwd, x)
    got = (y, hT, cT, yb)
    sum((o.float() * torch.from_numpy(w)).sum()
        for o, w in zip(got, (wy, ws, wc, wb))).backward()
    for g, w, name in zip(got, want, ("y", "hT", "cT", "y_blstm")):
        _close(g, w, name, tol)
    got_g = ({k: v.grad for k, v in fwd.items()},
             {k: v.grad for k, v in bwd.items()}, x.grad, h0.grad, c0.grad)
    for path, w in jax.tree_util.tree_leaves_with_path(want_g):
        g = got_g[path[0].idx]
        for key in path[1:]:
            g = g[key.key]
        _close(g, w, jax.tree_util.keystr(path), tol)


@contextlib.contextmanager
def _jax_seq_route(monkeypatch):
    """The JAX package's custom-VJP kernel route (`set_fused_scan(False)`,
    `set_pallas_train(True)`, the bf16-gates default), restored after; the
    calls of its kernels' wrappers are counted."""
    saved = {k: getattr(jrnn, k) for k in (
        "_FUSED_SCAN", "_CUSTOM_VJP", "_PALLAS_TRAIN", "_PALLAS_BLSTM",
        "_BF16_GATES", "_DIR_FUSE")}
    calls = {"lstm_seq_fwd": 0, "lstm_seq_bwd": 0, "_blstm_fwd": 0}
    for name in calls:
        orig = getattr(jk, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(jk, name, counted)
    jrnn.set_fused_scan(False)
    jrnn.set_pallas_train(True)
    jrnn._PALLAS_BLSTM, jrnn._BF16_GATES = False, True
    try:
        yield calls
    finally:
        for k, v in saved.items():
            setattr(jrnn, k, v)


@pytest.mark.parametrize("conv_lstm", [False, True], ids=["plain", "conv"])
def test_net_on_seq_route_matches_jax(conv_lstm, monkeypatch):
    model_params = dict(SMALL, merge_method="early_cat", use_first_ln=True,
                        conv_lstm=conv_lstm, lstm_down=4, dis_type="conv3")
    jnet = make_net(model_params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 32 * 7 + 16)).astype(np.float32) * 0.3
    dis = np.asarray([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    inputs = {"mixture": jnp.asarray(x), "dis_embed": jnp.asarray(dis)}
    params = jax.jit(jnet.init)(jax.random.PRNGKey(4), inputs)["params"]
    w_out = rng.standard_normal((2, 1, x.shape[-1])).astype(np.float32)

    def loss(p):
        return jnp.sum(jnet.apply({"params": p}, inputs)["output"] * w_out)

    with _jax_seq_route(monkeypatch) as calls:
        want, want_g = jax.jit(jax.value_and_grad(loss))(params)
    # traced once a block in the backward, and in the forward once for the
    # primal and once for the custom VJP's forward
    blocks = SMALL["B"]
    assert calls == {"lstm_seq_fwd": 2 * blocks, "lstm_seq_bwd": blocks,
                     "_blstm_fwd": 2 * blocks}, calls

    net = Net(make_config(model_params), lstm_scan="seq")
    net.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    counts = [(f, f.launches) for f in (tk.lstm_seq_fwd, tk.blstm_seq_fwd)]
    out = net({"mixture": torch.from_numpy(x),
               "dis_embed": torch.from_numpy(dis)})["output"]
    loss_t = (out * torch.from_numpy(w_out)).sum()
    loss_t.backward()
    got = float(loss_t.detach())
    # on the CPU the wrappers run the plain versions: no launch
    assert all(f.launches == n for f, n in counts)
    assert abs(got - float(want)) <= NET_TOL * abs(float(want))
    flat = from_jax_params(jax.tree_util.tree_map(np.asarray, want_g))
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert set(grads) == set(flat)
    for k, g in grads.items():
        scale = max(1.0, float(flat[k].abs().max()))
        np.testing.assert_allclose(g.numpy(), flat[k].numpy(),
                                   atol=NET_TOL * scale, rtol=0, err_msg=k)


def test_seq_route_not_implemented_cases():
    j = _case("bf16")
    p = _tparams(j["fwd"])
    x = _to_torch(j["x"]).movedim(0, 1)            # [R, T, C]
    with pytest.raises(NotImplementedError, match="reverse"):
        trnn.lstm({k: v.float() for k, v in p.items()}, x.float(),
                  reverse=True, scan="seq")
    with pytest.raises(NotImplementedError, match="bf16_gates"):
        trnn.lstm(p, x, bf16_gates=False, scan="seq")
    with pytest.raises(NotImplementedError, match="bf16_gates"):
        trnn.blstm({"fwd": p, "bwd": p}, x, bf16_gates=False, scan="seq")
    with pytest.raises(ValueError, match="scan="):
        trnn.blstm({"fwd": p, "bwd": p}, x, scan="fused")
    with pytest.raises(ValueError, match="lstm_scan="):
        Net(make_config(SMALL), lstm_scan="fused")


def test_fp32_forward_rows_and_limits():
    """Row 6a's fp32 kernel takes the slab forward's row tiles (one wave:
    5 rows a block at the inter LSTM's R = 580, 116 blocks; 1 row at the
    ragged 37) and refuses, before any launch, an H, a C or a shared
    memory it does not take."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as tslab

    assert tk.fwd_row_tiles is tslab.fwd_row_tiles
    assert tk.fwd_row_tiles(580, 32, 64) == (5, 116)
    assert tk.fwd_row_tiles(37, 32, 64) == (1, 37)
    for shape, hidden, match in (((3, 5, 32), 48, "H=48"),
                                 ((3, 5, 30), 64, "C=30"),
                                 ((3, 5, 4096), 64, "shared memory")):
        with pytest.raises(ValueError, match=match):
            tk._check_fwd_dims(torch.zeros(shape), hidden)
    assert tk._check_fwd_dims(torch.zeros(3, 5, 24), 64) == (3, 5, 24, 64)


@pytest.mark.parametrize("r", [37, 580, 1252, 2504])
def test_blstm_fwd32_rows(r):
    """Row 8a's fp32 grid: each direction a half of ceil(R / rows) blocks,
    the fewest rows that keep both halves within one wave of the H100's
    132 SMs and the block within its shared memory, at the flagship width
    (C = 32) and the edge widths (C = 24, 16); 19 rows, 132 blocks at the
    intra R = 1252. At R = 2504 (batch 8) one wave does not fit: the
    largest tile that does, two waves."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as tslab

    for c_in in (32, 24, 16):
        rows, blocks = tk.fwd_row_tiles(r, c_in, 64, nd=2)
        half = -(-r // rows)
        assert blocks == 2 * half and rows * half >= r > rows * (half - 1)
        assert tslab.fwd_smem(c_in, 64, rows) <= tslab.SMEM_LIMIT_BYTES
        if r < 2504:
            assert blocks <= 132 and rows == -(-2 * r // 132)
        else:
            assert 132 < blocks <= 264
            assert tslab.fwd_smem(c_in, 64, rows + 1) > \
                tslab.SMEM_LIMIT_BYTES
    if r == 1252:
        assert tk.fwd_row_tiles(r, 32, 64, nd=2) == (19, 132)
        assert tslab.fwd_smem(32, 64, 19) == 230016


@pytest.mark.parametrize("r", [37, 580, 1252, 2504])
def test_blstm_mixed_rows(r):
    """Row 8b's grid (the walk's mixed mode: bf16 gx, 4 frames a slab): each
    direction a half of ceil(R / rows) blocks, both halves in one wave of
    the H100's 132 SMs at every training R, for both mixed pairs and C =
    32, 24, 16; 38 rows a block at the bf16 recipe's R = 2504, where the
    fp32 layout takes two waves of 19."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as tslab

    for code in (1, 2):
        for c_in in (32, 24, 16):
            rows, blocks = tk.fwd_row_tiles(r, c_in, 64, nd=2, code=code,
                                            bseq=True)
            half = -(-r // rows)
            assert blocks == 2 * half <= 132
            assert rows == -(-2 * r // 132)
            assert tslab.fwd_smem(c_in, 64, rows, code, bseq=True) <= \
                tslab.SMEM_LIMIT_BYTES
    if r == 2504:
        assert tk.fwd_row_tiles(r, 32, 64, nd=2, code=1, bseq=True) == \
            (38, 132)
        assert tslab.fwd_smem(32, 64, 38, 1, bseq=True) == 154752
        assert tslab.fwd_smem(32, 64, 38, 2, bseq=True) == 164608
        assert tk.fwd_row_tiles(r, 32, 64, nd=2) == (19, 264)


@pytest.mark.parametrize("r", [37, 580, 1160])
def test_seq_mixed_rows(r):
    """Row 6b's grid (the walk's mixed mode SEQ, row 8b's layout: bf16 gx,
    4 frames a slab): ceil(R / rows) blocks in one wave of the H100's 132
    SMs, for both mixed pairs and C = 32, 24, 16; 9 rows a block, 129
    blocks, at the bf16 recipe's inter R = 1160, where the first design took
    145 blocks of 8."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as tslab

    for code in (1, 2):
        for c_in in (32, 24, 16):
            rows, blocks = tk.fwd_row_tiles(r, c_in, 64, code=code,
                                            bseq=True)
            assert blocks == -(-r // rows) <= 132
            assert rows == -(-r // 132)
            assert tslab.fwd_smem(c_in, 64, rows, code, bseq=True) <= \
                tslab.SMEM_LIMIT_BYTES
    if r == 1160:
        for code in (1, 2):
            assert tk.fwd_row_tiles(r, 32, 64, code=code, bseq=True) == \
                (9, 129)
        assert tslab.fwd_smem(32, 64, 9, 1, bseq=True) == 54464
        assert tslab.fwd_smem(32, 64, 9, 2, bseq=True) == 66176


@pytest.mark.parametrize("r", [37, 580, 1252, 2504])
def test_blstm_bwd_rows(r):
    """Row 9's grid (csrc/lstm_seq_bwd.cu): each direction a half of
    ceil(R / rows) blocks, both halves in one wave of the H100's 132 SMs at
    every training R, in fp32 and both mixed pairs (the backward does not
    see C); 19 rows a block at R = 1252 and 38 at R = 2504, 132 blocks,
    where the first design took 157 and 313 blocks of 8 rows."""
    for code in (0, 1, 2):
        rows, blocks = tk.seq_bwd_row_tiles(r, 64, code)
        assert blocks == 2 * -(-r // rows) <= 132
        assert rows == -(-2 * r // 132)
        assert tk.seq_bwd_smem(64, rows, code) <= tk.SMEM_LIMIT_BYTES
    if r in (1252, 2504):
        want = (19, 132) if r == 1252 else (38, 132)
        assert all(tk.seq_bwd_row_tiles(r, 64, code) == want
                   for code in (0, 1, 2))
        # fp32; bf16 x and weights (the dg tile bf16 for the tensor cores'
        # chain, its rows a multiple of 16); bf16 x with fp32 weights
        assert tk.seq_bwd_smem(64, 19, 0) == 115488
        assert tk.seq_bwd_smem(64, 38, 1) == 149632
        assert tk.seq_bwd_smem(64, 38, 2) == 181120
    if r == 2504:   # on 2 SMs: the most fp32 rows a block's memory takes
        rows = tk.seq_bwd_row_tiles(r, 64, 0, n_sm=2)[0]
        assert rows == 38 and tk.seq_bwd_smem(64, 39, 0) > \
            tk.SMEM_LIMIT_BYTES >= tk.seq_bwd_smem(64, 38, 0)


@pytest.mark.parametrize("r", [37, 580, 1160])
def test_seq_bwd_rows(r):
    """Row 7's grid (the backward walk of csrc/lstm_seq_bwd.cu in one
    direction): ceil(R / rows) blocks in one wave of the H100's 132 SMs, in
    fp32 and both mixed pairs, on row 9's shared-memory formula; 5 rows a
    block at the inter LSTM's R = 580 (116 blocks) and 9 at the bf16
    recipe's R = 1160 (129), where the first design took 73 and 145 blocks
    of 8 rows."""
    for code in (0, 1, 2):
        rows, blocks = tk.seq_bwd_row_tiles(r, 64, code, nd=1)
        assert blocks == -(-r // rows) <= 132
        assert rows == -(-r // 132)
        assert tk.seq_bwd_smem(64, rows, code) <= tk.SMEM_LIMIT_BYTES
    want = {37: (1, 37), 580: (5, 116), 1160: (9, 129)}[r]
    assert all(tk.seq_bwd_row_tiles(r, 64, code, 132, 1) == want
               for code in (0, 1, 2))
    if r == 580:       # fp32: 4H + 8 gate columns, rows rounded up to 4
        assert tk.seq_bwd_smem(64, 5, 0) == 36960
    if r == 1160:      # the tensor cores' chain: rows rounded up to 16
        assert tk.seq_bwd_smem(64, 9, 1) == 41664
        assert tk.seq_bwd_smem(64, 9, 2) == 48960


def test_seq_wrappers_refuse_before_launch():
    """Rows 6, 7 and 9's wrappers raise ValueError for an H, a C or an
    alignment their kernels do not take before they build or launch
    anything (here on CPU tensors, which the kernels never see); row 7's
    Function copies a misaligned c0 or dy instead (`_aligned`)."""
    def operands(t_len, r, c_in, hidden, xdt, wdt):
        rng = np.random.default_rng(0)

        def draw(*shape, dtype=torch.float32):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dtype)

        return (draw(c_in, 4 * hidden, dtype=wdt),
                draw(hidden, 4 * hidden, dtype=wdt),
                draw(4 * hidden, dtype=wdt), draw(t_len, r, c_in, dtype=xdt),
                draw(r, hidden), draw(r, hidden))

    bf, f32 = torch.bfloat16, torch.float32
    before = [(f.launches, f.mixed_launches) for f in
              (tk.lstm_seq_fwd, tk.lstm_seq_bwd, tk.blstm_seq_bwd)]
    for shape, wdt, match in (((3, 5, 32, 48), bf, "H=48"),
                              ((3, 5, 12, 64), f32, "C=12"),
                              ((3, 5, 72, 64), bf, "C=72")):
        w_ih, w_hh, b, x, h0, c0 = operands(*shape, bf, wdt)
        with pytest.raises(ValueError, match=match):
            tk._launch_fwd(tk.lstm_seq_fwd, x, (w_ih,), w_hh, b, h0, c0)
    for hidden, nd, match in ((48, 2, "H=48"), (80, 1, "H=80"),
                              (48, 1, "H=48"), (128, 1, "H=128")):
        t_len, r = 3, 5
        gates = torch.zeros(t_len, r, nd * 4 * hidden)
        c_seq = torch.zeros(t_len, r, nd * hidden)
        w_hh = torch.zeros(nd * hidden, nd * 4 * hidden)
        with pytest.raises(ValueError, match=match):
            tk._launch_bwd(tk.blstm_seq_bwd, nd, gates, c_seq, None,
                           torch.zeros(t_len, r, nd * hidden), None, None,
                           w_hh, f32)
    # row 9 copies its tiles in 16-byte pieces: dy 2 bytes past that
    t_len, r, hidden = 3, 5, 8
    dy = torch.zeros(t_len * r * 2 * hidden + 1, dtype=bf)[1:].view(
        t_len, r, 2 * hidden)
    with pytest.raises(ValueError, match="dy: not aligned"):
        tk._launch_bwd(tk.blstm_seq_bwd, 2,
                       torch.zeros(t_len, r, 8 * hidden, dtype=bf),
                       torch.zeros(t_len, r, 2 * hidden), None, dy, None,
                       None, torch.zeros(2 * hidden, 8 * hidden, dtype=bf),
                       bf)
    # row 7 also copies c0 in 16-byte pieces: c0 4 bytes past that
    t_len, r, hidden = 3, 5, 8
    c0 = torch.zeros(r * hidden + 1)[1:].view(r, hidden)
    z = torch.zeros(r, hidden)
    with pytest.raises(ValueError, match="c0: not aligned"):
        tk._launch_bwd(tk.lstm_seq_bwd, 1,
                       torch.zeros(t_len, r, 4 * hidden),
                       torch.zeros(t_len, r, hidden), c0,
                       torch.zeros(t_len, r, hidden), z, z,
                       torch.zeros(hidden, 4 * hidden), f32)
    assert [(f.launches, f.mixed_launches) for f in
            (tk.lstm_seq_fwd, tk.lstm_seq_bwd, tk.blstm_seq_bwd)] == before
    # what the Functions pass instead: an aligned copy, same values
    got = tk._aligned(c0)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, c0)
    assert tk._aligned(z) is z


def test_bf16_reciprocal_margin():
    """The mixed walk's bf16 sigmoid (row 8b, `sig_m<RND_SEQ>` in
    csrc/lstm_fwd32.cuh) takes 1 / d for a bf16 d >= 1 with `rcp1`, within
    about an fp32 ulp of the IEEE quotient that XLA takes: for each of the
    128 bf16 mantissas every fp32 value within 128 ulps of the quotient
    rounds to the quotient's bf16."""
    q = 1.0 / (1.0 + torch.arange(128, dtype=torch.float32) / 128)
    want, lo, hi = q.bfloat16(), q, q
    for _ in range(128):
        lo = torch.nextafter(lo, torch.zeros_like(lo))
        hi = torch.nextafter(hi, torch.full_like(hi, 2.0))
        assert torch.equal(lo.bfloat16(), want)
        assert torch.equal(hi.bfloat16(), want)


ROUTE_ENV = ("SB_LSTM_FUSED", "SB_LSTM_CUSTOM_VJP", "SB_LSTM_PALLAS_TRAIN")


@pytest.mark.parametrize("env,want", [
    ((None, None, None), "slab"), (("0", "1", "1"), "seq"),
    (("0", "1", None), "slab"), (("1", "1", "1"), "slab"),
    (("0", None, "1"), "slab")])
def test_cli_lstm_scan_follows_the_jax_environment(env, want, monkeypatch):
    for name, value in zip(ROUTE_ENV, env):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    base = ["--config", CONFIG, "--run_dir", "unused"]
    assert train_pt.parse_args(base).lstm_scan == want
    assert train_stream.parse_args(base).lstm_scan == want
    other = "slab" if want == "seq" else "seq"
    assert train_pt.parse_args(base + ["--lstm_scan", other]).lstm_scan \
        == other


def test_resume_on_the_other_route_is_refused(tmp_path):
    run = tmp_path / "run"
    args = train_pt.parse_args(["--config", CONFIG, "--run_dir", str(run),
                                "--lstm_scan", "seq"])
    train_pt.check_route(args)
    with open(run / train_pt.ARGS_FILE) as f:
        assert json.load(f) == {"lstm_scan": "seq"}
    (run / "checkpoints").mkdir()
    (run / "checkpoints" / "last.pt").write_bytes(b"")
    train_pt.check_route(args)                  # the same route resumes
    args.lstm_scan = "slab"
    with pytest.raises(SystemExit, match="refused"):
        train_pt.check_route(args)

    stream_run = tmp_path / "stream"
    stream_run.mkdir()
    with open(stream_run / "train_stream_args.json", "w") as f:
        json.dump({"bf16": True, "bg_noise": 0.0}, f)  # recorded before
    with pytest.raises(SystemExit, match="--lstm_scan slab"):
        train_stream.main(train_stream.parse_args(
            ["--config", CONFIG, "--run_dir", str(stream_run), "--resume",
             "--lstm_scan", "seq", "--device", "cpu"]))
