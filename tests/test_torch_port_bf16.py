"""The port's bf16 mixed precision against the JAX package's, on the CPU.

- the plain mixed slab scans `lstm_slab_fwd_ref` / `lstm_slab_bwd_ref`
  against the Pallas `lstm_slab_fwd` / `lstm_slab_bwd` in interpret mode,
  both directions at a ragged T (13 frames, K = 8), R = 11, with (x,
  weights) in (bf16, bf16) (`cast_bf16`, `train_stream --bf16`) and (bf16,
  fp32) (`train_pt --bf16`): ys within one bf16 ulp of its peak (max-abs
  <= 2^-8 * peak), every other output within 1e-2 of its peak;
- `ops.rnn.lstm` (carried state) and `blstm` with bf16 activations and bf16
  params, forward and gradients through the autograd Function, against
  `jax.grad` of the JAX package's `rnn.lstm` / `blstm` (its XLA fused scan
  on the CPU: the same roundings, the gates summed in another order), and
  the T == 1 streaming cell: 1e-2 of each output's peak;
- the bf16 model (`compute_dtype="bf16"`, B=2, D=8, H=8) against the JAX
  `Net` on the same weights, under both recipes (float32 params, and params
  through `cast_bf16`): 3e-2 of the output's peak;
- one bf16 train step on the first 0.1 s of the golden batch, the loss to
  1e-2 relative and the global gradient norm to 3e-2: `train_pt --bf16`
  (`PLModule.set_bf16_trunk`, float32 params) and the campaign trainer's
  `train_step` (params through `cast_bf16`), against `jax.value_and_grad`
  of the same loss;
- `utils.cast_bf16` on the port's params and on the JAX tree give the same
  bf16 arrays, bit for bit.

The JAX side is compiled with XLA's `xla_allow_excess_precision` off: with
it on, XLA on the CPU may skip the bf16 rounding of an `astype` inside a
fusion, which the Pallas kernel (and the port) do round. Inputs are drawn
with numpy from seeds and handed to both packages."""
import contextlib
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sound_bubble_tpu.ops.rnn as jrnn
from sound_bubble_tpu import utils as jutils
from sound_bubble_tpu.losses.snrlp import SNRLPLoss as JSNRLP
from sound_bubble_tpu.models.tfgridnet.model import make_net
from sound_bubble_tpu.ops.pallas import lstm_train_slab as jslab
from sound_bubble_tpu_torch import train_stream
from sound_bubble_tpu_torch.data.synth import golden_batch
from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config
from sound_bubble_tpu_torch.ops import rnn as trnn
from sound_bubble_tpu_torch.ops.kernels import lstm_slab as tslab
from sound_bubble_tpu_torch.train.module import PLModule
from sound_bubble_tpu_torch.utils import cast_bf16
from sound_bubble_tpu_torch.weights import from_jax_params, param_tree
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "syn_experiments", "pretrain_stage.json")
C, H, R = 5, 4, 11
REL_TOL = 1e-2
MODEL_TOL = 3e-2
SMALL = dict(stft_chunk_size=32, stft_pad_size=16, D=8, B=2, H=8)
EXACT = {"xla_allow_excess_precision": False}


# the JAX package's LSTM routing, pinned for each reference here: other test
# files flip these module globals and need not restore them
ROUTE = {"_FUSED_SCAN": True, "_DIR_FUSE": False, "_CUSTOM_VJP": False,
         "_PALLAS_TRAIN": False, "_PALLAS_BLSTM": False, "_BF16_GATES": True}


@contextlib.contextmanager
def _jax_route(slab: bool):
    """JAX's default scans; with `slab`, every scan through the Pallas slab
    kernels (in interpret mode here), the route of the JAX package's bf16
    trunk on one TPU."""
    saved = {k: getattr(jrnn, k) for k in (*ROUTE, "_SLAB")}
    for k, v in ROUTE.items():
        setattr(jrnn, k, v)
    jrnn._SLAB = slab
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(jrnn, k, v)


def _jit(f, *args):
    """f compiled by XLA with every bf16 rounding kept, called on args."""
    return jax.jit(f).lower(*args).compile(compiler_options=EXACT)(*args)


def _draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _to_torch(a):
    a = jnp.asarray(a)
    t = torch.from_numpy(np.asarray(a.astype(jnp.float32)))
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("wdt", ["bf16", "fp32"])
@pytest.mark.parametrize("reverse", [False, True])
def test_mixed_slab_plain_matches_pallas(reverse, wdt):
    t_len = 13
    rng = np.random.default_rng(3)
    a = dict(w_ih=_draw(rng, C, 4 * H, scale=0.3),
             w_hh=_draw(rng, H, 4 * H, scale=0.3),
             b=_draw(rng, 4 * H, scale=0.1), x=_draw(rng, t_len, R, C),
             h0=_draw(rng, R, H, scale=0.5), c0=_draw(rng, R, H, scale=0.5),
             dy=_draw(rng, t_len, R, H), dhT=_draw(rng, R, H),
             dcT=_draw(rng, R, H))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    j["x"], j["dy"] = j["x"].astype(jnp.bfloat16), j["dy"].astype(jnp.bfloat16)
    if wdt == "bf16":
        for k in ("w_ih", "w_hh", "b"):
            j[k] = j[k].astype(jnp.bfloat16)
    t = {k: _to_torch(v) for k, v in j.items()}
    fargs = ("w_ih", "w_hh", "b", "x", "h0", "c0")
    want = _jit(lambda *v: jslab.lstm_slab_fwd(*v, reverse, interpret=True),
                *(j[k] for k in fargs))
    got = tslab.lstm_slab_fwd_ref(*(t[k] for k in fargs), reverse)
    assert got[0].dtype == torch.bfloat16
    assert _rel(got[0], want[0]) <= 2.0 ** -8
    for g, w, name in zip(got[1:], want[1:], ("hT", "cT", "c_ckpt")):
        assert _rel(g, w) <= REL_TOL, name

    hp = jslab._shift_prev(want[0], j["h0"], reverse, j["w_hh"].dtype)
    bargs = (j["w_ih"], j["w_hh"], j["b"], j["x"], hp, want[3], j["dy"],
             j["dhT"], j["dcT"])
    want_b = _jit(lambda *v: jslab.lstm_slab_bwd(*v, reverse,
                                                 interpret=True), *bargs)
    t_hp = tslab.shift_prev(_to_torch(want[0]), t["h0"], reverse,
                            t["w_hh"].dtype)
    assert t_hp.dtype == t["w_hh"].dtype
    np.testing.assert_array_equal(t_hp.float().numpy(), np.asarray(
        hp.astype(jnp.float32)))
    got_b = tslab.lstm_slab_bwd_ref(
        t["w_ih"], t["w_hh"], t["b"], t["x"], t_hp, _to_torch(want[3]),
        t["dy"], t["dhT"], t["dcT"], reverse)
    assert got_b[0].dtype == torch.bfloat16
    for g, w, name in zip(got_b, want_b,
                          ("dx", "dw_ih", "dw_hh", "db", "dh0", "dc0")):
        assert _rel(g, w) <= REL_TOL, name


def _params(rng, c, h):
    return {"w_ih": _draw(rng, c, 4 * h, scale=0.3),
            "w_hh": _draw(rng, h, 4 * h, scale=0.3),
            "b": _draw(rng, 4 * h, scale=0.1)}


def test_mixed_lstm_and_blstm_match_jax():
    """bf16 x and bf16 params through ops.rnn (T = 13 and the T = 1 cell),
    values and gradients; a bf16 scan with bf16_gates=False raises."""
    rng = np.random.default_rng(11)
    bp = {"fwd": _params(rng, C, H), "bwd": _params(rng, C, H)}
    lp = _params(rng, C, H)
    x = _draw(rng, 2, 3, 13, C)
    h0, c0 = _draw(rng, 2, 3, H, scale=0.5), _draw(rng, 2, 3, H, scale=0.5)
    wy, wl = _draw(rng, 2, 3, 13, 2 * H), _draw(rng, 2, 3, 13, H)
    ws = _draw(rng, 2, 3, H)

    def jloss(bp, lp, x, h0, c0):
        y = jrnn.blstm(bp, x)
        yl, (hT, cT) = jrnn.lstm(lp, x, h0, c0)
        outs = (y, yl, hT, cT)
        loss = (jnp.sum(y.astype(jnp.float32) * wy)
                + jnp.sum(yl.astype(jnp.float32) * wl)
                + jnp.sum(hT * ws) + 0.5 * jnp.sum(cT * ws))
        return loss, outs

    bf = jnp.bfloat16
    jargs = jax.tree_util.tree_map(lambda v: jnp.asarray(v).astype(bf),
                                   (bp, lp, x))
    jargs += (jnp.asarray(h0), jnp.asarray(c0))
    with _jax_route(slab=True):
        (_, want), want_g = _jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True), *jargs)
        # the T == 1 cell as XLA compiles it by default: its bf16 sigmoid /
        # tanh are then taken in float32 and rounded once, as the port's
        # (and the Pallas kernel's) are
        want += jax.jit(lambda lp, x, h0, c0: jrnn.lstm(
            lp, x[..., :1, :], h0, c0))(*jargs[1:])

    tb = {d: {k: _to_torch(v).requires_grad_() for k, v in p.items()}
          for d, p in jargs[0].items()}
    tl = {k: _to_torch(v).requires_grad_() for k, v in jargs[1].items()}
    tx = _to_torch(jargs[2]).requires_grad_()
    th, tc = torch.from_numpy(h0), torch.from_numpy(c0)
    y = trnn.blstm(tb, tx)
    yl, (hT, cT) = trnn.lstm(tl, tx, th, tc)
    y1, (h1, c1) = trnn.lstm(tl, tx[..., :1, :], th, tc)
    got = (y, yl, hT, cT, y1, (h1, c1))
    got = got[:5] + got[5]
    want = want[:5] + tuple(want[5])
    for g, w, name in zip(got, want, ("y", "yl", "hT", "cT", "y1", "h1",
                                      "c1")):
        assert g.dtype == (torch.bfloat16 if jnp.asarray(w).dtype == bf
                           else torch.float32), name
        assert _rel(g.detach(), w) <= REL_TOL, name
    loss = ((y.float() * torch.from_numpy(wy)).sum()
            + (yl.float() * torch.from_numpy(wl)).sum()
            + (hT * torch.from_numpy(ws)).sum()
            + 0.5 * (cT * torch.from_numpy(ws)).sum())
    loss.backward()
    got_g = ({d: {k: v.grad for k, v in p.items()} for d, p in tb.items()},
             {k: v.grad for k, v in tl.items()}, tx.grad)
    for g, w in zip(jax.tree_util.tree_leaves(got_g),
                    jax.tree_util.tree_leaves(want_g)):
        assert g.dtype == torch.bfloat16
        assert _rel(g, w) <= REL_TOL
    with pytest.raises(NotImplementedError, match="bf16_gates"):
        trnn.lstm(tl, tx, th, tc, bf16_gates=False)


def _small_net(conditional=True):
    model_params = dict(SMALL, merge_method="early_cat", use_first_ln=True,
                        conv_lstm=False, dis_type="conv3")
    jnet = make_net(model_params, conditional=conditional)
    return model_params, jnet


@pytest.mark.parametrize("recipe", ["fp32_params", "cast_bf16"])
def test_bf16_model_forward_matches_jax(recipe):
    model_params, jnet = _small_net()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 32 * 7 + 16)).astype(np.float32) * 0.3
    dis = np.asarray([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    inputs = {"mixture": jnp.asarray(x), "dis_embed": jnp.asarray(dis)}
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), inputs)["params"]
    jbf = make_net({**model_params, "compute_dtype": "bf16"})
    p = params if recipe == "fp32_params" else jutils.cast_bf16(params)
    with _jax_route(slab=False):
        want = _jit(lambda p, i: jbf.apply({"params": p}, i)["output"], p,
                    inputs)
    net = Net(make_config({**model_params, "compute_dtype": "bf16"}))
    net.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    tin = {"mixture": torch.from_numpy(x), "dis_embed": torch.from_numpy(dis)}
    with torch.no_grad():
        got = train_stream.forward(net.eval(), tin, recipe == "cast_bf16")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # measured: 7.3e-4 (float32 params), 4.8e-3 (cast_bf16)
    assert _rel(got, want) <= MODEL_TOL


@functools.lru_cache(maxsize=1)
def _step_case():
    """The small config's PLModule arguments, the first 0.1 s of the golden
    batch, and the JAX net's initial params."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    args = cfg["pl_module_args"]
    args["model_params"] = {**args["model_params"], **SMALL}
    batch = golden_batch(0)
    inputs = {k: batch[0][k][..., :2400] if k == "mixture" else batch[0][k]
              for k in ("mixture", "dis_embed")}
    target = batch[1]["target"][..., :2400]
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jnet = make_net(args["model_params"])
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1), jin)["params"]
    return args, inputs, target, jin, params


def _step_modules():
    """A port PLModule at the small width with the JAX net's initial
    params, and the JAX (net, params, loss)."""
    args, inputs, target, jin, params = _step_case()
    np.random.seed(0)
    tmod = PLModule(**args, device="cpu")
    tmod.net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    jloss = JSNRLP(**args["loss_params"])
    jbf = make_net({**args["model_params"], "compute_dtype": "bf16"})
    return tmod, jbf, params, jloss, jin, jnp.asarray(target), inputs, target


@pytest.mark.parametrize("recipe", ["train_pt", "train_stream"])
def test_bf16_train_step_matches_jax(recipe):
    tmod, jbf, params, jloss, jin, jgt, inputs, target = _step_modules()
    cast = jutils.cast_bf16 if recipe == "train_stream" else (lambda p: p)

    def loss_fn(p):
        est = jbf.apply({"params": cast(p)}, jin)["output"]
        return jnp.mean(jnp.atleast_1d(jloss(est=est.astype(jnp.float32),
                                             gt=jgt)))

    with _jax_route(slab=False):
        want_loss, want_g = _jit(jax.value_and_grad(loss_fn), params)
    want_norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in
                                   jax.tree_util.tree_leaves(want_g))))
    model_in = tmod._model_inputs(inputs)
    gt = torch.from_numpy(target)
    if recipe == "train_pt":
        tmod.set_bf16_trunk()
        loss, _ = tmod.train_step(model_in, gt)
    else:
        tmod.set_bf16_trunk()
        loss, _ = train_stream.train_step(tmod, model_in, gt, True)
    assert all(p.dtype == torch.float32 for p in tmod.net.parameters())
    assert abs(float(loss) - float(want_loss)) <= 1e-2 * abs(
        float(want_loss))
    norm = float(tmod.last_grad_norm)
    assert abs(norm - want_norm) <= 3e-2 * want_norm, (norm, want_norm)


def test_cast_bf16_matches_jax_bitwise():
    """Seeded weights of the port's model, as its params and as the JAX
    tree (`param_tree`), through both packages' cast_bf16."""
    net = Net(make_config(_small_net()[0]))
    net.init_weights(torch.Generator().manual_seed(2))
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    param_tree(net))
    want = from_jax_params(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jutils.cast_bf16(params)))
    got_tree = cast_bf16(param_tree(net))
    got_flat = cast_bf16(dict(net.state_dict()))
    for k, w in want.items():
        node = got_tree
        for part in k.split("."):
            node = node[part]
        for g in (node, got_flat[k]):
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.float().numpy(), w.numpy(),
                                          err_msg=k)
