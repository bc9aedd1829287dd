"""Port parity, the conv_lstm intra path and the edge model as a whole: the
port's `IntraBand` / `GridNetBlock` (conv_lstm=True) and the unconditioned
conv model streamed through `FusedStreamer` against the JAX package on the
same weights (`from_jax_params`) and the same numpy inputs, on the CPU.

- `IntraBand` and one `GridNetBlock` with conv_lstm=True, at F=25: s=5
  (F % s == 0) and s=4 (ragged: rows from k*s on get no up conv), the
  outputs and the input gradients 1e-5 absolute, every weight's gradient
  within 1e-5 of max(1, its leaf's peak) (fp32 both sides, other summation
  order; a bias gradient sums over every row and reaches ~20);
- the unconditioned conv model (the edge configuration's shape at a small
  width), 3 chunks with carried state: the port's `FusedStreamer` (plain
  version of the stack step) against the JAX `FusedStreamer` (Pallas in
  interpret mode) and against the port's own `ModelWrapper`, 1e-4 absolute,
  the repo's whole-model bar (counterpart of the JAX `conv_lstm` / `uncond`
  cases of `tests/test_fast_path.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.models.tfgridnet import model as jmodel
from sound_bubble_tpu.runtime.fast_path import FusedStreamer as JaxStreamer
from sound_bubble_tpu_torch.models.tfgridnet import model as tmodel
from sound_bubble_tpu_torch.ops.kernels import stack_kernel as tsk
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.runtime.streaming import (
    ModelWrapper, streaming_inference)
from sound_bubble_tpu_torch.weights import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
STREAM_TOL = 1e-4
# F = 48 // 2 + 1 = 25
WIDTH = dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8, B=3,
             conv_lstm=True)
EDGE_SMALL = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=3,
                  H=8, L=2, E=2, use_attn=False, chunk_causal=True,
                  use_first_ln=True, merge_method="early_cat", conv_lstm=True,
                  lstm_down=5, dis_type="conv3")


def _flat_grads(tree):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _check_grads(module, want_tree):
    want = _flat_grads(want_tree)
    got = {k: p.grad.numpy() for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in got:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], atol=TOL * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("s", [5, 4])
def test_intra_band_conv_matches_jax(s, rng):
    jcfg = jmodel.NetConfig(**WIDTH, lstm_down=s)
    F, C = jcfg.n_freqs, jcfg.D
    assert F == 25 and (F % s == 0) == (s == 5)
    x = rng.standard_normal((2, 3, F, C)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jmod = jmodel.IntraBand(jcfg)
    params = jmod.init(jax.random.PRNGKey(s), jnp.asarray(x))["params"]

    def f(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) * cot)

    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))

    mod = tmodel.IntraBand(tmodel.NetConfig(**WIDTH, lstm_down=s))
    mod.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)
    # rows from k*s on: no up conv, not even its bias
    k = F // s
    assert not got[..., k * s:, :].detach().abs().sum()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=TOL,
                               rtol=0)
    _check_grads(mod, gp)


@pytest.mark.parametrize("s", [5, 4])
def test_gridnet_block_conv_matches_jax(s, rng):
    jcfg = jmodel.NetConfig(**WIDTH, lstm_down=s)
    F, C, H = jcfg.n_freqs, jcfg.D, jcfg.H
    x = rng.standard_normal((2, 3, F, C)).astype(np.float32)
    h0 = 0.5 * rng.standard_normal((2, F, H)).astype(np.float32)
    c0 = 0.5 * rng.standard_normal((2, F, H)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    cot_h = rng.standard_normal(h0.shape).astype(np.float32)
    jblk = jmodel.GridNetBlock(jcfg)
    jstate = {"h0": jnp.asarray(h0), "c0": jnp.asarray(c0)}
    params = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       jstate)["params"]

    def f(p, xx):
        y, st = jblk.apply({"params": p}, xx, jstate)
        return jnp.sum(y * cot) + jnp.sum(st["h0"] * cot_h)

    want, want_st = jblk.apply({"params": params}, jnp.asarray(x), jstate)
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))

    blk = tmodel.GridNetBlock(tmodel.NetConfig(**WIDTH, lstm_down=s))
    blk.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    xt = torch.from_numpy(x).requires_grad_()
    got, got_st = blk(xt, {"h0": torch.from_numpy(h0),
                           "c0": torch.from_numpy(c0)})
    ((got * torch.from_numpy(cot)).sum()
     + (got_st["h0"] * torch.from_numpy(cot_h)).sum()).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    for key in ("h0", "c0"):
        np.testing.assert_allclose(got_st[key].detach().numpy(),
                                   np.asarray(want_st[key]), atol=TOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=TOL,
                               rtol=0)
    _check_grads(blk, gp)


def test_unconditioned_conv_model_streamed_matches_jax(rng):
    """The edge model's shape (conv_lstm, unconditioned, early_cat, first
    LayerNorm) at a small width: 3 chunks with carried state."""
    n = 3
    chunk, pad = EDGE_SMALL["stft_chunk_size"], EDGE_SMALL["stft_pad_size"]
    x = rng.standard_normal((1, 6, chunk * n + pad)).astype(np.float32) * 3
    jnet = jmodel.make_net(EDGE_SMALL, conditional=False)
    params = jnet.init(jax.random.PRNGKey(0), {
        "mixture": jnp.asarray(x[..., :jnet.cfg.n_fft])})["params"]
    assert "dis_embed" not in params and "film0" not in params
    net = tmodel.net_optim_from_params(**EDGE_SMALL)
    assert not net.cfg.conditional and net.cfg.conv_lstm
    net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    net.eval()

    jfs = JaxStreamer(jnet, params, interpret=True)
    fs = FusedStreamer(net, device="cpu")
    assert fs.film is None and "down_cat" in fs.packed
    windows = [x[..., k * chunk:k * chunk + chunk + pad] for k in range(n)]
    want = np.concatenate([np.asarray(jfs.feed(jnp.asarray(w)))
                           for w in windows], axis=-1)
    launches = tsk.gridnet_stack_step.conv_launches
    got = torch.cat([fs.feed(w) for w in windows], dim=-1).numpy()
    # the CPU route runs the plain version: no kernel launch
    assert tsk.gridnet_stack_step.conv_launches == launches
    assert got.shape == want.shape == (1, 1, chunk * n)
    np.testing.assert_allclose(got, want, atol=STREAM_TOL, rtol=0)

    plain = streaming_inference(ModelWrapper(net, device="cpu"), x, chunk,
                                pad).numpy()
    np.testing.assert_allclose(got, plain, atol=STREAM_TOL, rtol=0)
