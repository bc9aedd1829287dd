"""Port parity, core ops: `sound_bubble_tpu_torch.ops` (stft, features, rnn)
against the JAX functions on the same numpy inputs, on the CPU.

Tolerance 1e-5 absolute: both sides are fp32 with the same operation order
up to matmul summation order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.ops import features as jfeat
from sound_bubble_tpu.ops import rnn as jrnn
from sound_bubble_tpu.ops import stft as jstft
from sound_bubble_tpu_torch.ops import features as tfeat
from sound_bubble_tpu_torch.ops import rnn as trnn
from sound_bubble_tpu_torch.ops import stft as tstft
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
N_FFT, CHUNK = 288, 192          # production STFT: chunk 192 + lookahead 96


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def test_filterbank_matches():
    np.testing.assert_array_equal(tstft.stft_filterbank(N_FFT, N_FFT, CHUNK),
                                  jstft.stft_filterbank(N_FFT, N_FFT, CHUNK))


@pytest.mark.parametrize("n", [288, 288 + 192 * 3, 1000])
def test_frame_matches(n, rng):
    x = rng.standard_normal((2, 3, n)).astype(np.float32)
    _close(tstft.frame(torch.from_numpy(x), N_FFT, CHUNK),
           jstft.frame(jnp.asarray(x), N_FFT, CHUNK), tol=0)


@pytest.mark.parametrize("t", [1, 4])
def test_stft_istft_match(t, rng):
    x = rng.standard_normal((1, 6, N_FFT + CHUNK * (t - 1))).astype(np.float32)
    tfb = tstft.make_stft(N_FFT, CHUNK)
    jfb = jstft.make_stft(N_FFT, CHUNK)
    spec_t = tstft.stft(tfb, torch.from_numpy(x))
    spec_j = jstft.stft(jfb, jnp.asarray(x))
    assert spec_t.shape == spec_j.shape
    _close(spec_t, spec_j)
    _close(tstft.istft(tfb, spec_t), jstft.istft(jfb, spec_j))


@pytest.mark.parametrize("n", [192 * 5, 1000, 48000])
def test_mod_pad_matches(n, rng):
    x = rng.standard_normal((1, 2, n)).astype(np.float32)
    got, mod_t = tstft.mod_pad(torch.from_numpy(x), CHUNK, (0, 96))
    want, mod_j = jstft.mod_pad(jnp.asarray(x), CHUNK, (0, 96))
    assert mod_t == mod_j
    _close(got, want, tol=0)


@pytest.mark.parametrize("directional", [False, True])
def test_spatial_features_match(directional, rng):
    real = rng.standard_normal((2, 6, 3, 145)).astype(np.float32)
    imag = rng.standard_normal((2, 6, 3, 145)).astype(np.float32)
    got = tfeat.spatial_features(torch.from_numpy(real),
                                 torch.from_numpy(imag), directional)
    want = jfeat.spatial_features(jnp.asarray(real), jnp.asarray(imag),
                                  directional)
    assert got.shape == want.shape
    _close(got, want)


def _lstm_params(rng, c, h):
    return {"w_ih": rng.standard_normal((c, 4 * h)).astype(np.float32) * 0.3,
            "w_hh": rng.standard_normal((h, 4 * h)).astype(np.float32) * 0.3,
            "b": rng.standard_normal((4 * h,)).astype(np.float32) * 0.3}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("t_len,reverse,with_state",
                         [(1, False, True), (9, False, False),
                          (9, True, False), (9, False, True)])
def test_lstm_matches(t_len, reverse, with_state, rng):
    c, h = 8, 16
    p = _lstm_params(rng, c, h)
    x = rng.standard_normal((3, t_len, c)).astype(np.float32)
    h0 = c0 = None
    if with_state:
        h0 = rng.standard_normal((3, h)).astype(np.float32)
        c0 = rng.standard_normal((3, h)).astype(np.float32)
    y_t, (h_t, c_t) = trnn.lstm(
        _t(p), torch.from_numpy(x),
        None if h0 is None else torch.from_numpy(h0),
        None if c0 is None else torch.from_numpy(c0), reverse=reverse)
    y_j, (h_j, c_j) = jrnn.lstm(
        _j(p), jnp.asarray(x), None if h0 is None else jnp.asarray(h0),
        None if c0 is None else jnp.asarray(c0), reverse=reverse)
    _close(y_t, y_j)
    _close(h_t, h_j)
    _close(c_t, c_j)


@pytest.mark.parametrize("t_len", [1, 17])
def test_blstm_matches(t_len, rng):
    c, h = 8, 16
    p = {"fwd": _lstm_params(rng, c, h), "bwd": _lstm_params(rng, c, h)}
    x = rng.standard_normal((4, t_len, c)).astype(np.float32)
    got = trnn.blstm(_t(p), torch.from_numpy(x))
    want = jrnn.blstm(_j(p), jnp.asarray(x))
    assert got.shape == want.shape
    _close(got, want)
