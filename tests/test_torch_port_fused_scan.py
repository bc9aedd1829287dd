"""Port parity, whole-signal fused streaming: the port's
`runtime/fast_path.py:fused_scan_stream` (on the CPU, the eager step of one
`FusedStreamer` in a loop) against the JAX package's `fused_scan_stream`
(one `lax.scan` of the fused step, the Pallas stack kernels in interpret
mode) on the same windows and the same numpy-seeded weights, carried from
the port's net to the JAX tree by `weights.param_tree`. Small widths (D=8,
B=2, H=8; chunk 32, pad 16: F = 25), 7 chunks. Tolerance 1e-4 absolute, the
repo's whole-model bar.

- the conditional net; conv_lstm unconditioned; attention with W = 4 < 7
  chunks, so the ring wraps, in the kernel (JAX `SB_FUSED_ATTN=1`) and by
  the per-block route (`SB_FUSED_ATTN=0`); the look-back decode;
- `FusedStreamer.feed` looped over the same windows, bit-equal to
  `fused_scan_stream`; `state["attn_pos"]` an int32 [1] tensor equal to
  n % W after n chunks; `reset()` then feeding again, and
  `set_dis_embed()` then `reset()`, bit-equal to a fresh streamer;
- the kernel library's key (`ops/kernels/_build.py`) follows every source,
  the flags and the compiler's version, and a process loads a library of
  its key without building (nvcc replaced by a script that prints a
  version)."""
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.models.tfgridnet import model as jmodel
from sound_bubble_tpu.runtime.fast_path import (
    fused_scan_stream as jax_fused_scan_stream)
from sound_bubble_tpu_torch.models.tfgridnet import model as tmodel
from sound_bubble_tpu_torch.ops.kernels import _build
from sound_bubble_tpu_torch.runtime.fast_path import (
    FusedStreamer, fused_scan_stream)
from sound_bubble_tpu_torch.weights import param_tree
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
N_CHUNKS = 7
BASE = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=2, H=8,
            L=2, E=2, use_first_ln=True, merge_method="early_cat",
            conv_lstm=False, dis_type="conv3", use_attn=False)
ATTN = dict(use_attn=True, local_atten_len=4)
# (model params, conditional, attn_in_kernel)
VARIANTS = {
    "cond": ({}, True, True),
    "conv_uncond": (dict(conv_lstm=True, lstm_down=4), False, True),
    "attn_kernel": (ATTN, True, True),
    "attn_block": (ATTN, True, False),
    "lookback": (dict(stft_back_pad=16), True, True)}
DIS = np.asarray([[0.0, 1.0, 0.0]], np.float32)
DIS2 = np.asarray([[0.0, 0.0, 1.0]], np.float32)


def _case(variant, seed=0):
    """(port net, JAX net, JAX params, windows [n, 1, M, n_fft],
    attn_in_kernel): the port's weights drawn with numpy, the JAX tree from
    them."""
    mp, conditional, in_kernel = VARIANTS[variant]
    mp = {**BASE, **mp}
    rng = np.random.default_rng(seed)
    net = tmodel.Net(tmodel.make_config(mp, conditional))
    net.load_state_dict({k: torch.from_numpy(np.asarray(
        rng.standard_normal(v.shape) * 0.2, np.float32))
        for k, v in net.state_dict().items()})
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    param_tree(net))
    cfg = net.cfg
    chunk = cfg.stft_chunk_size
    x = rng.standard_normal((1, cfg.num_ch, cfg.stft_back_pad
                             + chunk * N_CHUNKS + cfg.stft_pad_size))
    windows = np.stack([x[..., k * chunk:k * chunk + cfg.n_fft]
                        for k in range(N_CHUNKS)]).astype(np.float32)
    jnet = jmodel.make_net(mp, conditional=conditional)
    return net.eval(), jnet, params, windows, in_kernel


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_scan_stream_matches_jax(variant, monkeypatch):
    net, jnet, params, windows, in_kernel = _case(variant)
    cfg = net.cfg
    # JAX's streamer takes its attention route from the environment
    monkeypatch.setenv("SB_FUSED_ATTN", "1" if in_kernel else "0")
    want = np.asarray(jax_fused_scan_stream(jnet, params,
                                            jnp.asarray(windows), DIS,
                                            interpret=True))
    got = fused_scan_stream(net, windows, DIS, device="cpu",
                            attn_in_kernel=in_kernel)
    assert got.shape == want.shape == (1, cfg.num_src,
                                       N_CHUNKS * cfg.stft_chunk_size)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)

    # the feed loop is the same computation, bit for bit
    fs = FusedStreamer(net, DIS, device="cpu", attn_in_kernel=in_kernel)
    fed = torch.cat([fs.feed(w) for w in windows], dim=-1)
    assert torch.equal(fed, got)
    if cfg.use_attn and in_kernel:
        pos = fs.internal_state["attn_pos"]
        assert pos.dtype == torch.int32 and pos.shape == (1,)
        assert int(pos) == N_CHUNKS % cfg.local_atten_len

    # reset() zeroes the state in place: a fresh start
    fs.reset()
    again = torch.cat([fs.feed(w) for w in windows[:3]], dim=-1)
    assert torch.equal(again, got[..., :3 * cfg.stft_chunk_size])


@pytest.mark.parametrize("variant", ["cond", "attn_kernel"])
def test_set_dis_embed_matches_a_fresh_streamer(variant):
    net, _, _, windows, in_kernel = _case(variant)
    fs = FusedStreamer(net, DIS, device="cpu", attn_in_kernel=in_kernel)
    film = fs.film
    for w in windows[:2]:
        fs.feed(w)
    fs.set_dis_embed(DIS2)
    fs.reset()
    assert all(a is b for a, b in zip(fs.film, film))   # written in place
    got = torch.cat([fs.feed(w) for w in windows], dim=-1)
    want = fused_scan_stream(net, windows, DIS2, device="cpu",
                             attn_in_kernel=in_kernel)
    assert torch.equal(got, want)


def _fake_nvcc(tmp_path, version):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho 'Cuda compilation tools, {version}'\n")
    nvcc.chmod(0o755)
    return str(nvcc)


def test_library_key_follows_sources_flags_and_compiler(tmp_path,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    nvcc = _fake_nvcc(tmp_path, "release 12.4")
    key = _build.library_key(nvcc)
    assert key == _build.library_key(nvcc)
    assert _build.library_path(key).name == f"libsbt_kernels.{key}.so"
    header = csrc / "lstm_fwd32.cuh"
    text = header.read_text()
    header.write_text(text + "\n")
    assert _build.library_key(nvcc) != key
    header.write_text(text)
    assert _build.library_key(nvcc) == key
    (csrc / "extra.cu").write_text("// another source\n")
    assert _build.library_key(nvcc) != key
    os.remove(csrc / "extra.cu")
    monkeypatch.setattr(_build, "COMPILE_FLAGS",
                        [*_build.COMPILE_FLAGS, "-lineinfo"])
    assert _build.library_key(nvcc) != key
    monkeypatch.undo()
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_key(nvcc) == key
    assert _build.library_key(_fake_nvcc(tmp_path, "release 12.8")) != key


def test_load_library_reuses_a_library_of_its_key(tmp_path, monkeypatch):
    """A library of the process's key is loaded without a build; with
    `rebuild`, or once a source changed, the library is built."""
    nvcc = _fake_nvcc(tmp_path, "release 12.4")
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    built, loaded = [], []

    def build(nvcc_, key):
        built.append(key)
        path = _build.library_path(key)
        path.parent.mkdir(exist_ok=True)
        path.write_bytes(b"")
        return path, "compiled"

    class Lib:
        def __init__(self, path):
            loaded.append(path)

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)

    def load(**kw):
        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setattr(_build, "_build_log", "")
        _build.load_library(**kw)
        return _build.build_log()

    key = _build.library_key(nvcc)
    assert load() == "compiled" and built == [key]
    assert load() == f"reused {key}: {_build.library_path(key)}"
    assert built == [key] and loaded[-1] == str(_build.library_path(key))
    assert load(rebuild=True) == "compiled" and built == [key, key]
    (csrc / "stack_walk.cu").write_text("// changed\n")
    assert load() == "compiled" and built[-1] != key
