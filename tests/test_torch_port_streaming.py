"""Port parity, the serving paths: the port's `ModelWrapper` /
`streaming_inference` and `FusedStreamer` (CPU route of the stack step)
against the JAX package's streaming loop on the same weights
(`from_jax_params`) and the same numpy inputs, on the CPU.

Tolerance 1e-4 absolute on the SMALL config of tests/test_fast_path.py, the
repo's bar for whole-model parity; 1e-4 relative to the output's peak for the
full-width flagship case."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.evaluation import load_testcase as jload_testcase
from sound_bubble_tpu.models.tfgridnet.model import make_net
from sound_bubble_tpu.train.checkpoint import load_checkpoint as jload_ckpt
from sound_bubble_tpu.runtime.streaming import ModelWrapper as JaxWrapper
from sound_bubble_tpu.runtime.streaming import \
    streaming_inference as jax_streaming
from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.runtime.streaming import (
    ModelWrapper, streaming_inference)
from sound_bubble_tpu_torch.utils import load_pretrained, read_json
from sound_bubble_tpu_torch.weights import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
SMALL = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=3, H=8,
             L=2, E=2, use_attn=False, chunk_causal=True, use_first_ln=True,
             merge_method="early_cat", conv_lstm=False, dis_type="conv3")
VARIANTS = {"cond": ({}, True), "uncond": ({}, False)}
DIS = np.asarray([[0.0, 1.0, 0.0]], np.float32)


def _pair(variant, x):
    """(JAX net, JAX params, port Net) with the same weights."""
    extra, conditional = VARIANTS[variant]
    model_params = {**SMALL, **extra}
    jnet = make_net(model_params, conditional=conditional)
    inputs = {"mixture": jnp.asarray(x[..., :jnet.cfg.n_fft])}
    if conditional:
        inputs["dis_embed"] = jnp.asarray(DIS)
    params = jnet.init(jax.random.PRNGKey(0), inputs)["params"]
    net = Net(make_config(model_params, conditional=conditional))
    net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net.eval()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_streaming_paths_match_jax(variant, rng):
    """8 chunks with carried state: the port's ModelWrapper loop and its
    FusedStreamer against the JAX ModelWrapper loop."""
    chunk, pad = SMALL["stft_chunk_size"], SMALL["stft_pad_size"]
    x = rng.standard_normal((1, 6, chunk * 8 + pad)).astype(np.float32) * 3
    jnet, params, net = _pair(variant, x)
    dis = DIS if jnet.cfg.conditional else None
    want = np.asarray(jax_streaming(JaxWrapper(jnet, params), x, chunk, pad,
                                    dis_embed=dis))
    got = streaming_inference(ModelWrapper(net, device="cpu"), x, chunk, pad,
                              dis_embed=dis).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    fs = FusedStreamer(net, dis_embed=dis, device="cpu")
    outs = [fs.feed(x[..., k * chunk:k * chunk + chunk + pad])
            for k in range(8)]
    got = torch.cat(outs, dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_flagship_fused_streamer_matches_jax():
    """Full width (F=145, D=32, B=6, H=64): the flagship checkpoint, the
    port's CPU FusedStreamer against the JAX ModelWrapper on the first 6
    chunks of test_samples/syn_1m/00002."""
    run_dir = REPO / "runs" / "finetune_r5"
    n = 6
    _, mixture, _, _, _ = jload_testcase(
        str(REPO / "test_samples" / "syn_1m" / "00002"), 24000, 1.0)
    jnet = make_net(read_json(str(run_dir / "config.json"))[
        "pl_module_args"]["model_params"])
    params = jload_ckpt(str(run_dir / "checkpoints" / "best.pt"))["model"]
    cfg = jnet.cfg
    chunk, pad = cfg.stft_chunk_size, cfg.stft_pad_size
    x = mixture[None, :, :chunk * n + pad].astype(np.float32)
    dis = [[0.0, 0.0, 1.0]]
    want = np.asarray(jax_streaming(JaxWrapper(jnet, params), x, chunk, pad,
                                    dis_embed=dis))

    net = load_pretrained(str(run_dir), device="cpu")
    assert (net.cfg.n_freqs, net.cfg.D, net.cfg.B, net.cfg.H) == (145, 32, 6,
                                                                   64)
    fs = FusedStreamer(net, dis_embed=dis, device="cpu")
    got = torch.cat([fs.feed(x[..., k * chunk:k * chunk + chunk + pad])
                     for k in range(n)], dim=-1).numpy()
    assert got.shape == want.shape == (1, 1, chunk * n)
    peak = np.abs(want).max()
    assert peak > 0
    assert np.abs(got - want).max() / peak <= TOL
