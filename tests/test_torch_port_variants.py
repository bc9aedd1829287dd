"""Port parity, the last TF-GridNet variants of the JAX `NetConfig`: the
look-back decode (`stft_back_pad > 0`) and the linear distance embeddings
(`dis_type` linear1 / linear2), against the JAX package on the same weights
(`from_jax_params`) and the same numpy inputs, on the CPU, at a small width
(D=8, B=2, H=8; chunk 32, pad 16, back pad 16 or 8: F = 33 or 29).
Tolerance 1e-4 absolute, the repo's whole-model bar.

- look-back: the offline `Net` (pad=True) against JAX; the stream through
  the port's `ModelWrapper` and through `FusedStreamer` (the plain stack
  step; with attention too, both routes) against the JAX `ModelWrapper`
  stream and against the JAX `FusedStreamer` (interpret mode). These follow
  the JAX package's streaming semantics, not the reference's offline
  in-place add (`tests/test_full_net_parity.py`,
  `test_reference_backpad_offline_is_inconsistent`);
- linear1 / linear2: `DisEmbed` against JAX, and the conditioned net
  offline and through `FusedStreamer` (its FiLM affines from the linear
  embedding) against JAX;
- the two seeded attention configurations (`runs/attn_{flagship,orangpi}
  _seeded/config.json`, `tools/jax_goldens_attn.py`) through `python -m
  sound_bubble_tpu_torch.train_pt --device cpu`, widths cut to D=8, H=8,
  B=2 (L=4, E=2 and W=100 kept), one epoch on 0.5 s crops of seeded
  synthetic scenes: the run writes finite losses and a checkpoint with the
  attention weights; and both seeded nets at full width build from their
  run dirs and stream 3 chunks through `FusedStreamer`."""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.models.tfgridnet import model as jmodel
from sound_bubble_tpu.runtime.fast_path import FusedStreamer as JaxStreamer
from sound_bubble_tpu.runtime.streaming import (
    ModelWrapper as JaxWrapper, streaming_inference as jax_streaming)
from sound_bubble_tpu_torch.data.synth import write_sample_dirs
from sound_bubble_tpu_torch.models.tfgridnet import model as tmodel
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.runtime.streaming import (
    ModelWrapper, streaming_inference)
from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint
from sound_bubble_tpu_torch.utils import load_pretrained
from sound_bubble_tpu_torch.weights import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
BASE = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=2, H=8,
            L=2, E=2, use_first_ln=True, merge_method="early_cat",
            conv_lstm=False, dis_type="conv3", use_attn=False)
DIS = np.asarray([[1.0, 0.0, 0.0]], np.float32)


def _nets(model_params, seed=0):
    jnet = jmodel.make_net(model_params, conditional=True)
    cfg = jnet.cfg
    dummy = {"mixture": jnp.zeros((1, cfg.num_ch, cfg.n_fft), jnp.float32),
             "dis_embed": jnp.asarray(DIS)}
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed), dummy)["params"]
    net = tmodel.net_from_params(**model_params)
    net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net.eval()


def _offline(jnet, params, net, x):
    # jitted: much faster than eager on the CPU
    want = np.asarray(jax.jit(functools.partial(jnet.apply, pad=True))(
        {"params": params}, {"mixture": jnp.asarray(x),
                             "dis_embed": jnp.asarray(DIS)})["output"])
    with torch.no_grad():
        got = net({"mixture": torch.from_numpy(x),
                   "dis_embed": torch.from_numpy(DIS)})["output"].numpy()
    return got, want


@pytest.mark.parametrize("back", [16, 8])
def test_lookback_offline_and_streamed_match_jax(back, rng):
    mp = {**BASE, "stft_back_pad": back}
    jnet, params, net = _nets(mp)
    cfg = net.cfg
    assert cfg.n_fft == back + 48 and cfg.istft_lookback == 1
    x = rng.standard_normal((1, 6, 32 * 9 + 5)).astype(np.float32)
    got, want = _offline(jnet, params, net, x)
    assert got.shape == want.shape == x[:, :1].shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    # streamed: windows of back + chunk + pad samples
    pad = cfg.stft_back_pad + cfg.stft_pad_size
    want = np.asarray(jax_streaming(JaxWrapper(jnet, params), x, 32, pad,
                                    DIS))
    got = streaming_inference(ModelWrapper(net, device="cpu"), x, 32, pad,
                              DIS).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    n = got.shape[-1] // 32
    fs = FusedStreamer(net, DIS, device="cpu")
    fused = torch.cat([fs.feed(x[..., k * 32:k * 32 + cfg.n_fft])
                       for k in range(n)], dim=-1).numpy()
    np.testing.assert_allclose(fused, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("in_kernel", [True, False])
def test_lookback_with_attention_streamer_matches_jax(in_kernel, rng):
    mp = {**BASE, "stft_back_pad": 16, "use_attn": True,
          "local_atten_len": 4}
    jnet, params, net = _nets(mp)
    cfg = net.cfg
    x = rng.standard_normal((1, 6, 16 + 32 * 6 + 16)).astype(np.float32)
    windows = [x[..., k * 32:k * 32 + cfg.n_fft] for k in range(6)]
    jfs = JaxStreamer(jnet, params, DIS, interpret=True,
                      attn_in_kernel=in_kernel)
    want = np.concatenate([np.asarray(jfs.feed(jnp.asarray(w)))
                           for w in windows], axis=-1)
    fs = FusedStreamer(net, DIS, device="cpu", attn_in_kernel=in_kernel)
    got = torch.cat([fs.feed(w) for w in windows], dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["linear1", "linear2"])
def test_linear_dis_embed_matches_jax(kind, rng):
    mp = {**BASE, "dis_type": kind}
    jnet, params, net = _nets(mp)
    cfg = net.cfg
    F = cfg.n_freqs
    e = rng.standard_normal((3, 3)).astype(np.float32)
    want = np.asarray(jmodel.DisEmbed(jnet.cfg).apply(
        {"params": params["dis_embed"]}, jnp.asarray(e)))
    got = net.dis_embed(torch.from_numpy(e)).detach().numpy()
    assert got.shape == want.shape == (3, F, cfg.embed_width)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    x = rng.standard_normal((1, 6, 32 * 5 + 16)).astype(np.float32)
    got, want = _offline(jnet, params, net, x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    windows = [x[..., k * 32:k * 32 + cfg.n_fft] for k in range(5)]
    jfs = JaxStreamer(jnet, params, DIS, interpret=True)
    want = np.concatenate([np.asarray(jfs.feed(jnp.asarray(w)))
                           for w in windows], axis=-1)
    fs = FusedStreamer(net, DIS, device="cpu")
    got = torch.cat([fs.feed(w) for w in windows], dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_every_jax_config_field_is_covered():
    """The port's NetConfig has every field of the JAX one, and raises only
    for the bf16 trunk with attention and an unknown compute_dtype."""
    import dataclasses

    jfields = {f.name for f in dataclasses.fields(jmodel.NetConfig)}
    assert jfields == {f.name for f in dataclasses.fields(tmodel.NetConfig)}
    for variant in (dict(stft_back_pad=16), dict(dis_type="linear1"),
                    dict(dis_type="linear2"), dict(use_attn=True),
                    dict(use_attn=True, conv_lstm=True, lstm_down=4),
                    dict(compute_dtype="bf16")):
        tmodel.check_supported(tmodel.NetConfig(**{**BASE, **variant}))
    with pytest.raises(NotImplementedError, match="bf16 trunk"):
        tmodel.check_supported(tmodel.NetConfig(
            **{**BASE, "use_attn": True, "compute_dtype": "bf16"}))
    with pytest.raises(ValueError, match="compute_dtype"):
        tmodel.check_supported(tmodel.NetConfig(
            **{**BASE, "compute_dtype": "fp16"}))


@pytest.mark.parametrize("net", ["flagship", "orangpi"])
def test_train_pt_on_attn_config(net, tmp_path):
    run = os.path.join(REPO, "runs", f"attn_{net}_seeded")
    with open(os.path.join(run, "config.json")) as f:
        cfg = json.load(f)
    mp = cfg["pl_module_args"]["model_params"]
    assert mp["use_attn"] and (mp["L"], mp["E"], mp["local_atten_len"]) == (
        4, 2, 100)
    mp.update(D=8, H=8, B=2)
    cfg["pl_module_args"].pop("init_ckpt")
    dirs = write_sample_dirs(str(tmp_path / "data"), seed=0, n_train=2,
                             n_val=1)
    for split, key in (("train", "train_data_args"), ("val", "val_data_args")):
        cfg[key]["dataset_dirs"] = [
            {"path": p, "max_samples": 10} for p in dirs[split]]
        cfg[key]["sig_len"] = 0.25      # 0.5 s crops of the 2.5 s scenes
    cfg["epochs"], cfg["num_workers"] = 1, 0
    cfg_path, run_dir = str(tmp_path / "config.json"), str(tmp_path / "run")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    # two intra-op threads: the CLI shares the machine with the other test
    # workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "sound_bubble_tpu_torch.train_pt", "--config",
         cfg_path, "--run_dir", run_dir, "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("  train step ") >= 1
    state = load_checkpoint(os.path.join(run_dir, "checkpoints", "last.pt"))
    assert state["current_epoch"] == 1
    assert {"attn_q", "attn_k", "attn_v", "attn_out_proj", "attn_out_act",
            "attn_out_norm"} <= set(state["model"]["block1"])
    for name in ("train/loss", "val/loss"):
        assert np.isfinite(state["metric_values"][0][name]["epoch"])

    # the seeded net at full width: builds from its run dir and streams
    full = load_pretrained(run, device="cpu")
    assert full.cfg.use_attn and full.cfg.conv_lstm == (net == "orangpi")
    fs = FusedStreamer(full, device="cpu")
    rng = np.random.default_rng(0)
    cfgf = full.cfg
    x = rng.standard_normal((1, 6, cfgf.stft_chunk_size * 3
                             + cfgf.stft_pad_size)).astype(np.float32)
    out = torch.cat([fs.feed(x[..., k * cfgf.stft_chunk_size:
                               k * cfgf.stft_chunk_size + cfgf.n_fft])
                     for k in range(3)], dim=-1)
    assert out.shape == (1, 1, 3 * cfgf.stft_chunk_size)
    assert torch.isfinite(out).all() and fs.internal_state["attn_pos"] == 3
