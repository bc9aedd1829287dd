"""The edge configurations (`real_experiments/*.json`: conv_lstm,
unconditioned) through the port's entry points, on the CPU:

- `python -m sound_bubble_tpu_torch.train_pt --device cpu` on the Orange Pi
  finetune config (widths cut to D=8, H=8, B=2; one epoch on 0.5 s crops
  of seeded synthetic scenes), warm-started from the weights of a module
  built on the pretrain config, as the recipe chains the two stages: every
  dotted path of both configs resolves in the port, and the finetune stage
  writes finite losses (both stages run through `train_pt` on the card, in
  chip_smoke.py);
- the serving CLI's `evaluate_dir` on a tiny conv run dir (JAX layout)
  against the JAX package's offline `Net` on the same weights, per sample,
  1e-3 dB (the bar of tests/test_torch_port_eval.py);
- one production-width case: the committed seeded edge weights
  (`runs/edge_orangpi_seeded`, F=145, D=24, B=3, H=64, s=5), the first 3
  chunks of `test_samples/syn_1m/00002` through the port's plain
  `FusedStreamer` against the JAX `ModelWrapper`'s first chunks in
  `runs/goldens_edge_jax.json` (`tools/jax_goldens_edge.py`), 1e-4 of the
  output's peak."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import scipy.io.wavfile
import torch

from sound_bubble_tpu.evaluation import load_testcase as jload_testcase
from sound_bubble_tpu.metrics import metrics as jm
from sound_bubble_tpu.models.tfgridnet.model import make_net
from sound_bubble_tpu.train.checkpoint import save_checkpoint
from sound_bubble_tpu_torch import test_samples as cli
from sound_bubble_tpu_torch.data.synth import write_sample_dirs
from sound_bubble_tpu_torch.evaluation import load_testcase
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.train.checkpoint import (
    load_checkpoint, model_tree, save_checkpoint as save_checkpoint_pt)
from sound_bubble_tpu_torch.train.module import PLModule
from sound_bubble_tpu_torch.utils import load_pretrained
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = os.path.join(REPO, "real_experiments", "orangpi_model_{}.json")
SEEDED = os.path.join(REPO, "runs", "edge_orangpi_seeded")
GOLDEN = os.path.join(REPO, "runs", "goldens_edge_jax.json")
TINY = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=2, H=8,
            use_attn=False, use_first_ln=True, merge_method="early_cat",
            conv_lstm=True, lstm_down=5, dis_type="conv3")


def _run(cfg_path, run_dir):
    # two intra-op threads: the CLI shares the machine with the other test
    # workers, and a thread per core each oversubscribes it many times over
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "sound_bubble_tpu_torch.train_pt", "--config",
         cfg_path, "--run_dir", run_dir, "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)


def _edge_config(stage, dirs):
    """The Orange Pi config of `stage`, widths cut to D=8, H=8, B=2, one
    epoch on 0.5 s crops of the seeded synthetic scenes."""
    with open(EDGE.format(stage)) as f:
        cfg = json.load(f)
    assert cfg["pl_module_args"]["model"].endswith("net_optim_from_params")
    cfg["pl_module_args"]["model_params"].update(D=8, H=8, B=2)
    for split, key in (("train", "train_data_args"), ("val", "val_data_args")):
        cfg[key]["dataset_dirs"] = [
            {"path": p, "max_samples": 10} for p in dirs[split]]
        cfg[key]["sig_len"] = 0.25      # 0.5 s crops of the 2.5 s scenes
    cfg["epochs"], cfg["num_workers"] = 1, 0
    return cfg


def test_train_pt_edge_finetune_from_pretrain(tmp_path):
    dirs = write_sample_dirs(str(tmp_path / "data"), seed=0, n_train=2,
                             n_val=1)
    # the pretrain stage's module, built here: every dotted path of its
    # config resolves in the port; its weights stand in for the pretrain
    # run's last.pt, which the finetune config's init_ckpt names
    pre = _edge_config("pretrain", dirs)["pl_module_args"]
    torch.manual_seed(0)
    init = str(tmp_path / "pretrain_last.pt")
    save_checkpoint_pt(init, {"model": model_tree(
        PLModule(**pre, device="cpu").net)})

    cfg = _edge_config("finetune", dirs)
    args = cfg["pl_module_args"]
    assert args["loss"].endswith("MultiResoFuseLoss")
    args["init_ckpt"] = init
    cfg_path, run_dir = str(tmp_path / "finetune.json"), str(tmp_path / "run")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    proc = _run(cfg_path, run_dir)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("  train step ") == 2
    assert f"Warm-started weights from {init}" in proc.stdout
    state = load_checkpoint(os.path.join(run_dir, "checkpoints", "last.pt"))
    assert state["current_epoch"] == 1
    assert "down" in state["model"]["block0"]["intra"]
    assert "dis_embed" not in state["model"]
    for name in ("train/loss", "val/loss"):
        assert np.isfinite(state["metric_values"][0][name]["epoch"])


def _write_sample(path, rng, n, dists):
    path.mkdir(parents=True)
    meta = {"real": False}
    mixture = 0.05 * rng.standard_normal((n, 6))
    for k, d in enumerate(dists):
        voice = 0.1 * rng.standard_normal(n)
        mixture += voice[:, None]
        scipy.io.wavfile.write(path / f"mic00_voice{k:02d}.wav", 24000,
                               (voice * 32767 * 0.5).astype(np.int16))
        meta[f"voice{k:02d}"] = {"dis": d, "angle": 10.0 * k}
    scipy.io.wavfile.write(path / "mixture.wav", 24000,
                           (mixture * 32767 * 0.5).astype(np.int16))
    (path / "metadata.json").write_text(json.dumps(meta))


def test_evaluate_dir_conv_run_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    jnet = make_net(TINY, conditional=False)
    params = jnet.init(jax.random.PRNGKey(5), {
        "mixture": jnp.zeros((1, 6, jnet.cfg.n_fft))})["params"]
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({"pl_module_args": {
        "model": "sound_bubble_tpu.models.tfgridnet.model."
                 "net_optim_from_params", "model_params": TINY}}))
    save_checkpoint(str(run / "checkpoints" / "best.pt"), {"model": params})
    tests = tmp_path / "syn_1m"
    # not a multiple of the chunk: the padding and its trim
    _write_sample(tests / "00000", rng, 1003, [1.7])          # empty bubble
    _write_sample(tests / "00001", rng, 1003, [0.5, 2.5])

    net = load_pretrained(str(run), device="cpu")
    assert net.cfg.conv_lstm and not net.cfg.conditional
    sisdris, _, decays = cli.evaluate_dir(FusedStreamer(net, device="cpu"),
                                          str(tests), 1.0, verbose=False)
    want_sisdri, want_decay = [], []
    apply = jax.jit(jnet.apply)
    for sample in sorted(tests.iterdir()):
        _, mixture, gt, tgt, _ = jload_testcase(str(sample), 24000, 1.0)
        out = np.asarray(apply({"params": params}, {
            "mixture": jnp.asarray(mixture[None])})["output"])[0]
        if tgt:
            want_sisdri.append(float(jm.Metrics("si_sdr_i")(
                out, gt, mixture[0:1])))
        else:
            want_decay.append(float(jm.compute_decay(out, mixture[0:1])))
    assert len(sisdris) == len(decays) == 1
    np.testing.assert_allclose(sisdris, want_sisdri, atol=1e-3, rtol=0)
    np.testing.assert_allclose(decays, want_decay, atol=1e-3, rtol=0)


def test_seeded_edge_weights_stream_like_jax():
    with open(GOLDEN) as f:
        golden = json.load(f)
    net = load_pretrained(SEEDED, device="cpu")
    cfg = net.cfg
    assert (cfg.n_freqs, cfg.D, cfg.B, cfg.H, cfg.lstm_down) == (145, 24, 3,
                                                                 64, 5)
    assert cfg.conv_lstm and not cfg.conditional
    assert sum(p.numel() for p in net.parameters()) == golden["n_params"]
    n, chunk, pad = 3, cfg.stft_chunk_size, cfg.stft_pad_size
    sample = os.path.join(REPO, "test_samples", golden["head"]["sample"])
    _, mixture, _, _, _ = load_testcase(sample, 24000, 1.0)
    x = mixture[None, :, :chunk * n + pad].astype(np.float32)
    fs = FusedStreamer(net, device="cpu")
    got = np.concatenate([fs.feed(x[..., k * chunk:k * chunk + chunk + pad])
                          .numpy() for k in range(n)], axis=-1)[0, 0]
    want = np.asarray(golden["head"]["output"][:chunk * n], np.float32)
    peak = np.abs(want).max()
    assert got.shape == want.shape and peak > 0
    err = np.abs(got - want).max() / peak
    assert err <= 1e-4, err
