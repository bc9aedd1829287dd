"""Port parity, evaluation: the port's metrics, testcase loading, streamed
`run_testcase` and the serving CLI's `evaluate_dir` against the JAX package
on the same audio and weights, on the CPU.

Tolerances: metrics 1e-4 dB (both fp32, other summation order); the streamed
output against the offline JAX `Net(pad=True)` 1e-4 absolute (the repo's
whole-model bar); the CLI's per-sample numbers, from that output, 1e-3 dB."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io.wavfile

from sound_bubble_tpu.evaluation import load_testcase as jload_testcase
from sound_bubble_tpu.metrics import metrics as jm
from sound_bubble_tpu.models.tfgridnet.model import make_net
from sound_bubble_tpu.train.checkpoint import save_checkpoint
from sound_bubble_tpu_torch import evaluation as tev
from sound_bubble_tpu_torch import test_samples as cli
from sound_bubble_tpu_torch.metrics import metrics as tm
from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.utils import load_pretrained
from sound_bubble_tpu_torch.weights import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

DB_TOL = 1e-4
SMALL = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=2, H=8,
             use_attn=False, use_first_ln=True, merge_method="early_cat",
             conv_lstm=False, dis_type="conv3")


@pytest.mark.parametrize("name", ["snr", "snr_i", "si_snr", "si_snr_i",
                                  "si_sdr", "si_sdr_i"])
def test_metrics_match_jax(name, rng):
    gt = rng.standard_normal((2, 1, 4000)).astype(np.float32)
    est = (gt + 0.3 * rng.standard_normal(gt.shape)).astype(np.float32)
    mix = (gt + rng.standard_normal(gt.shape)).astype(np.float32)
    got = tm.Metrics(name)(est, gt, mix).numpy()
    want = np.asarray(jm.Metrics(name)(est, gt, mix))
    np.testing.assert_allclose(got, want, atol=DB_TOL, rtol=0)


def test_decay_matches_jax(rng):
    mix = rng.standard_normal((1, 4000)).astype(np.float32)
    est = 0.01 * rng.standard_normal((1, 4000)).astype(np.float32)
    np.testing.assert_allclose(float(tm.compute_decay(est, mix)),
                               float(jm.compute_decay(est, mix)),
                               atol=DB_TOL, rtol=0)


def test_unported_metric_raises():
    with pytest.raises(NotImplementedError):
        tm.Metrics("Hubert")


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


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """A run dir of the JAX package's layout (config.json + best.pt with an
    optax optimizer state) and a 3-sample test dir."""
    rng = np.random.default_rng(0)
    tmp_path = tmp_path_factory.mktemp("port_eval")
    jnet = make_net(SMALL)
    inputs = {"mixture": jnp.zeros((1, 6, jnet.cfg.n_fft)),
              "dis_embed": jnp.asarray([[0.0, 0.0, 1.0]])}
    params = jnet.init(jax.random.PRNGKey(3), inputs)["params"]
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({"pl_module_args": {
        "model": "sound_bubble_tpu.models.tfgridnet.model.net_from_params",
        "model_params": SMALL}}))
    save_checkpoint(str(run / "checkpoints" / "best.pt"), {
        "model": params, "optimizer": {"state": optax.adam(1e-3).init(params)},
        "current_epoch": 1})
    tests = tmp_path / "syn_1m"
    _write_sample(tests / "00000", rng, 1000, [1.7])          # empty bubble
    _write_sample(tests / "00001", rng, 1000, [0.5, 2.5])
    _write_sample(tests / "00002", rng, 1003, [0.4, 0.8])     # not x 32
    return jnet, params, run, tests


def test_load_testcase_matches_jax(small_run):
    *_, tests = small_run
    for sample in sorted(tests.iterdir()):
        got = tev.load_testcase(str(sample), 24000, 1.0)
        want = jload_testcase(str(sample), 24000, 1.0)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3] and got[4] == want[4]


def test_streamed_run_testcase_matches_offline_jax(small_run):
    """run_testcase pads as Net(pad=True) does, so the streamed output is
    the offline output sample for sample, with the mixture's length."""
    jnet, params, _, tests = small_run
    _, mixture, _, _, _ = tev.load_testcase(str(tests / "00002"), 24000, 1.0)
    assert mixture.shape[-1] % SMALL["stft_chunk_size"]
    net = Net(make_config(SMALL))
    net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    got = tev.run_testcase(FusedStreamer(net, device="cpu"), mixture, 1.0)
    want = np.asarray(jnet.apply({"params": params}, {
        "mixture": jnp.asarray(mixture[None]),
        "dis_embed": jnp.asarray([tev.ONE_HOT[1.0]])})["output"])[0]
    assert got.shape == want.shape == (1, mixture.shape[-1])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cli_evaluate_dir_matches_jax(small_run, capsys):
    jnet, params, run, tests = small_run
    net = load_pretrained(str(run), device="cpu")
    sisdris, snris, decays = cli.evaluate_dir(
        FusedStreamer(net, device="cpu"), str(tests), 1.0)
    want_sisdri, want_snri, want_decay = [], [], []
    for sample in sorted(tests.iterdir()):
        _, mixture, gt, tgt, _ = jload_testcase(str(sample), 24000, 1.0)
        out = np.asarray(jnet.apply({"params": params}, {
            "mixture": jnp.asarray(mixture[None]),
            "dis_embed": jnp.asarray([tev.ONE_HOT[1.0]])})["output"])[0]
        mix0 = mixture[0:1]
        if tgt:
            want_sisdri.append(float(jm.Metrics("si_sdr_i")(out, gt, mix0)))
            want_snri.append(float(jm.Metrics("snr_i")(out, gt, mix0)))
        else:
            want_decay.append(float(jm.compute_decay(out, mix0)))
    assert len(sisdris) == 2 and len(decays) == 1
    np.testing.assert_allclose(sisdris, want_sisdri, atol=1e-3, rtol=0)
    np.testing.assert_allclose(snris, want_snri, atol=1e-3, rtol=0)
    np.testing.assert_allclose(decays, want_decay, atol=1e-3, rtol=0)
    assert "SI-SDR:" in capsys.readouterr().out


def test_cli_main_runs_on_cpu(small_run, capsys):
    *_, run, tests = small_run
    cli.main(cli.argparse.Namespace(
        test_dir=str(tests), run_dir=str(run), distance_threshold=1.0,
        sr=24000, save_id=-1, device="cpu"))
    out = capsys.readouterr().out
    assert "SISDRi:" in out and "DECAY = " in out


def test_invalid_distance_threshold_raises():
    with pytest.raises(ValueError):
        tev.one_hot(0.7)
