"""Port parity, the rest of serving: the fused inference BLSTM (row 5 of
PERF.md's kernel table, `ops/kernels/lstm_kernel.py`) against the JAX
package's Pallas kernel in interpret mode, the model-level streaming paths
on it against the JAX package's, `streaming_inference_scan`, STOI and PESQ,
and the `eval_syn` / `eval` / `test_samples` CLIs against the JAX package's
CLIs on the same run dirs, on the CPU.

Tolerances: the BLSTM 1e-5 max-abs (fp32 both, another summation order over
2H terms: the plain version multiplies by the whole block-diagonal pack);
the whole model 1e-4 absolute (the repo's bar for whole-model parity; the
JAX reference runs its XLA scans, the plain reference of its tests, since a
Pallas kernel outside interpret mode needs a TPU); STOI and PESQ
bit-equal (the same numpy code on the same float32 values); the CLIs'
per-sample numbers 1e-4 (the same model output to 1e-4 through the same
metrics)."""
import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.io.wavfile
import torch

from sound_bubble_tpu import utils as jutils
from sound_bubble_tpu.metrics import metrics as jm
from sound_bubble_tpu.metrics import pesq as jpesq
from sound_bubble_tpu.metrics import stoi as jstoi
from sound_bubble_tpu.models.tfgridnet.model import make_net
from sound_bubble_tpu.ops.pallas.lstm_kernel import (
    _pack_weights, blstm_pallas)
from sound_bubble_tpu.runtime.streaming import ModelWrapper as JaxWrapper
from sound_bubble_tpu.runtime.streaming import \
    streaming_inference as jax_streaming
from sound_bubble_tpu_torch import eval as port_eval
from sound_bubble_tpu_torch import eval_syn as port_eval_syn
from sound_bubble_tpu_torch import evaluation as tev
from sound_bubble_tpu_torch import test_samples as port_test_samples
from sound_bubble_tpu_torch import utils as tutils
from sound_bubble_tpu_torch.metrics import metrics as tm
from sound_bubble_tpu_torch.metrics import pesq as tpesq
from sound_bubble_tpu_torch.metrics import stoi as tstoi
from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config
from sound_bubble_tpu_torch.ops import rnn
from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as lk
from sound_bubble_tpu_torch.runtime.streaming import (
    ModelWrapper, streaming_inference, streaming_inference_scan)
from sound_bubble_tpu_torch.train.module import PLModule
from sound_bubble_tpu_torch.weights import from_jax_params
from src import eval as jax_eval_cli
from src import eval_syn as jax_eval_syn_cli
from src import test_samples as jax_test_samples_cli
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
BLSTM_TOL = 1e-5
TOL = 1e-4
SMALL = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=3, H=8,
             L=2, E=2, use_attn=False, chunk_causal=True, use_first_ln=True,
             merge_method="early_cat", conv_lstm=False, dis_type="conv3")
VARIANTS = {"cond": {}, "conv_lstm": dict(conv_lstm=True, lstm_down=5)}
DIS = [[0.0, 1.0, 0.0]]


def _blstm_params(rng, c, h):
    """{fwd, bwd: {w_ih, w_hh, b}} as numpy, PyTorch's init range."""
    bound = 1 / np.sqrt(h)

    def u(*shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return {d: {"w_ih": u(c, 4 * h), "w_hh": u(h, 4 * h), "b": 2 * u(4 * h)}
            for d in ("fwd", "bwd")}


def _torch(tree):
    return {d: {k: torch.from_numpy(v) for k, v in p.items()}
            for d, p in tree.items()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("c, h", [(32, 64), (24, 64), (8, 8)])
def test_pack_matches_jax(c, h):
    params = _blstm_params(np.random.default_rng(c + h), c, h)
    got = lk.pack_blstm_infer(_torch(params))
    want = _pack_weights(_jax(params))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("r, t_len, c", [(2, 145, 32), (3, 29, 24)],
                         ids=["flagship", "conv"])
def test_blstm_infer_ref_matches_pallas(r, t_len, c):
    """Flagship width (F=145, C=32, H=64) and the conv_lstm width (k=29
    frames, C=24, H=64): the plain version against `blstm_pallas` run in
    interpret mode."""
    rng = np.random.default_rng(t_len)
    params = _blstm_params(rng, c, 64)
    x = rng.standard_normal((r, t_len, c)).astype(np.float32)
    want = np.asarray(blstm_pallas(_jax(params), jnp.asarray(x),
                                   interpret=True))
    got = lk.blstm_infer_ref(_torch(params), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (r, t_len, 128)
    assert np.abs(got - want).max() <= BLSTM_TOL


def test_blstm_infer_on_cpu_is_its_plain_version():
    rng = np.random.default_rng(1)
    params = _torch(_blstm_params(rng, 8, 8))
    x = torch.from_numpy(rng.standard_normal((4, 9, 8)).astype(np.float32))
    before = lk.blstm_infer.launches
    got = lk.blstm_infer(params, x)
    np.testing.assert_array_equal(got.numpy(),
                                  lk.blstm_infer_ref(params, x).numpy())
    assert lk.blstm_infer.launches == before       # no kernel on the CPU


@pytest.mark.parametrize("shape, c, h", [((3, 11, 8), 8, 8),
                                         ((2, 145, 32), 32, 64)])
def test_rnn_blstm_switch_matches_the_scans(shape, c, h):
    """rnn.blstm(pallas_blstm=True) on the CPU equals the slab route; a 4-D
    input keeps the scans, as in the JAX package."""
    rng = np.random.default_rng(2)
    params = _torch(_blstm_params(rng, c, h))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        got = rnn.blstm(params, x, pallas_blstm=True)
        want = rnn.blstm(params, x)
        assert np.abs((got - want).numpy()).max() <= BLSTM_TOL
        x4 = x[None]
        np.testing.assert_array_equal(
            rnn.blstm(params, x4, pallas_blstm=True).numpy(),
            rnn.blstm(params, x4).numpy())


def test_rnn_blstm_switch_refuses_bf16_and_grad():
    rng = np.random.default_rng(3)
    params = _torch(_blstm_params(rng, 8, 8))
    x = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    with pytest.raises(NotImplementedError):
        rnn.blstm(params, x.bfloat16(), pallas_blstm=True)
    bf16 = {d: {k: v.bfloat16() for k, v in p.items()}
            for d, p in params.items()}
    with pytest.raises(NotImplementedError):
        rnn.blstm(bf16, x, pallas_blstm=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rnn.blstm(params, x.requires_grad_(), pallas_blstm=True)
    params["fwd"]["w_hh"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        rnn.blstm(params, x.detach(), pallas_blstm=True)
    with torch.no_grad():                    # inference: allowed
        rnn.blstm(params, x, pallas_blstm=True)


def test_pallas_blstm_from_env():
    assert rnn.pallas_blstm_from_env({}) is False
    assert rnn.pallas_blstm_from_env({"SB_PALLAS_BLSTM": "0"}) is False
    assert rnn.pallas_blstm_from_env({"SB_PALLAS_BLSTM": "1"}) is True


def test_row_tile():
    """(rows a block, blocks) of row 5's grid, one half a direction: the
    fewest rows for one wave of 132 SMs (1 row up to R = 66; the offline
    R = 250 at 4); at C = 24 the same."""
    rs = (1, 4, 66, 67, 250, 1252)
    want = [(1, 2), (1, 8), (1, 132), (2, 68), (4, 126), (19, 132)]
    assert [lk.row_tile(r, 32, 132) for r in rs] == want
    assert [lk.row_tile(r, 24, 132) for r in rs] == want


def _pair(variant, x):
    """(JAX net, JAX params, port Net on row 5) with the same weights."""
    model_params = {**SMALL, **VARIANTS[variant]}
    jnet = make_net(model_params, conditional=True)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), {
        "mixture": jnp.asarray(x[..., :jnet.cfg.n_fft]),
        "dis_embed": jnp.asarray(DIS)})["params"]
    net = Net(make_config(model_params), pallas_blstm=True)
    net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net.eval()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_wrapper_on_row5_matches_jax(variant, rng):
    """The port's ModelWrapper loop with every intra BLSTM on row 5 against
    the JAX ModelWrapper loop; then streaming_inference_scan (dir_fuse on:
    row 5) and the scan on the slab route against the loop."""
    chunk, pad = SMALL["stft_chunk_size"], SMALL["stft_pad_size"]
    x = rng.standard_normal((1, 6, pad + chunk * 6)).astype(np.float32) * 3
    jnet, params, net = _pair(variant, x)
    want = np.asarray(jax_streaming(JaxWrapper(jnet, params), x, chunk, pad,
                                    dis_embed=DIS))
    calls = []
    orig = lk.blstm_recur_ref
    lk.blstm_recur_ref = lambda gx, w: calls.append(1) or orig(gx, w)
    try:
        loop = streaming_inference(ModelWrapper(net, device="cpu"), x, chunk,
                                   pad, dis_embed=DIS)
        scan = streaming_inference_scan(net, x, chunk, pad, dis_embed=DIS,
                                        device="cpu")
    finally:
        lk.blstm_recur_ref = orig
    assert len(calls) == 2 * 6 * SMALL["B"]     # B a chunk, both paths
    np.testing.assert_allclose(loop.numpy(), want, atol=TOL, rtol=0)
    assert scan.shape == loop.shape == want.shape
    np.testing.assert_allclose(scan.numpy(), loop.numpy(), atol=TOL, rtol=0)
    slab = streaming_inference_scan(net, x, chunk, pad, dis_embed=DIS,
                                    dir_fuse=False, device="cpu")
    np.testing.assert_allclose(slab.numpy(), want, atol=TOL, rtol=0)
    assert net.pallas_blstm is True          # the call flipped no state


def test_model_wrapper_takes_a_model_handle(rng):
    chunk, pad = SMALL["stft_chunk_size"], SMALL["stft_pad_size"]
    x = rng.standard_normal((1, 6, pad + chunk * 3)).astype(np.float32)
    net = Net(make_config(SMALL), pallas_blstm=True).init_weights(
        torch.Generator().manual_seed(0))

    class Module:                   # a PLModule's shape, without training
        pass

    from sound_bubble_tpu_torch.train.module import ModelHandle
    module = Module()
    module.net = net
    handle = ModelHandle(module)
    got = streaming_inference(ModelWrapper(handle, device="cpu"), x, chunk,
                              pad)
    want = streaming_inference(ModelWrapper(net, device="cpu"), x, chunk,
                               pad)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _speech_like(rng, n, fs):
    t = np.arange(n) / fs
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    return (env * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_stoi_pesq_copies_are_bit_equal():
    """The port's copies give JAX's numbers bit for bit: PESQ on the
    fixture set, STOI on seeded signals at 10 kHz (no resampling) and at
    24 kHz."""
    data = np.load(REPO / "tests" / "fixtures" / "pesq_set.npz")
    keys = [k[4:] for k in data.files if k.startswith("ref_")]
    for key in keys:
        ref, deg = data[f"ref_{key}"], data[f"deg_{key}"]
        assert tpesq.pesq_nb(ref, deg, fs=16000) == \
            jpesq.pesq_nb(ref, deg, fs=16000), key
    rng = np.random.default_rng(4)
    for fs, n in ((10000, 8000), (24000, 12000)):
        clean = _speech_like(rng, n, fs)
        noisy = clean + 0.3 * rng.standard_normal(n).astype(np.float32)
        assert tstoi.stoi(clean, noisy, fs) == jstoi.stoi(clean, noisy, fs)


def test_pesq_of_a_clip_with_no_frame_is_nan():
    """The one change from the JAX copy: a clip the alignment leaves no
    whole frame of scores NaN, where the JAX copy raises."""
    # 669 samples, the energy of ref at its end and of deg at its start:
    # the envelope correlation peaks at a lag past the clip's end
    burst = np.random.default_rng(6).standard_normal(100).astype(np.float32)
    ref, deg = np.zeros((2, 669), np.float32)
    ref[-100:], deg[:100] = burst, burst
    with pytest.raises(ValueError):
        jpesq.pesq_nb(ref, deg, fs=16000)
    assert np.isnan(tpesq.pesq_nb(ref, deg, fs=16000))
    # a clip with no whole frame: NaN in both
    assert np.isnan(tpesq.pesq_nb(ref[:300], ref[:300], fs=16000))
    assert np.isnan(jpesq.pesq_nb(ref[:300], ref[:300], fs=16000))


@pytest.mark.parametrize("name", ["STOI", "PESQ"])
def test_perceptual_metrics_match_jax(name):
    rng = np.random.default_rng(5)
    gt = np.stack([_speech_like(rng, 12000, 24000)[None] for _ in range(2)])
    est = (gt + 0.2 * rng.standard_normal(gt.shape)).astype(np.float32)
    got = tm.Metrics(name)(est, gt, gt).numpy()
    want = np.asarray(jm.Metrics(name)(est, gt, gt))
    assert got.shape == want.shape == (2,)
    np.testing.assert_array_equal(got, want)


def test_train_step_skips_perceptual_metrics(monkeypatch):
    """STOI and PESQ are validation-only (JAX `train/module.py:398`): a
    train step never computes them, a validation step does."""
    from sound_bubble_tpu_torch.data.synth import golden_batch

    with open(REPO / "syn_experiments" / "pretrain_stage.json") as f:
        args = json.load(f)["pl_module_args"]
    args["model_params"] = {**args["model_params"], "D": 8, "H": 8, "B": 2}
    args["metrics"] = ["si_sdr_i", "STOI", "PESQ"]
    np.random.seed(0)
    module = PLModule(**args, device="cpu")
    calls = []
    for key in ("STOI", "PESQ"):
        monkeypatch.setitem(tm._HOST, key,
                            lambda est, gt, fs, k=key: calls.append(k)
                            or torch.zeros(est.shape[:-1]))
    inputs, targets = golden_batch(0)
    inputs["mixture"] = inputs["mixture"][..., :4800]
    targets["target"] = targets["target"][..., :4800]
    module.training_step((inputs, targets))
    assert calls == []
    assert "train/si_sdr_i" in module.metric_values[0]
    module.validation_step((inputs, targets))
    assert sorted(set(calls)) == ["PESQ", "STOI"]
    assert "val/STOI" in module.metric_values[0]


def test_unported_metric_still_raises():
    with pytest.raises(NotImplementedError):
        tm.Metrics("WavLM")


def test_write_records_csv_matches_pandas(tmp_path):
    records = [{"sample": "00000", "n_tgt_speakers": 0, "decay": 12.5},
               {"sample": "00001", "n_tgt_speakers": 2,
                "snri": -0.30000000000000004, "stoi": float("nan")},
               {"sample": "a,b", "n_tgt_speakers": 1, "snri": 1e-07}]
    tev.write_records_csv(tmp_path / "port.csv", records)
    pd.DataFrame.from_records(records).to_csv(tmp_path / "pandas.csv")
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "pandas.csv").read_text()


# ------------------------------------------------------------ the CLIs ----

CLI_SMALL = dict(stft_chunk_size=32, stft_pad_size=16, D=8, B=2, H=8)
# the first word of each line eval_syn prints per sample and at the end
EVAL_SYN_LINES = {"Sample:", "Decay:", "SI-SDR:", "pesq_in=", "stoi_in=",
                  "DECAY", "SNR:", "SISDR:", "pesq", "stoi"}


def test_model_wrapper_ignores_pad_as_jax(rng):
    """ModelWrapper.feed(..., pad=True) steps the net with pad=False, as
    the JAX package's wrapper does: chunk by chunk, the two wrappers on the
    same seeded weights agree at the whole-model bar."""
    chunk, pad = SMALL["stft_chunk_size"], SMALL["stft_pad_size"]
    x = rng.standard_normal((1, 6, pad + chunk * 4)).astype(np.float32) * 3
    jnet, params, net = _pair("cond", x)
    net.pallas_blstm = False
    jax_wrap, port_wrap = JaxWrapper(jnet, params), ModelWrapper(net,
                                                                 "cpu")
    for k in range(4):
        window = x[..., k * chunk:k * chunk + chunk + pad]
        want = np.asarray(jax_wrap.feed(window, dis_embed=DIS, pad=True))
        got = port_wrap.feed(window, dis_embed=DIS, pad=True)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


class _MetricsBuilt(Exception):
    pass


def _record_metric_fs(monkeypatch, module, metrics_cls):
    """Replace `module.Metrics` by one that records (name, fs) and stops
    the CLI once its STOI and PESQ metrics exist."""
    built = {}

    def make(name, *args, **kwargs):
        metric = metrics_cls(name, *args, **kwargs)
        if name in ("STOI", "PESQ"):
            built[name] = metric.fs
        if len(built) == 2:
            raise _MetricsBuilt
        return metric

    monkeypatch.setattr(module, "Metrics", make)
    return built


@pytest.mark.parametrize("cli", ["eval_syn", "test_samples"])
def test_cli_perceptual_metrics_fs_as_jax(cli, cli_runs, tmp_path,
                                          monkeypatch):
    """At --sr 16000 each CLI builds STOI and PESQ at the fs the JAX
    package's CLI gives them (Metrics' default, 24 kHz)."""
    runs, tests = cli_runs
    common = dict(test_dir=str(tests), run_dir=str(runs["cond"]),
                  distance_threshold=1.0, save_id=-1)
    want = _record_metric_fs(monkeypatch, {
        "eval_syn": jax_eval_syn_cli,
        "test_samples": jax_test_samples_cli}[cli], jm.Metrics)
    jax_args = (_jax_args(**common, output_dir=str(tmp_path / "jax"))
                if cli == "eval_syn" else _jax_args(**common))
    jax_args.sr = 16000
    with pytest.raises(_MetricsBuilt):
        (jax_eval_syn_cli if cli == "eval_syn"
         else jax_test_samples_cli).main(jax_args)
    port = {"eval_syn": port_eval_syn, "test_samples": port_test_samples}[cli]
    got = _record_metric_fs(monkeypatch, port, tm.Metrics)
    with pytest.raises(_MetricsBuilt):
        if cli == "eval_syn":
            port_eval_syn.main(port_eval_syn.parser().parse_args([
                str(tests), str(runs["cond"]), str(tmp_path / "port"),
                "--sr", "16000", "--device", "cpu"]))
        else:
            port_test_samples.main(port_test_samples.argparse.Namespace(
                **common, sr=16000, device="cpu"))
    assert want == {"STOI": 24000, "PESQ": 24000}
    assert got == want


def _write_sample(path, rng, n, dists):
    path.mkdir(parents=True)
    meta = {"real": False, "room_info": {"rt60": 0.3}}
    mixture = 0.05 * rng.standard_normal((n, 6))
    for k, d in enumerate(dists):
        voice = 0.3 * _speech_like(rng, n, 24000)
        mixture += voice[:, None]
        scipy.io.wavfile.write(path / f"mic00_voice{k:02d}.wav", 24000,
                               (voice * 32767 * 0.5).astype(np.int16))
        meta[f"voice{k:02d}"] = {"dis": d, "angle": 10.0 * k}
    scipy.io.wavfile.write(path / "mixture.wav", 24000,
                           (mixture * 32767 * 0.5).astype(np.int16))
    (path / "metadata.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Run dirs written by the JAX package's PLModule (config.json +
    best.pt with its optimizer state), conditioned and unconditioned, and a
    3-sample test dir: an empty bubble and a sample with targets of 0.5 s
    each, and a 0.3 s sample with targets (too short for STOI: NaN)."""
    root = tmp_path_factory.mktemp("serving_cli")
    with open(REPO / "syn_experiments" / "pretrain_stage.json") as f:
        base = json.load(f)
    runs = {}
    for name, model in (("cond", "net_from_params"),
                        ("uncond", "net_optim_from_params")):
        cfg = json.loads(json.dumps(base))
        args = cfg["pl_module_args"]
        args["model"] = f"sound_bubble_tpu.models.tfgridnet.model.{model}"
        args["model_params"] = {**args["model_params"], **CLI_SMALL}
        run = root / name
        (run / "checkpoints").mkdir(parents=True)
        (run / "config.json").write_text(json.dumps(cfg))
        np.random.seed(7)
        jutils.load_net(str(run / "config.json")).dump_state(
            str(run / "checkpoints" / "best.pt"))
        runs[name] = run
    rng = np.random.default_rng(0)
    tests = root / "syn_1m"
    # six-digit names: `--save_id N` reads sample {N:06d}
    _write_sample(tests / "000000", rng, 12000, [1.7])
    _write_sample(tests / "000001", rng, 12000, [0.5, 2.5])
    _write_sample(tests / "000002", rng, 7203, [0.4, 0.8])
    return runs, tests


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_same_csv(got_path, want_path):
    got, want = _csv_rows(got_path), _csv_rows(want_path)
    assert got[0] == want[0]                       # the same columns
    assert len(got) == len(want)
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(got[0], g_row, w_row):
            if col in ("", "sample", "n_tgt_speakers") or w == "":
                assert g == w, (col, g, w)
            else:
                assert abs(float(g) - float(w)) <= TOL, (col, g, w)


def _jax_args(**kw):
    import argparse
    return argparse.Namespace(sr=24000, use_cuda=False, **kw)


def test_eval_syn_cli_matches_jax(cli_runs, tmp_path, capsys):
    runs, tests = cli_runs
    jax_eval_syn_cli.main(_jax_args(
        test_dir=str(tests), run_dir=str(runs["cond"]),
        output_dir=str(tmp_path / "jax"), distance_threshold=1.0,
        save_id=-1))
    jax_out = capsys.readouterr().out
    port_eval_syn.main(port_eval_syn.parser().parse_args([
        str(tests), str(runs["cond"]), str(tmp_path / "port"),
        "--distance_threshold", "1.0", "--device", "cpu"]))
    port_out = capsys.readouterr().out
    _assert_same_csv(tmp_path / "port" / "results.csv",
                     tmp_path / "jax" / "results.csv")
    header = _csv_rows(tmp_path / "port" / "results.csv")[0]
    assert {"decay", "sisdri", "stoi", "pesq", "stoi_in"} <= set(header)
    infos = json.loads((tmp_path / "port" / "infos.json").read_text())
    assert infos == json.loads((tmp_path / "jax" / "infos.json").read_text())
    got_args = json.loads((tmp_path / "port" / "args.json").read_text())
    want_args = json.loads((tmp_path / "jax" / "args.json").read_text())
    assert set(got_args) - set(want_args) == {"device"}
    assert set(want_args) <= set(got_args)

    def heads(out):
        return [line.split()[0] for line in out.splitlines()
                if line.split()[0] in EVAL_SYN_LINES]

    # the same printed lines, then the row-5 launch count (none on the CPU)
    assert heads(port_out) == heads(jax_out)
    assert len(heads(jax_out)) == 3 + 1 + 2 * 3 + 5
    assert port_out.splitlines()[-1] == "blstm_infer launches: 0"


def test_eval_syn_cli_on_row5_equals_the_scans(cli_runs, tmp_path,
                                               monkeypatch, capsys):
    """SB_PALLAS_BLSTM=1: every intra BLSTM of the offline forward on row 5
    (its plain version on the CPU), the same results as the scans."""
    runs, tests = cli_runs
    calls = []
    orig = lk.blstm_recur_ref
    monkeypatch.setattr(lk, "blstm_recur_ref",
                        lambda gx, w: calls.append(gx.shape) or orig(gx, w))
    for env, out in (("0", "scans"), ("1", "row5")):
        monkeypatch.setenv("SB_PALLAS_BLSTM", env)
        port_eval_syn.main(port_eval_syn.parser().parse_args([
            str(tests), str(runs["cond"]), str(tmp_path / out),
            "--device", "cpu"]))
    capsys.readouterr()
    # B = 2 blocks a sample, R = frames of each padded clip, T = F = 25
    assert len(calls) == 2 * 3 and all(s[1:] == (25, 64) for s in calls)
    _assert_same_csv(tmp_path / "row5" / "results.csv",
                     tmp_path / "scans" / "results.csv")


def test_eval_cli_unconditioned_matches_jax(cli_runs, tmp_path, capsys):
    """`eval --distance_threshold -1`: no dis_embed, the target the
    speakers within --gt_threshold."""
    runs, tests = cli_runs
    jax_eval_cli.main(_jax_args(
        test_dir=str(tests), run_dir=str(runs["uncond"]),
        output_dir=str(tmp_path / "jax"), distance_threshold=-1.0,
        gt_threshold=1.0))
    port_eval.main(port_eval.parser().parse_args([
        str(tests), str(runs["uncond"]), str(tmp_path / "port"),
        "--distance_threshold", "-1", "--gt_threshold", "1.0",
        "--device", "cpu"]))
    capsys.readouterr()
    _assert_same_csv(tmp_path / "port" / "results.csv",
                     tmp_path / "jax" / "results.csv")
    got_args = json.loads((tmp_path / "port" / "args.json").read_text())
    assert got_args["distance_threshold"] == -1 and \
        got_args["gt_threshold"] == 1.0


def test_save_id_writes_debug_wavs(cli_runs, tmp_path, monkeypatch, capsys):
    """--save_id N: sample {N:06d} alone, its mixture, estimate and target
    in ./debug/, no results.csv (eval_syn); the same for test_samples."""
    runs, tests = cli_runs
    monkeypatch.chdir(tmp_path)
    port_eval_syn.main(port_eval_syn.parser().parse_args([
        str(tests), str(runs["cond"]), str(tmp_path / "out"), "--save_id",
        "1", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert "Sample: 000001" in out and out.count("Sample:") == 1
    for tag in ("mix", "est", "gt"):
        sr, wav = scipy.io.wavfile.read(tmp_path / "debug" /
                                        f"{tag}000001.wav")
        assert sr == 24000 and wav.shape == (12000,)
        (tmp_path / "debug" / f"{tag}000001.wav").unlink()
    assert not (tmp_path / "out" / "results.csv").exists()

    port_test_samples.main(port_test_samples.argparse.Namespace(
        test_dir=str(tests), run_dir=str(runs["cond"]),
        distance_threshold=1.0, sr=24000, save_id=2, device="cpu"))
    out = capsys.readouterr().out
    assert out.count("Sample:") == 1 and "stoi_in=" in out
    assert sorted(p.name for p in (tmp_path / "debug").iterdir()) == [
        "est000002.wav", "gt000002.wav", "mix000002.wav"]


def test_load_torch_pretrained_and_offline_testcase(cli_runs):
    """The run's PLModule (weights of best.pt, the row-5 switch), its
    `model` handle through run_testcase_offline against the JAX package's
    run_testcase."""
    from sound_bubble_tpu.evaluation import run_testcase as jax_run
    runs, tests = cli_runs
    module = tutils.load_torch_pretrained(str(runs["cond"]), device="cpu",
                                          pallas_blstm=True)
    assert isinstance(module, PLModule) and module.net.pallas_blstm
    assert all(blk.intra.pallas_blstm for blk in module.net.blocks())
    net = tutils.load_pretrained(str(runs["cond"]), device="cpu")
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(module.net.state_dict()[k].numpy(),
                                      v.numpy())
    _, mixture, _, _, _ = tev.load_testcase(str(tests / "000002"), 24000,
                                            1.0)
    got = tev.run_testcase_offline(module.model, mixture, 1.0)
    want = jax_run(jutils.load_torch_pretrained(str(runs["cond"])).model,
                   mixture, None, 1.0)
    assert got.shape == want.shape == (1, mixture.shape[-1])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    params = tutils.Params(str(runs["cond"] / "config.json"))
    assert params.dict["pl_module_args"]["model_params"]["H"] == 8
