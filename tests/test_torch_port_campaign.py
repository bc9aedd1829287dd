"""The port's campaign datagen and trainer against the JAX package's, on the
CPU, at tiny sizes (<= 4 scenarios, rir_len <= 1000, max_order <= 3).

- `build_pool` (scenario geometry by `sample_scenario`, RIRs by
  `rirs_host_fast`), `radius_probs` and `scenario_probs`: numpy on the host
  from the same `np.random.Generator`, so equal exactly;
- `fft_conv` and `colored_noise` to 1e-5;
- the sources and the batch given the same draws: the JAX functions draw
  inside with `jax.random`; the test makes those draws with `jax.random`,
  key for key as the JAX function splits them (`_jax_*_draws`), and hands
  them to the port's synthesis (`formant_synth`, `speechlike_synth`,
  `make_batch`): 1e-5 of the peak. The batch covers voice="mix", the
  background-noise slot and the dense-overlap curriculum; its achieved SNR
  equals the target, as tests/test_campaign.py holds the JAX batch;
- `python -m sound_bubble_tpu_torch.train_stream --device cpu` at a tiny
  config (2 steps, 1 validation, checkpoints), then `--resume --no-bf16`:
  the run's recorded precision (bf16) is kept and said; the `best.pt` it
  wrote is read by the JAX package's `load_torch_pretrained` and gives the
  port's forward to 1e-4 of the output's peak."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sound_bubble_tpu import utils as jutils
from sound_bubble_tpu.datagen import campaign as jc
from sound_bubble_tpu.datagen import voice as jv
from sound_bubble_tpu.ops import fft_conv as jf
from sound_bubble_tpu.ops import noise as jn
from sound_bubble_tpu_torch import train_stream
from sound_bubble_tpu_torch.datagen import campaign as tc
from sound_bubble_tpu_torch.datagen import voice as tv
from sound_bubble_tpu_torch.ops import fft_conv as tf
from sound_bubble_tpu_torch.ops import noise as tn
from sound_bubble_tpu_torch.utils import load_pretrained
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "syn_experiments", "pretrain_stage.json")
TOL = 1e-5
SR, N = 8000, 4000
U = jax.random.uniform


def _t(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _pools():
    kw = dict(seed=1, sr=SR, rir_len=1000, order_range=(2, 3),
              bg_noise=True)
    jpool, jrad = jc.build_pool(4, dtype=jnp.float32, to_device=False,
                                verbose=False, **kw)
    tpool, trad = tc.build_pool(4, verbose=False, **kw)
    return jpool, jrad, tpool, trad


def test_pool_and_probs_match_jax():
    jpool, jrad, tpool, trad = _pools()
    assert set(jpool) == set(tpool)
    for k in jpool:
        np.testing.assert_array_equal(tpool[k], jpool[k], err_msg=k)
    np.testing.assert_array_equal(trad, jrad)
    np.testing.assert_array_equal(
        tc.radius_probs(tpool["dis_embed"], (1.0, 1.5, 2.5)),
        jc.radius_probs(jpool["dis_embed"], (1.0, 1.5, 2.5)))
    # weights only on the in-bubble counts this tiny pool holds
    nin = set(np.rint(tpool["near_mask"].sum(1)).astype(int).tolist())
    nw = tuple(float(i + 1) if i in nin else 0.0 for i in range(3))
    for rw, nw in (((1, 2, 3), None), (None, nw)):
        np.testing.assert_array_equal(
            tc.scenario_probs(tpool, rw, nw),
            jc.scenario_probs(jpool, rw, nw))


def test_fft_conv_and_colored_noise_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 500)).astype(np.float32)
    k = rng.standard_normal((3, 70)).astype(np.float32)
    for mode in ("full", "same", "valid"):
        want = np.asarray(jf.fft_conv(jnp.asarray(x), jnp.asarray(k), mode))
        got = tf.fft_conv(torch.from_numpy(x), torch.from_numpy(k), mode)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    key = jax.random.PRNGKey(1)
    for n in (N, N + 1):
        beta = jnp.asarray([0.0, 1.0, 1.7])
        kr, ki = jax.random.split(key)
        draws = {"re": jax.random.normal(kr, (3, n // 2 + 1)),
                 "im": jax.random.normal(ki, (3, n // 2 + 1))}
        want = np.asarray(jn.colored_noise_traced(key, beta, n))
        got = tn.colored_noise(torch.from_numpy(np.asarray(beta)),
                               _t(draws), n).numpy()
        assert got.shape == want.shape == (3, n)
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _jax_formant_draws(key, m, n, sr, sil_hi=None):
    """`formant_draws` made with jax.random as `voice.formant_voices`
    splits its key: one key a voice, 18 a voice."""
    _, _, n_syl, nf = tv.shapes(n, sr)
    lo = int(0.083 * sr)
    sh = (jnp.full((m,), tv.default_sil_hi(n, sr), jnp.float32)
          if sil_hi is None else jnp.asarray(sil_hi, jnp.float32))

    def one(k, s):
        ks = jax.random.split(k, 18)
        hi = jnp.maximum(s.astype(jnp.int32), lo + 1)
        d = {name: U(ks[i], (), minval=a, maxval=b) for i, (name, a, b) in
             zip((2, 12, 13, 14, 15), tv.SPEAKER_DRAWS)}
        d.update({name: U(ks[i], (n_syl,), minval=a, maxval=b)
                  for i, (name, a, b) in zip((0, 1, 3, 4, 5, 6, 16, 7),
                                             tv.SYLLABLE_DRAWS)})
        d["jitter"] = jax.random.normal(ks[8], (nf,))
        d["noise"] = jax.random.normal(ks[9], (n,))
        d["burst"] = jax.random.normal(ks[17], (n,))
        d["floor"] = jax.random.normal(ks[11], (n,))
        d["zs"] = jax.random.randint(ks[10], (), jnp.minimum(lo, hi - 1), hi)
        return d

    d = jax.vmap(one)(jax.random.split(key, m), sh)
    return {k: (v.long() if k == "zs" else v) for k, v in _t(d).items()}


def _jax_speechlike_draws(key, bs, n, sr):
    """`speechlike_draws` made as `campaign.speechlike_voices` splits its
    key."""
    kf, ka, kp, km, kg, kgp, kz, kzs = jax.random.split(key, 8)
    lo = int(0.083 * sr)
    hi = max(int(min(1.33 * sr, 0.4 * n)), lo + 1)
    d = {"f0": U(kf, bs + (1, 1), minval=110.0, maxval=220.0),
         "amps": U(ka, bs + (5, 1), minval=0.3, maxval=1.0),
         "phases": U(kp, bs + (5, 1), minval=0.0, maxval=6.28),
         "fm": U(km, bs + (1,), minval=2.0, maxval=5.0),
         "fg": U(kg, bs + (1,), minval=0.3, maxval=0.7),
         "pg": U(kgp, bs + (1,), minval=0.0, maxval=6.28),
         "z": jax.random.normal(kz, bs + (n,)),
         "zs": jax.random.randint(kzs, bs + (1,), lo, hi)}
    return {k: (v.long() if k == "zs" else v) for k, v in _t(d).items()}


def test_voices_match_jax_given_draws():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jv.formant_voices(key, (2, 3), N, SR))
    got = tv.formant_synth(_jax_formant_draws(key, 6, N, SR), N, SR)
    np.testing.assert_allclose(got.reshape(2, 3, N).numpy(), want, atol=TOL,
                               rtol=0)
    want = np.asarray(jc.speechlike_voices(key, (2, 3), N, SR))
    got = tc.speechlike_synth(_jax_speechlike_draws(key, (2, 3), N, SR), N,
                              SR)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the port's own draws: the distributions' ranges and the peak norm
    gen = torch.Generator().manual_seed(0)
    v = tv.formant_voices(gen, (2, 3), N, SR)
    assert v.shape == (2, 3, N) and torch.isfinite(v).all()
    np.testing.assert_allclose(v.abs().amax(-1).numpy(), 1.0, atol=1e-6)


def _jax_batch_draws(key, pool, idx, n, sr, snr_range, bg_noise_p,
                     dense2_p):
    """`batch_draws` made as `campaign.make_batch` splits its key (voice
    "mix", a background-noise pool)."""
    b, s = len(idx), pool["active"].shape[1]
    s_v = s - 1
    kv, kp, ks = jax.random.split(key, 3)
    kv, kb, kg = jax.random.split(kv, 3)
    kv, kd1, kd2, kd3 = jax.random.split(kv, 4)
    d = {"dense": jax.random.bernoulli(kd1, dense2_p, (b,)),
         "f0c": U(kd2, (b, 1), minval=105.0, maxval=215.0),
         "f0_pair": U(kd3, (b, 2), minval=-2.0 / 12, maxval=2.0 / 12)}
    two_in = np.asarray(pool["near_mask"])[idx].sum(1) >= 2.0
    dm = (two_in & np.asarray(d["dense"]))[:, None] & (np.arange(s_v) < 2)
    sil_hi = np.where(dm, 0.12 * sr, tv.default_sil_hi(n, sr)).reshape(-1)
    kv1, kv2, kc = jax.random.split(kv, 3)
    d["pick"] = jax.random.bernoulli(kc, 0.75, (b, s_v))
    kb1, kb2, kb3, kb4 = jax.random.split(kb, 4)
    kr, ki = jax.random.split(kb2)
    nf = n // 2 + 1
    d["bg"] = {"beta": U(kb1, (b,), minval=0.0, maxval=2.0),
               "noise": {"re": jax.random.normal(kr, (b, nf)),
                         "im": jax.random.normal(ki, (b, nf))},
               "depth": U(kb3, (b, 1), maxval=0.5),
               "fm": U(kb4, (b, 2), minval=0.1, maxval=1.0),
               "gate": jax.random.bernoulli(kg, bg_noise_p, (b, 1))}
    d["u"] = U(kp, (b, s, 1, 1))
    d["snr"] = U(ks, (b,), minval=snr_range[0], maxval=snr_range[1])
    out = _t(d)
    out["formant"] = _jax_formant_draws(kv1, b * s_v, n, sr, sil_hi)
    out["speechlike"] = _jax_speechlike_draws(kv2, (b, s_v), n, sr)
    return out


def test_make_batch_matches_jax_given_draws():
    jpool, _, tpool, _ = _pools()
    # scenario 0 with two speakers in the bubble: the dense-overlap pair
    for pool in (jpool, tpool):
        pool["near_mask"][0, :2] = pool["active"][0, :2] = 1.0
    tpool = {k: torch.from_numpy(np.array(v)) for k, v in tpool.items()}
    idx = np.asarray([0, 1, 2, 3])
    kw = dict(n_samples=N, sr=SR, snr_range=(-10.0, 5.0), voice="mix",
              bg_noise_p=0.5, dense2_p=0.9)
    key = jax.random.PRNGKey(5)
    want_in, want_tg = jc.make_batch(
        key, {k: jnp.asarray(v) for k, v in jpool.items()}, jnp.asarray(idx),
        **kw)
    draws = _jax_batch_draws(key, jpool, idx, N, SR, kw["snr_range"],
                             kw["bg_noise_p"], kw["dense2_p"])
    assert bool(draws["dense"][0])               # the curriculum engaged
    got_in, got_tg = tc.make_batch(tpool, torch.from_numpy(idx), draws, **kw)
    for got, want in ((got_in["mixture"], want_in["mixture"]),
                      (got_tg["target"], want_tg["target"])):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_array_equal(got_in["dis_embed"].numpy(),
                                  np.asarray(want_in["dis_embed"]))

    # the port's own draws: the achieved SNR is the target (one near and
    # one far speaker, no clipping renorm at this level)
    snr_pool = dict(tpool, near_mask=torch.tensor([[1.0, 0, 0, 0, 0]] * 4),
                    active=torch.tensor([[1.0, 1, 0, 0, 0]] * 4))
    kw.update(snr_range=(2.0, 2.0), bg_noise_p=0.0, dense2_p=0.0)
    gen = torch.Generator().manual_seed(0)
    sel = torch.arange(3)
    inputs, targets = tc.make_batch(
        snr_pool, sel, tc.batch_draws(gen, snr_pool, sel, **kw), **kw)
    mix, gt = inputs["mixture"].numpy(), targets["target"].numpy()
    for i in range(3):
        noise = mix[i, 0] - gt[i, 0]
        snr = 10 * np.log10(np.sum(gt[i, 0] ** 2) / np.sum(noise ** 2))
        assert abs(snr - 2.0) < 1e-2, (i, snr)


def _cli(run_dir, cfg_path, *extra):
    return ["--config", cfg_path, "--run_dir", run_dir, "--device", "cpu",
            "--pool", "3", "--val_pool", "2", "--val_batches", "1",
            "--batch", "2", "--clip_seconds", "0.25", "--rir_len", "1000",
            "--max_order", "2", "--val_every", "2", "--log_every", "1",
            "--voice", "mix", "--bg_noise", "0.5", *extra]


def test_train_stream_cli_runs_resumes_and_jax_reads_it(tmp_path, capsys):
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["pl_module_args"]["model_params"].update(
        stft_chunk_size=32, stft_pad_size=16, D=8, B=2, H=8)
    cfg_path, run_dir = str(tmp_path / "cfg.json"), str(tmp_path / "run")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    # two intra-op threads: the CLI shares the machine with the other test
    # workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "sound_bubble_tpu_torch.train_stream",
         *_cli(run_dir, cfg_path, "--steps", "2")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(run_dir, "train_stream_args.json")) as f:
        recipe = json.load(f)
    assert recipe == {"bf16": True, "voice": "mix", "batch": 2,
                      "clip_seconds": 0.25, "snr_range": [-10.0, 5.0],
                      "bg_noise": 0.5, "lstm_scan": "slab"}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2, 2]
    assert np.isfinite(logged[-1]["val_loss"])
    ckpt = os.path.join(run_dir, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["best.pt", "last.pt"]

    # resume with the other precision: the recorded bf16 is kept
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        mod = train_stream.main(train_stream.parse_args(_cli(
            run_dir, cfg_path, "--steps", "4", "--resume", "--no-bf16")))
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert ("RESUME: honoring the run's recorded precision bf16=True (flag "
            "said False)") in out
    assert "resumed from" in out and "at step 2" in out
    assert mod.net.cfg.compute_dtype == "bf16" and mod.epoch == 2
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 2, 3, 4, 4]

    # the campaign's best.pt through the JAX package's loader
    jmod = jutils.load_torch_pretrained(run_dir)
    rng = np.random.default_rng(4)
    inputs = {"mixture": rng.standard_normal((1, 6, 480)).astype(np.float32)
              * 0.1, "dis_embed": np.asarray([[0.0, 1.0, 0.0]], np.float32)}
    want = np.asarray(jmod.model(inputs)["output"])
    net = load_pretrained(run_dir, device="cpu")
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in inputs.items()})[
            "output"].numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
