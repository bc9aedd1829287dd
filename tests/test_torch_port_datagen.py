"""The port's datagen against the JAX package's, on the CPU, at tiny sizes
(order <= 12, rir_len <= 8192 with chunk 512, clips <= 0.5 s).

- `ism`: `compute_rir`, `ShoeBox` (`compute_rirs`, `simulate`,
  `measure_rt60`) and `measure_rt60` are numpy copies: equal to 1e-12;
  `compute_rirs_torch` against `compute_rirs_jax` (float32, one complex sum
  over every image) to 1e-4 of each RIR's peak;
- `campaign.rirs_on_device` on the CPU against JAX's (float32, chunked over
  images, another summation order and other cos / sin) to 1e-4 of each
  slot's peak (measured ~3e-5), with and without `delay_trim`;
  `build_pool(method="device", device="cpu")` against JAX's
  `build_pool(method="device")`: geometry equal, RIRs to 1e-4 of the peak;
- `mixing`: numpy copies, equal; `snr_at_reference` to 1e-5 dB (both in
  float32);
- `generate`: the same `np.random` seed and clips write sample dirs with the
  same `metadata.json` and the same wav bytes, with and without background
  noise; the source loaders (`load_voice_clip`, `get_noise`,
  `trim_silence`) give the same arrays from the same wav files;
- `noise` and `on_device`: given the JAX function's own draws, made with
  `jax.random` key for key as the JAX function splits its key
  (`_jax_*_draws`), every function and `make_training_batch` match to 1e-5
  of the peak; the port's `mix_to_target_snr` lands on its target to 1e-3
  dB, as tests/test_on_device_datagen.py holds JAX's;
- `voice.formant_speechlike` takes one integer from the caller's generator,
  as JAX's does, and gives a peak-normalized float64 voice.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.datagen import campaign as jc
from sound_bubble_tpu.datagen import generate as jg
from sound_bubble_tpu.datagen import ism as ji
from sound_bubble_tpu.datagen import mixing as jm
from sound_bubble_tpu.datagen import on_device as jo
from sound_bubble_tpu.datagen import voice as jv
from sound_bubble_tpu.ops import noise as jn
from sound_bubble_tpu_torch.data.audio_io import write_audio_file
from sound_bubble_tpu_torch.datagen import campaign as tc
from sound_bubble_tpu_torch.datagen import generate as tg
from sound_bubble_tpu_torch.datagen import ism as ti
from sound_bubble_tpu_torch.datagen import mixing as tm
from sound_bubble_tpu_torch.datagen import on_device as to
from sound_bubble_tpu_torch.datagen import voice as tv
from sound_bubble_tpu_torch.ops import noise as tn
from torch_port_threads import one_torch_thread  # noqa: F401

FS = 24000
TOL = 1e-5          # float32 synthesis given the same draws, / peak
RIR_TOL = 1e-4      # float32 image sums in another order, / peak
ROOM, SRC = [5.0, 4.0, 3.0], [2.0, 1.5, 1.4]
MICS = np.array([[1.0, 2.0, 1.5], [1.2, 2.1, 1.5]], np.float32)


def _t(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _rel(got, want, axis=None):
    got, want = np.asarray(got), np.asarray(want)
    return (np.abs(got - want).max(axis=axis)
            / np.abs(want).max(axis=axis))


# ------------------------------------------------------------------ ism ----

@pytest.mark.parametrize("case", [
    ([50, 50, 50], [1.0, 1.0, 1.0], [4.0, 1.0, 1.0], 0, 2000, 0.5),
    ([100, 100, 100], [5.0, 5.0, 1.5], [2.2, 5.0, 1.5], 0, 4000, 0.5),
    (ROOM, SRC, MICS[0], 8, 8192, 0.4)], ids=["direct", "itd", "order8"])
def test_compute_rir_matches_jax(case):
    room, src, mic, order, rir_len, absorption = case
    imgs, refl = ji.shoebox_images(room, src, order)
    want = ji.compute_rir(imgs, refl, mic, FS, rir_len, absorption)
    got = ti.compute_rir(imgs, refl, mic, FS, rir_len, absorption)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _rooms(mod, rng):
    room = mod.ShoeBox([5, 4, 3], fs=FS, max_order=8, absorption=0.4)
    room.add_microphone_array(np.array([[2.0, 2.0, 1.5],
                                        [2.1, 2.0, 1.5]]).T)
    room.add_source([1.0, 1.0, 1.5], rng.standard_normal(FS // 4))
    room.add_source([4.0, 3.0, 1.5], rng.standard_normal(FS // 4))
    rt_rooms = []
    for absorption in (0.2, 0.7):
        box = mod.ShoeBox([6, 5, 3], fs=FS, max_order=12,
                          absorption=absorption)
        box.add_microphone_array(np.array([[3.0, 2.0, 1.5]]).T)
        box.add_source([1.0, 1.0, 1.5], signal=np.ones(10))
        rt_rooms.append(box)
    return room, rt_rooms


def test_shoebox_matches_jax():
    (jroom, jrt), (troom, trt) = (_rooms(ji, np.random.default_rng(0)),
                                  _rooms(ti, np.random.default_rng(0)))
    for a, b in zip(troom.compute_rirs(), jroom.compute_rirs()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    got, want = troom.simulate(True), jroom.simulate(True)
    assert got.shape == want.shape == (2, 2, got.shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(troom.simulate(False), jroom.simulate(False),
                               rtol=0, atol=1e-12)
    rts = []
    for a, b in zip(trt, jrt):
        rt = a.measure_rt60()
        np.testing.assert_allclose(rt, b.measure_rt60(), rtol=0, atol=1e-12)
        rts.append(float(rt.mean()))
    assert rts[1] < rts[0]
    rir = trt[0].compute_rirs()[0][0]
    assert ti.measure_rt60(rir, FS) == ji.measure_rt60(rir, FS)
    assert ti.SPEED_OF_SOUND == ji.SPEED_OF_SOUND and ti.FDL == ji.FDL


def test_compute_rirs_torch_matches_jax():
    imgs, refl = ji.shoebox_images(ROOM, SRC, 6)
    want = np.asarray(ji.compute_rirs_jax(imgs, refl, MICS, FS, 3000, 0.4))
    got = ti.compute_rirs_torch(imgs, refl, MICS, FS, 3000, 0.4,
                                device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want, axis=-1).max() <= RIR_TOL


# ------------------------------------------------------------- campaign ----

@pytest.mark.parametrize("order,trim", [(8, None), (10, None),
                                        (10, (0.0, 300.0))],
                         ids=["order8", "order10", "delay_trim"])
def test_rirs_on_device_matches_jax(order, trim):
    srcs = [SRC, [3.5, 2.5, 1.2]][:1 if trim is None else 2]
    per = [ji.shoebox_images(ROOM, s, order) for s in srcs]
    n = max(len(im) for im, _ in per)
    images = np.zeros((len(per), n, 3), np.float32)
    n_refl = np.zeros((len(per), n), np.float32)
    mask = np.zeros((len(per), n), np.float32)
    for s, (im, nr) in enumerate(per):
        images[s, :len(im)], n_refl[s, :len(im)], mask[s, :len(im)] = \
            im, nr, 1.0
    rho = np.float32(np.sqrt(0.6))
    args = (images, n_refl, mask, MICS, rho)
    dt = None if trim is None else np.asarray(trim, np.float32)
    want = np.asarray(jc.rirs_on_device(
        *map(jnp.asarray, args), fs=FS, rir_len=8192, chunk=512,
        delay_trim=None if dt is None else jnp.asarray(dt)))
    got = tc.rirs_on_device(
        *map(torch.as_tensor, args), fs=FS, rir_len=8192, chunk=512,
        delay_trim=None if dt is None else torch.as_tensor(dt))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want, axis=(1, 2)).max() <= RIR_TOL


def test_build_pool_device_matches_jax():
    kw = dict(seed=3, sr=8000, rir_len=1000, order_range=(2, 3),
              bg_noise=True, verbose=False)
    want, jrad = jc.build_pool(2, method="device", dtype=jnp.float32,
                               to_device=False, **kw)
    got, trad = tc.build_pool(2, method="device", device="cpu", **kw)
    host, _ = tc.build_pool(2, **kw)
    assert set(got) == set(want) == set(host)
    for k in got:
        assert got[k].dtype == np.float32
        if k != "rirs":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(host[k], want[k], err_msg=k)
    np.testing.assert_array_equal(trad, jrad)
    assert _rel(got["rirs"], want["rirs"], axis=(1, 2, 3)).max() <= RIR_TOL
    with pytest.raises(ValueError, match="method"):
        tc.build_pool(1, method="gpu", **kw)


# --------------------------------------------------------------- mixing ----

def test_mixing_matches_jax():
    rng = np.random.default_rng(0)
    near = [rng.standard_normal((6, 8000)) * 0.3]
    far = [rng.standard_normal((6, 8000)) * 0.5,
           rng.standard_normal((6, 8000)) * 0.2]
    hat = [near[0] + 0.01 * rng.standard_normal((6, 8000))]
    for target, gt in ((-3.7, near), (2.5, hat), (40.0, hat)):
        want_snr, want_far = jm.rescale_mixture_to_target_snr(
            near, far, gt, target)
        got_snr, got_far = tm.rescale_mixture_to_target_snr(
            near, far, gt, target)
        assert got_snr == want_snr
        for a, b in zip(got_far, want_far):
            np.testing.assert_array_equal(a, b)
        mixture = near[0] + sum(got_far)
        got = tm.snr_at_reference(mixture, gt)
        assert abs(got - jm.snr_at_reference(mixture, gt)) <= 1e-5
        if gt is near:
            assert abs(got - target) < 1e-3


# ------------------------------------------------------------- generate ----

def _clips(n, seed):
    rng = np.random.default_rng(seed)
    clips = [(rng.standard_normal(FS // 2), f"spk{i}") for i in range(n)]
    return [(a / np.abs(a).max(), s) for a, s in clips]


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("n_in,bg", [(1, False), (2, True), (0, True)])
def test_generate_sample_matches_jax(n_in, bg, tmp_path):
    clips = _clips(n_in + 2, n_in)
    noise = np.random.default_rng(9).standard_normal(FS // 2) if bg else None
    for name, mod in (("jax", jg), ("port", tg)):
        np.random.seed(3 + n_in)
        mod.generate_sample(clips, noise, n_in,
                            output_dir=str(tmp_path / name / "00000"),
                            sr=FS, duration=0.5, n_out_range=(2, 2),
                            dis_threshold=1.0, snr_range=(-5, 5),
                            max_order_range=(6, 12))
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert len(got) == n_in + 2      # mixture, metadata, a wav a target
    for k in want:
        assert got[k] == want[k], k
    meta = json.loads(got[os.path.join("00000", "metadata.json")])
    assert meta["n_in"] == n_in and meta["n_BG"] == int(bg)


def test_source_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    files = []
    for i, sr in enumerate((48000, 24000, 16000)):
        t = np.arange(int(0.6 * sr)) / sr
        sig = np.sin(2 * np.pi * (150 + 50 * i) * t) * (t > 0.1)
        sig = 0.5 * sig + 0.01 * rng.standard_normal(len(t))
        path = str(tmp_path / f"v{i}.wav")
        write_audio_file(path, sig[None], sr)
        files.append(path)
    for fn, args in ((lambda m: m.load_voice_clip, (files, FS, FS // 2)),
                     (lambda m: m.get_noise, (files, FS // 4, FS // 2))):
        outs = []
        for mod in (jg, tg):
            np.random.seed(11)
            outs.append(fn(mod)(*args))
        np.testing.assert_array_equal(outs[1], outs[0])
    audio = np.concatenate([np.zeros(5000), np.ones(9000), np.zeros(7000)])
    got, want = tg.trim_silence(audio), jg.trim_silence(audio)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert tg.angle_between_2d_vectors(np.array([1.0, 0.0]),
                                       np.array([0.0, 2.0])) == 90.0


# ---------------------------------------------------- noise, on_device ----

def test_powerlaw_noise_matches_jax():
    for beta in (0.0, 1.0, 1.7):
        want = jn.powerlaw_psd_gaussian(beta, (3, 999), fmin=0.01,
                                        rng=np.random.default_rng(2))
        got = tn.powerlaw_psd_gaussian(beta, (3, 999), fmin=0.01,
                                       rng=np.random.default_rng(2))
        np.testing.assert_array_equal(got, want)
    key = jax.random.PRNGKey(5)
    for n in (4000, 4001):
        for beta in (1, 2):
            want = np.asarray(jn.powerlaw_psd_gaussian_jax(key, beta,
                                                           (2, 3, n)))
            kr, ki = jax.random.split(key)
            draws = _t({"re": jax.random.normal(kr, (2, 3, n // 2 + 1)),
                        "im": jax.random.normal(ki, (2, 3, n // 2 + 1))})
            got = tn.powerlaw_noise(beta, draws, n).numpy()
            assert got.shape == want.shape == (2, 3, n)
            assert _rel(got, want) <= TOL
    gen = torch.Generator().manual_seed(0)
    d = tn.powerlaw_draws(gen, (2,), 100, device="cpu")
    assert d["re"].shape == d["im"].shape == (2, 51)


def _jax_augment_draws(key, b, m, t, max_shift=2, p_drop=0.0):
    """`augment_draws` made as `on_device.augment` splits its key."""
    kg, ks, kw, kp, kb, kl, kd = jax.random.split(key, 7)
    nf = t // 2 + 1

    def spectra(k):
        kr, ki = jax.random.split(k)
        return {"re": jax.random.normal(kr, (b, m, nf)),
                "im": jax.random.normal(ki, (b, m, nf))}

    d = {"gain": jax.random.uniform(kg, (b, m, 1)),
         "shift": jax.random.randint(ks, (b, m), -max_shift, max_shift + 1),
         "white": jax.random.normal(kw, (b, m, t)),
         "pink": spectra(kp), "brown": spectra(kb),
         "level": jax.random.uniform(kl, (3, b, 1, 1))}
    if p_drop > 0:
        d["drop"] = jax.random.uniform(kd, (b, m, 1)) < p_drop
    d = _t(d)
    d["shift"] = d["shift"].long()
    return d


def _jax_batch_draws(key, b, s, m, t, **aug):
    """`training_batch_draws` made as `make_training_batch` splits its
    key."""
    k1, k2, _ = jax.random.split(key, 3)
    return {"peak": _t({"scale": jax.random.uniform(
                k1, (b, s, 1, 1), minval=0.5, maxval=0.9)}),
            "augment": _jax_augment_draws(k2, b, m, t, **aug)}


def test_on_device_steps_match_jax():
    rng = np.random.default_rng(0)
    voices = rng.standard_normal((2, 3, 2000)).astype(np.float32)
    rirs = (rng.standard_normal((2, 3, 6, 128)) * 0.1).astype(np.float32)
    want = np.asarray(jo.render_sources(jnp.asarray(voices),
                                        jnp.asarray(rirs)))
    premix = to.render_sources(torch.from_numpy(voices),
                               torch.from_numpy(rirs))
    assert premix.shape == want.shape == (2, 3, 6, 2000)
    assert _rel(premix.numpy(), want) <= TOL

    key = jax.random.PRNGKey(3)
    want = np.asarray(jo.peak_scale(key, jnp.asarray(want)))
    draws = _t({"scale": jax.random.uniform(key, (2, 3, 1, 1), minval=0.5,
                                            maxval=0.9)})
    got = to.peak_scale(premix, draws).numpy()
    assert _rel(got, want) <= TOL

    near, far = jnp.asarray(want[:, 0]), jnp.asarray(want[:, 1:].sum(1))
    target = jnp.asarray([-5.0, 3.0])
    k_want, mix_want = jo.mix_to_target_snr(near, far, target)
    k_got, mix_got = to.mix_to_target_snr(*_t((near, far, target)))
    assert _rel(k_got.numpy(), k_want) <= TOL
    assert _rel(mix_got.numpy(), mix_want) <= TOL

    for kw in (dict(max_gain_db=3.0, max_shift=2),
               dict(max_gain_db=6.0, max_shift=3, p_drop=0.5,
                    noise_levels=(1e-2, 2e-2, 3e-2))):
        draw_kw = {k: kw[k] for k in ("max_shift", "p_drop") if k in kw}
        syn_kw = {k: v for k, v in kw.items() if k not in draw_kw}
        mix, gt = jnp.asarray(mix_want), jnp.asarray(mix_want[:, 0:1]) * 0.5
        m_want, g_want = jo.augment(key, mix, gt, **kw)
        d = _jax_augment_draws(key, 2, 6, 2000, **draw_kw)
        m_got, g_got = to.augment(*_t((mix, gt)), d, **syn_kw)
        assert _rel(m_got.numpy(), m_want) <= TOL
        assert _rel(g_got.numpy(), g_want) <= TOL


@pytest.mark.parametrize("n_near,aug", [
    (1, None), (2, dict(max_gain_db=6.0, noise_levels=(1e-2, 2e-2, 3e-2)))])
def test_make_training_batch_matches_jax(n_near, aug):
    rng = np.random.default_rng(n_near)
    voices = rng.standard_normal((2, 3, 2000)).astype(np.float32)
    rirs = (rng.standard_normal((2, 3, 6, 128)) * 0.1).astype(np.float32)
    target = np.asarray([0.0, -3.0], np.float32)
    key = jax.random.PRNGKey(n_near)
    want_in, want_tg = jo.make_training_batch(
        key, *map(jnp.asarray, (voices, rirs)), n_near, jnp.asarray(target),
        aug)
    draws = _jax_batch_draws(key, 2, 3, 6, 2000)
    got_in, got_tg = to.make_training_batch(
        *map(torch.from_numpy, (voices, rirs)), n_near,
        torch.from_numpy(target), draws, aug)
    assert got_in["mixture"].shape == (2, 6, 2000)
    assert got_tg["target"].shape == (2, 1, 2000)
    assert _rel(got_in["mixture"].numpy(), want_in["mixture"]) <= TOL
    assert _rel(got_tg["target"].numpy(), want_tg["target"]) <= TOL
    # the draws of the port's own generator have the same shapes
    gen = torch.Generator().manual_seed(0)
    own = to.training_batch_draws(gen, 2, 3, 6, 2000, p_drop=0.5,
                                  device="cpu")
    assert own["peak"]["scale"].shape == draws["peak"]["scale"].shape
    for k, v in draws["augment"].items():
        got = own["augment"][k]
        if isinstance(v, dict):
            assert {kk: vv.shape for kk, vv in got.items()} == \
                {kk: vv.shape for kk, vv in v.items()}
        else:
            assert got.shape == v.shape and got.dtype == v.dtype, k
    assert own["augment"]["drop"].dtype == torch.bool


def test_mix_to_target_snr_exact():
    rng = np.random.default_rng(0)
    near = torch.from_numpy(rng.standard_normal((3, 6, 4000)).astype(
        np.float32))
    far = torch.from_numpy(rng.standard_normal((3, 6, 4000)).astype(
        np.float32))
    target = torch.tensor([-5.0, 0.0, 3.0])
    _, mixture = to.mix_to_target_snr(near, far, target)
    noise = (mixture - near)[:, 0].numpy()
    achieved = 10 * np.log10(np.sum(near[:, 0].numpy() ** 2, -1)
                             / np.sum(noise ** 2, -1))
    np.testing.assert_allclose(achieved, target.numpy(), atol=1e-3)


def test_formant_speechlike_stream_and_voice():
    n = FS // 4
    jrng, trng = np.random.default_rng(6), np.random.default_rng(6)
    want = jv.formant_speechlike(jrng, n, FS)
    got = tv.formant_speechlike(trng, n, FS, device="cpu")
    assert jrng.integers(0, 2 ** 31) == trng.integers(0, 2 ** 31)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (n,)
    assert np.isfinite(got).all() and abs(np.abs(got).max() - 1.0) < 1e-6
    # the same seed draws the same voice
    again = tv.formant_speechlike(np.random.default_rng(6), n, FS,
                                  device="cpu")
    np.testing.assert_array_equal(again, got)
