"""On-device training campaign data (port of
`sound_bubble_tpu/datagen/campaign.py`): a pool of room acoustics built once,
and training batches synthesized on the device from it.

1. `build_pool`: scenario geometry on the host (rooms, head-array poses,
   bubble-constrained speaker placement, the reference distributions of
   `datagen/generate.py`), then every image-source RIR rendered by
   `method`: "host", `rirs_host_fast` (numpy bincount + FFT; the same arrays
   as the JAX package's for the same seed), or "device", `rirs_on_device`
   (the image sum evaluated in the frequency domain, H[f] = sum_i a_i
   e^{-j w tau_i}, chunked over images, on a torch device: the exact
   band-limited form of the windowed-sinc RIR of `ism.compute_rir`). Either
   way the pool is numpy float32;
2. `make_batch`: (scenario indices, draws) -> a training batch on the
   device: speech-like sources, RIR convolution by `fft_conv`, per-source
   peak scaling U(0.5, 0.9), the exact-SNR far scaling (reference quadratic
   with near_error=0), optional far-field background noise, clip renorm.

The randomness of a batch is split from its synthesis: `batch_draws`
takes every random number from an explicit `torch.Generator`, and
`make_batch` is a deterministic function of the pool, the indices and those
draws (likewise `speechlike_draws` / `speechlike_synth`), so the same draws
can be handed to the synthesis from elsewhere.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sound_bubble_tpu_torch.datagen.generate import (
    MIC_HEIGHT, get_random_mic_positions_headphone,
    get_random_speaker_positions_dis_uniform,
)
from sound_bubble_tpu_torch.datagen.ism import FDL, irfft_real, shoebox_images
from sound_bubble_tpu_torch.datagen.voice import (
    default_sil_hi, formant_draws, formant_synth)
from sound_bubble_tpu_torch.ops.fft_conv import fft_conv
from sound_bubble_tpu_torch.ops.noise import colored_noise, colored_noise_draws
from sound_bubble_tpu_torch.utils import resolve_device

S_MAX = 4          # source slots per scenario (<=2 in-bubble + <=2 outside)
RADII = (1.0, 1.5, 2.0)
DIS_EMBEDS = {1.0: (0.0, 0.0, 1.0), 1.5: (0.0, 1.0, 0.0), 2.0: (1.0, 0.0, 0.0)}
# background-noise slot (reference room2: order 15, the first 2000 samples
# of propagation trimmed)
BG_ORDER = 15
BG_TRIM = 2000


# ------------------------------------------------------------- host side ----

def sample_scenario(rng: np.random.Generator, radius: float, n_in: int,
                    max_order: int, n_img_max: int, bg_noise: bool = False):
    """One scenario's geometry (reference `generate_sample`
    distributions): returns dict of fixed-shape numpy arrays.

    bg_noise adds one LAST slot: a far-field background-noise source in a
    huge second room (reference `generate_data_scenario` room2 semantics —
    dims U(30,40) x U(50,60) x U(10,20), same absorption, order 15, source
    ~20-60 m out, first 2000 samples of propagation trimmed). The slot's
    signal (colored noise) and its on/off gate are drawn at batch time in
    `make_batch`."""
    # the geometry helpers (datagen/generate.py) draw from np.random
    np.random.seed(int(rng.integers(0, 2 ** 31 - 1)))
    right = np.random.uniform(5, 8)
    top = np.random.uniform(4, 8)
    ceiling = np.random.uniform(2, 4)
    n_out = int(np.random.randint(1, 3))

    mic_center, _angle, mics = get_random_mic_positions_headphone(
        6, 0.0, right, 0.0, top)
    positions, dis = get_random_speaker_positions_dis_uniform(
        radius, n_in, n_out, mic_center, 0.0, right, top, 0.0)
    positions = np.array([
        list(p) + [np.random.uniform(MIC_HEIGHT - 0.25, MIC_HEIGHT + 0.25)]
        for p in positions])
    absorption = np.random.uniform(0.1, 0.9)

    S = S_MAX + 1 if bg_noise else S_MAX
    images = np.zeros((S, n_img_max, 3), np.float32)
    n_refl = np.zeros((S, n_img_max), np.float32)
    img_mask = np.zeros((S, n_img_max), np.float32)
    for s, pos in enumerate(positions):
        im, nr = shoebox_images([right, top, ceiling], pos, max_order)
        k = min(len(im), n_img_max)
        images[s, :k] = im[:k]
        n_refl[s, :k] = nr[:k]
        img_mask[s, :k] = 1.0

    active = np.zeros(S, np.float32)
    near = np.zeros(S, np.float32)
    noise_mask = np.zeros(S, np.float32)
    delay_trim = np.zeros(S, np.float32)
    active[:n_in + n_out] = 1.0
    near[:n_in] = 1.0
    if bg_noise:
        dims2 = [np.random.uniform(30, 40), np.random.uniform(50, 60),
                 np.random.uniform(10, 20)]
        bg = [np.random.uniform(15, dims2[0] - 2),
              np.random.uniform(20, dims2[1] - 2),
              np.random.uniform(3, dims2[2] - 2)]
        im, nr = shoebox_images(dims2, bg, BG_ORDER)
        k = min(len(im), n_img_max)
        images[S_MAX, :k] = im[:k]
        n_refl[S_MAX, :k] = nr[:k]
        img_mask[S_MAX, :k] = 1.0
        active[S_MAX] = 1.0          # gated per batch in make_batch
        noise_mask[S_MAX] = 1.0
        delay_trim[S_MAX] = BG_TRIM
    return dict(
        images=images, n_refl=n_refl, img_mask=img_mask,
        mics=mics.astype(np.float32),
        rho=np.float32(np.sqrt(1.0 - absorption)),
        active=active, near_mask=near, noise_mask=noise_mask,
        delay_trim=delay_trim,
        dis_embed=np.asarray(DIS_EMBEDS[radius], np.float32),
        radius=np.float32(radius),
    )


@functools.lru_cache(maxsize=4)
def _sinc_window_response(rir_len: int, oversample: int = 16) -> np.ndarray:
    """Spectrum (real, even prototype) of the host ISM's Hann-windowed-sinc
    fractional-delay filter (`ism.compute_rir`), sampled at the rir rfft
    grid — multiplying the ideal band-limited image sum by this makes the
    device RIRs match the host windowed-sinc RIRs."""
    half = FDL // 2
    u = np.arange(-(half + 1) * oversample, (half + 1) * oversample + 1) \
        / oversample
    w = 0.5 * (1 + np.cos(np.pi * u / (half + 1)))
    h = np.sinc(u) * np.clip(w, 0.0, None)
    nf = rir_len // 2 + 1
    f = np.arange(nf) / rir_len                      # cycles/sample
    resp = (h[None, :] * np.cos(2 * np.pi * f[:, None] * u[None, :])).sum(1) \
        / oversample
    return resp.astype(np.float32)


def rirs_on_device(images, n_refl, img_mask, mics, rho, *, fs: int,
                   rir_len: int, chunk: int = 2048, c: float = 343.0,
                   delay_trim=None) -> torch.Tensor:
    """Image-source RIRs in the frequency domain, chunked over images, on the
    device of `images` (float32).

    images [S, N, 3], n_refl/img_mask [S, N], mics [M, 3], rho a 0-d tensor,
    delay_trim [S] or None -> rirs [S, M, rir_len].
    H[m, f] = sum_i a_i exp(-j 2 pi f tau_i) with a_i = rho^n_i / (4 pi d_i);
    images whose delay would wrap past rir_len are masked out, and with
    `delay_trim` each slot's delays are shortened by its trim (samples) and
    images that land before 0 are dropped. Each chunk holds [S, M, chunk,
    rir_len // 2 + 1] phases: 1.47 GB in float32 at S=5, M=6, chunk 2048,
    rir_len 12000. The arithmetic follows the JAX package's
    `rirs_on_device` op for op (d, tau, amp, then the phase tau * omega), and
    cos / sin are PyTorch's, with full range reduction: at rir_len 12000
    the phase reaches ~3.7e4 rad, where one float32 ulp is ~4e-3 rad.
    """
    dev = images.device
    S, N, _ = images.shape
    M = mics.shape[0]
    nf = rir_len // 2 + 1
    freqs = torch.arange(nf, dtype=torch.float32, device=dev) * (
        2 * math.pi * fs / rir_len)
    # d and tau are rounded alike on every device (a delay one ulp off moves
    # its image by ~2e-4 sample at rir_len 8192): the divisors are tensors
    # (PyTorch on the card multiplies by the reciprocal of a Python number,
    # on the CPU it divides), and the root is taken in float64 and rounded
    # once (PyTorch's float32 root on the card is not correctly rounded)
    c_t, fs_t = (torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in (c, fs))
    re = torch.zeros((S, M, nf), dtype=torch.float32, device=dev)
    im = torch.zeros_like(re)
    for i in range(0, N, chunk):
        nr, mk = n_refl[:, i:i + chunk], img_mask[:, i:i + chunk]
        diff = images[:, None, i:i + chunk] - mics[None, :, None]
        sq = diff * diff
        d = torch.sqrt((sq[..., 0] + sq[..., 1] + sq[..., 2]).double())
        d = d.float()
        d = torch.clamp(d, min=1e-3)                  # [S, M, chunk]
        tau = d / c_t
        amp = (rho ** nr)[:, None] / (4 * math.pi * d) * mk[:, None]
        zero = torch.zeros_like(amp)
        if delay_trim is not None:
            tau = tau - delay_trim[:, None, None] / fs_t
            amp = torch.where(tau >= 0, amp, zero)
        amp = torch.where(tau * fs < rir_len - FDL, amp, zero)[..., None]
        phase = tau[..., None] * freqs                # [S, M, chunk, F]
        term = torch.cos(phase)
        term *= amp
        re += torch.sum(term, dim=2)
        torch.sin(phase, out=term)
        term *= amp
        im -= torch.sum(term, dim=2)
        del phase, term
    w = torch.as_tensor(_sinc_window_response(rir_len), device=dev)
    return irfft_real(re * w, im * w, rir_len)


def rirs_host_fast(images, n_refl, img_mask, mics, rho, *, fs: int,
                   rir_len: int, oversample: int = 8,
                   c: float = 343.0, delay_trim=None) -> np.ndarray:
    """Fast host ISM synthesis: each image is one impulse scattered onto an
    `oversample`x grid (np.bincount — C-speed), then one rfft band-select
    brings it to the target rate with the same windowed-sinc prototype
    response as `rirs_on_device`. ~30x cheaper than per-image 81-tap sincs
    (`ism.compute_rir`); delay quantization is 1/oversample sample (phase
    error < 12 deg at 3 kHz for 8x), amplitudes/decay exact.

    images [S, N, 3], n_refl/img_mask [S, N], mics [M, 3] -> [S, M, rir_len].
    """
    S, N, _ = images.shape
    M = mics.shape[0]
    L8 = rir_len * oversample
    nf = rir_len // 2 + 1
    w = _sinc_window_response(rir_len)
    out = np.empty((S, M, rir_len), np.float32)
    images = np.asarray(images, np.float64)
    for s in range(S):
        d = np.linalg.norm(images[s][None, :, :] - np.asarray(mics)[:, None, :],
                           axis=-1)                        # [M, N]
        d = np.maximum(d, 1e-3)
        amp = (float(rho) ** np.asarray(n_refl[s])[None]) / (4 * np.pi * d)
        amp = amp * np.asarray(img_mask[s])[None]
        delay = d / c * fs
        if delay_trim is not None:
            # per-slot propagation trim (BG-noise slot: the reference drops
            # the first BG_TRIM samples of the room2 premix)
            delay = delay - float(delay_trim[s])
            amp = np.where(delay >= 0, amp, 0.0)
        amp = np.where(delay < rir_len - FDL, amp, 0.0)
        d8 = delay * oversample
        di = np.floor(d8).astype(np.int64)
        frac = (d8 - di).astype(np.float64)
        di = np.clip(di, 0, L8 - 2)
        for m in range(M):
            # linear-interp split over two adjacent grid samples: phase is
            # (near-)exact across the selected band, amplitude dip <2%
            idx = np.concatenate([di[m], di[m] + 1])
            wts = np.concatenate([amp[m] * (1 - frac[m]), amp[m] * frac[m]])
            grid = np.bincount(idx, weights=wts, minlength=L8)
            spec = np.fft.rfft(grid)[:nf] * w
            out[s, m] = np.fft.irfft(spec, n=rir_len).astype(np.float32)
    return out


def build_pool(n_scenarios: int, *, seed: int = 0, sr: int = 24000,
               rir_len: int = 12000, order_range=(10, 32), radii=RADII,
               method: str = "host", device="cuda", verbose: bool = True,
               bg_noise: bool = False):
    """Build the campaign pool (numpy, float32): rirs [P, S, 6, rir_len],
    active/near_mask [P, S], dis_embed [P, 3] (+ noise_mask [P, S] with
    `bg_noise`), and the radius of each scenario [P]; S = S_MAX, or
    S_MAX + 1 with `bg_noise` (the last slot is the far-field
    background-noise RIR). The geometry is drawn on the host; the RIRs are
    rendered by `method`: "host" (`rirs_host_fast`) or "device"
    (`rirs_on_device` on `device`, then copied back)."""
    if method not in ("host", "device"):
        raise ValueError(f"method must be 'host' or 'device': {method!r}")
    if method == "device":
        device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_img_max = len(shoebox_images([6, 6, 3], [3, 3, 1.5],
                                   max(order_range[1], BG_ORDER))[0])
    rirs, active, near, dis, radius, noise = [], [], [], [], [], []
    for i in range(n_scenarios):
        r = radii[i % len(radii)]
        n_in = int(rng.integers(0, 3))
        order = int(rng.integers(order_range[0], order_range[1] + 1))
        sc = sample_scenario(rng, r, n_in, order, n_img_max,
                             bg_noise=bg_noise)
        trim = sc["delay_trim"] if bg_noise else None
        if method == "host":
            rirs.append(rirs_host_fast(
                sc["images"], sc["n_refl"], sc["img_mask"], sc["mics"],
                sc["rho"], fs=sr, rir_len=rir_len, delay_trim=trim))
        else:
            def t(a):
                return torch.as_tensor(a, device=device)

            rirs.append(rirs_on_device(
                t(sc["images"]), t(sc["n_refl"]), t(sc["img_mask"]),
                t(sc["mics"]), t(sc["rho"]), fs=sr, rir_len=rir_len,
                delay_trim=None if trim is None else t(trim)).cpu().numpy())
        active.append(sc["active"])
        near.append(sc["near_mask"])
        noise.append(sc["noise_mask"])
        dis.append(sc["dis_embed"])
        radius.append(float(sc["radius"]))
        if verbose and (i + 1) % 100 == 0:
            print(f"pool: {i + 1}/{n_scenarios} scenarios", flush=True)
    pool = {"rirs": np.stack(rirs), "active": np.stack(active),
            "near_mask": np.stack(near), "dis_embed": np.stack(dis)}
    if bg_noise:
        pool["noise_mask"] = np.stack(noise)
    return pool, np.asarray(radius)


# ------------------------------------------------- device voice synthesis ----

def speechlike_draws(gen: torch.Generator, batch_shape, n: int, sr: int,
                     device="cpu") -> dict:
    """The random numbers of `speechlike_synth`: uniforms f0 [*bs, 1, 1],
    amps / phases [*bs, 5, 1], fm / fg / pg [*bs, 1], normals z [*bs, n] and
    the leading-silence length zs [*bs, 1] (int64)."""
    bs = tuple(batch_shape)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(bs + shape, generator=gen,
                                           device=device)

    lo = int(0.083 * sr)
    hi = max(int(min(1.33 * sr, 0.4 * n)), lo + 1)
    return {"f0": uniform((1, 1), 110.0, 220.0),
            "amps": uniform((5, 1), 0.3, 1.0),
            "phases": uniform((5, 1), 0.0, 6.28),
            "fm": uniform((1,), 2.0, 5.0), "fg": uniform((1,), 0.3, 0.7),
            "pg": uniform((1,), 0.0, 6.28),
            "z": torch.randn(bs + (n,), generator=gen, device=device),
            "zs": torch.randint(lo, hi, bs + (1,), generator=gen,
                                device=device)}


def speechlike_synth(d: dict, n: int, sr: int) -> torch.Tensor:
    """Speech-like sources [*bs, n] (the distributions of
    datasets/make_test_samples.speechlike): 5 harmonics on f0 with random
    amplitudes / phases, 2-5 Hz AM, pause gating, noise floor, random
    leading silence, peak-norm."""
    dev = d["z"].device
    t = torch.arange(n, dtype=torch.float32, device=dev) / sr
    harm = torch.arange(1, 6, dtype=torch.float32, device=dev)[:, None]
    amps = d["amps"] / harm
    sig = torch.sum(amps * torch.sin(2 * np.pi * d["f0"] * harm * t
                                     + d["phases"]), dim=-2)
    sig = sig * (1 + 0.8 * torch.sin(2 * np.pi * d["fm"] * t))
    env = (torch.sin(2 * np.pi * d["fg"] * t + d["pg"]) > -0.7).float()
    sig = sig * env + 0.02 * d["z"]
    sig = torch.where(torch.arange(n, device=dev) < d["zs"],
                      torch.zeros_like(sig), sig)
    return sig / (torch.amax(torch.abs(sig), dim=-1, keepdim=True) + 1e-9)


# ------------------------------------------------------- batch assembly ----

def radius_probs(dis_embed: np.ndarray, weights) -> np.ndarray:
    """Per-scenario sampling probabilities that re-weight the bubble radii.

    dis_embed: [P, 3] one-hot rows (DIS_EMBEDS layout: column 0 = 2.0 m,
    column 1 = 1.5 m, column 2 = 1.0 m). weights: 3 floats in RADII order
    (1.0, 1.5, 2.0). Returns [P] probabilities summing to 1, uniform WITHIN
    each radius class — so `rng.choice(P, p=...)` oversamples the weighted
    radii without biasing room/source geometry inside a class.
    """
    d = np.asarray(dis_embed, np.float32)
    cls = 2 - np.argmax(d, axis=1)          # column -> index into RADII
    w = np.asarray(list(weights), np.float64)
    if w.shape != (3,) or (w < 0).any() or w.sum() <= 0:
        raise ValueError(
            f"radius_weights must be 3 nonnegative floats: {weights}")
    counts = np.bincount(cls, minlength=3).astype(np.float64)
    if ((w > 0) & (counts == 0)).any():
        raise ValueError("pool has no scenarios for a radius with weight > 0")
    per_class = np.where(counts > 0, w / np.maximum(counts, 1), 0.0)
    p = per_class[cls]
    return p / p.sum()


def scenario_probs(pool, radius_weights=None, nin_weights=None) -> np.ndarray:
    """Joint radius x in-bubble-speaker-count reweighting (round-5 overlap
    curriculum, VERDICT r4 #2).

    The reference trains on exact 0/1/2-in-bubble thirds
    (`generate_adaptive_dataset.py:835-841` splits the sample index range
    into thirds by speaker count); this generalizes `radius_probs` so a
    campaign can OVERSAMPLE the diagnosed weak regimes — dense 2-in-bubble
    overlap and the empty-bubble mute case — without touching geometry.

    radius_weights: 3 floats in RADII order (1.0, 1.5, 2.0 m) or None.
    nin_weights: 3 floats for n_in = 0/1/2 in-bubble speakers or None.
    Returns [P] probabilities; the total mass of joint class (r, n) is
    proportional to w_r[r] * w_n[n], uniform WITHIN each joint class.
    """
    d = np.asarray(pool["dis_embed"], np.float32)
    cls_r = 2 - np.argmax(d, axis=1)                    # -> index into RADII
    nin = np.rint(np.asarray(pool["near_mask"], np.float32).sum(1)).astype(int)
    if (nin < 0).any() or (nin > 2).any():
        raise ValueError("near_mask rows must sum to 0/1/2 speakers")

    def _w(weights, name):
        if weights is None:
            return None
        w = np.asarray(list(weights), np.float64)
        if w.shape != (3,) or (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"{name} must be 3 nonnegative floats: {weights}")
        return w

    wr = _w(radius_weights, "radius_weights")
    wn = _w(nin_weights, "nin_weights")
    # a None dimension is COLLAPSED (all scenarios share one class along
    # it), so radius-only input reproduces radius_probs exactly — the mass
    # within a radius class stays uniform regardless of its n_in makeup
    cr = cls_r if wr is not None else np.zeros_like(cls_r)
    cn = nin if wn is not None else np.zeros_like(nin)
    wr_eff = wr if wr is not None else np.ones(3)
    wn_eff = wn if wn is not None else np.ones(3)
    joint = cr * 3 + cn
    counts = np.bincount(joint, minlength=9).astype(np.float64)
    w = np.outer(wr_eff, wn_eff).reshape(9)
    for r in (range(3) if wr is not None else (0,)):
        for n_ in (range(3) if wn is not None else (0,)):
            if w[r * 3 + n_] > 0 and counts[r * 3 + n_] == 0:
                raise ValueError(
                    "pool has no scenarios for a weighted (radius, n_in) "
                    "class; enlarge the pool or zero that weight")
    per_class = np.where(counts > 0, w / np.maximum(counts, 1), 0.0)
    p = per_class[joint]
    return p / p.sum()


def batch_draws(gen: torch.Generator, pool, idx, *, n_samples: int,
                sr: int = 24000, snr_range=(-10.0, 5.0),
                voice: str = "formant", bg_noise_p: float = 0.0,
                dense2_p: float = 0.0) -> dict:
    """Every random number of one `make_batch` call (same keyword
    arguments), on the pool's device: the dense-overlap draws, the voices'
    (`formant_draws` / `speechlike_draws`, the 75/25 `pick` of voice="mix"),
    the background noise's, the per-source peak scale uniforms `u` and the
    target SNRs `snr`."""
    dev = pool["active"].device
    b, s = int(idx.shape[0]), int(pool["active"].shape[1])
    bg = bg_noise_p > 0.0 and "noise_mask" in pool
    s_v = s - 1 if bg else s

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    d: dict = {}
    sil_hi = None
    if dense2_p > 0.0:
        if voice not in ("formant", "mix"):
            raise ValueError("dense2_p needs voice='formant' or 'mix'")
        d["dense"] = rand(b) < dense2_p
        d["f0c"] = 105.0 + 110.0 * rand(b, 1)
        d["f0_pair"] = -2.0 / 12 + 4.0 / 12 * rand(b, 2)
        sil_hi = _dense_overrides(pool, idx, d, n_samples, sr, s_v)[1]
        sil_hi = sil_hi.reshape(-1)
    if voice in ("formant", "mix"):
        d["formant"] = formant_draws(gen, b * s_v, n_samples, sr, sil_hi,
                                     dev)
    if voice in ("harmonic", "mix"):
        d["speechlike"] = speechlike_draws(gen, (b, s_v), n_samples, sr,
                                           dev)
    if voice == "mix":
        d["pick"] = rand(b, s_v) < 0.75
    if bg:
        d["bg"] = {"beta": 2.0 * rand(b),
                   "noise": colored_noise_draws(gen, (b,), n_samples, dev),
                   "depth": 0.5 * rand(b, 1), "fm": 0.1 + 0.9 * rand(b, 2),
                   "gate": rand(b, 1) < bg_noise_p}
    d["u"] = rand(b, s, 1, 1)
    d["snr"] = snr_range[0] + (snr_range[1] - snr_range[0]) * rand(b)
    return d


def _dense_overrides(pool, idx, d, n_samples, sr, s_v):
    """(pause_p, sil_hi, f0_base) [b, s_v] of the dense-overlap curriculum,
    and its pair mask dm [b, s_v]: the first two slots of a 2-in-bubble
    sample drawn dense are near-continuous formant talkers with close F0."""
    dev = pool["active"].device
    two_in = torch.sum(pool["near_mask"][idx], dim=1) >= 2.0
    dense = two_in & d["dense"]
    dm = dense[:, None] & (torch.arange(s_v, device=dev) < 2)[None, :]
    f0_pair = d["f0c"] * 2.0 ** d["f0_pair"]
    f0_full = torch.nn.functional.pad(f0_pair, (0, s_v - 2), value=-1.0)
    pause_p = torch.where(dm, 0.05, 0.20)
    sil_hi = torch.where(dm, 0.12 * sr, default_sil_hi(n_samples, sr))
    f0_base = torch.where(dm, f0_full, -1.0)
    return (pause_p, sil_hi, f0_base), dm


def make_batch(pool, idx, draws: dict, *, n_samples: int, sr: int = 24000,
               snr_range=(-10.0, 5.0), voice: str = "formant",
               bg_noise_p: float = 0.0, dense2_p: float = 0.0):
    """One training batch from the pool (dict of tensors on the device) at
    the scenario indices idx [B], from `draws` (`batch_draws` with the same
    keyword arguments). Returns (inputs {mixture [B, 6, T], dis_embed
    [B, 3]}, targets {target [B, 1, T]}).

    voice: "formant" (`datagen/voice.py`), "harmonic" (speech-like
    harmonics) or "mix" (per source, 75 % formant and 25 % harmonic).
    bg_noise_p: probability a sample carries far-field background noise in
    the pool's noise slot (a `bg_noise=True` pool): amplitude-modulated
    colored noise (beta ~ U(0, 2)) through the huge-room RIR, peak-scaled
    U(0.05, 0.4), counted in the far sum of the SNR solve. dense2_p:
    probability a 2-in-bubble sample gets the dense-overlap treatment
    (`_dense_overrides`)."""
    bg = bg_noise_p > 0.0 and "noise_mask" in pool
    dev = pool["active"].device
    n = n_samples
    rirs = pool["rirs"][idx].float()                # [B, S, M, L]
    active = pool["active"][idx]                    # [B, S]
    near_mask = pool["near_mask"][idx]
    b, s = active.shape
    if not bg and "noise_mask" in pool:
        # a bg pool driven with bg_noise_p=0: silence the noise slot
        active = active * (1.0 - pool["noise_mask"][idx])
    s_v = s - 1 if bg else s
    over, dm = (None, None, None), None
    if dense2_p > 0.0:
        if voice not in ("formant", "mix"):
            raise ValueError("dense2_p needs voice='formant' or 'mix'")
        over, dm = _dense_overrides(pool, idx, draws, n, sr, s_v)
        over = tuple(v.reshape(-1) for v in over)

    def formant():
        return formant_synth(draws["formant"], n, sr, over[0],
                             over[2]).reshape(b, s_v, n)

    if voice == "formant":
        voices = formant()
    elif voice == "mix":
        pick = draws["pick"] if dm is None else draws["pick"] | dm
        voices = torch.where(pick[:, :, None], formant(),
                             speechlike_synth(draws["speechlike"], n, sr))
    else:
        voices = speechlike_synth(draws["speechlike"], n, sr)
    if bg:
        g = draws["bg"]
        noise = colored_noise(g["beta"], g["noise"], n)       # [B, T]
        t = torch.arange(n, dtype=torch.float32, device=dev) / sr
        fm = g["fm"]
        env = 1.0 - g["depth"] * (0.5 + 0.5 * torch.sin(
            2 * np.pi * fm[:, :1] * t[None] + 2 * np.pi * fm[:, 1:]))
        voices = torch.cat([voices, (noise * env)[:, None]], dim=1)
        active = torch.cat([active[:, :-1],
                            active[:, -1:] * g["gate"].to(active.dtype)], 1)
    premix = fft_conv(voices[:, :, None, :], rirs)[..., :n]   # [B, S, M, T]
    # per-source peak scaling U(0.5, 0.9); the noise slot U(0.05, 0.4)
    if bg:
        lo = torch.tensor([0.5] * s_v + [0.05], device=dev).reshape(
            1, s, 1, 1)
        hi = torch.tensor([0.9] * s_v + [0.4], device=dev).reshape(
            1, s, 1, 1)
    else:
        lo, hi = 0.5, 0.9
    scale = lo + draws["u"] * (hi - lo)
    peak = torch.amax(torch.abs(premix), dim=(-2, -1), keepdim=True)
    premix = premix / (peak + 1e-9) * scale
    premix = premix * active[:, :, None, None]

    near = torch.sum(premix * near_mask[:, :, None, None], dim=1)
    far = torch.sum(premix * (active - near_mask)[:, :, None, None], dim=1)
    # exact-SNR far scaling; an empty bubble keeps the far mix unscaled
    target_snr = draws["snr"]
    near_pwr = torch.sum(near[:, 0] ** 2, -1)
    far_pwr = torch.sum(far[:, 0] ** 2, -1)
    k = torch.sqrt(near_pwr / (10 ** (target_snr / 10)) / (far_pwr + 1e-9))
    k = torch.where(near_pwr > 0, k, torch.ones_like(k))
    mixture = near + k[:, None, None] * far
    gt = near[:, 0:1]
    # clip renorm
    div = torch.clamp(torch.amax(torch.abs(mixture), dim=(-2, -1),
                                 keepdim=True), min=1.0)
    inputs = {"mixture": mixture / div, "dis_embed": pool["dis_embed"][idx]}
    return inputs, {"target": gt / div}
