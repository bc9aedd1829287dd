"""PESQ — ITU-T P.862 (narrowband) perceptual speech quality, host-side
(port copy of `sound_bubble_tpu/metrics/pesq.py`, numpy only).

The reference computes PESQ on every eval row through the `pesq` C library
(its `src/metrics/metrics.py:58-60`: resample to 16 kHz, mode
"nb"). That library is optional, so this is a from-scratch
implementation of the P.862 algorithm structure:

  level align -> IRS receive filter -> 32 ms Hann frames (50% overlap) ->
  Bark-warped power spectra -> per-band frequency compensation and per-frame
  gain compensation -> Zwicker loudness -> masked disturbance (symmetric +
  asymmetric) -> (L6 over 320 ms intervals, L2 over time) aggregation ->
  raw P.862 score -> P.862.1 MOS-LQO mapping.

Documented deviations from the ITU reference C code (which normative tables
are not redistributable here):
- Bark band edges/centres derive from the Zwicker formula (49 bands), not
  the fixed `pesqpar.h` tables;
- the IRS receive characteristic is a piecewise-log fit of the published
  response, applied as an FFT gain mask;
- time alignment is a single global envelope cross-correlation (the model
  under eval is causal and sample-aligned, so utterance re-splitting never
  triggers).
Scores are therefore P.862-like rather than bit-exact: clean==ref gives
4.549 (the P.862.1 ceiling), degradations order identically, absolute values
may differ from the C implementation by a few tenths of a MOS.

One change from the JAX package's copy: a pair whose aligned signals hold
no whole frame scores NaN (as one with no frame already does there). For
some clips shorter than the 0.5 s lag search the alignment moves the
degraded signal past its end, and the JAX copy then raises on an empty FFT.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

SR = 16000
FRAME = 512              # 32 ms @ 16 kHz
HOP = 256
N_BARK = 49


def _bark(f):
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


@lru_cache(maxsize=1)
def _band_tables():
    """Bark band edges (uniform in Bark over 50 Hz..Nyquist), per-band FFT
    bin slices, band widths (Bark), centre freqs, absolute hearing threshold
    (Terhardt approximation) in the internal power scale."""
    f_lo, f_hi = 50.0, SR / 2.0
    z_edges = np.linspace(_bark(f_lo), _bark(f_hi), N_BARK + 1)
    # invert z(f) by interpolation on a fine grid
    fine = np.linspace(0.0, f_hi, 16001)
    f_edges = np.interp(z_edges, _bark(fine), fine)
    centres = 0.5 * (f_edges[1:] + f_edges[:-1])
    widths = np.diff(z_edges)

    freqs = np.fft.rfftfreq(FRAME, 1.0 / SR)
    band_of_bin = np.searchsorted(f_edges, freqs, side="right") - 1
    band_of_bin[freqs < f_lo] = -1
    band_of_bin = np.clip(band_of_bin, -1, N_BARK - 1)

    khz = centres / 1000.0
    thr_db = (3.64 * khz ** -0.8
              - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
              + 1e-3 * khz ** 4)
    # internal calibration: 0 dB SPL == band power 1; level alignment puts
    # active speech bands at ~1e6 (i.e. ~60 dB SPL equivalent)
    abs_thresh = 10.0 ** (thr_db / 10.0)
    return band_of_bin, widths, centres, abs_thresh


@lru_cache(maxsize=1)
def _irs_gain():
    """IRS receive response (piecewise-log fit of the published
    characteristic: steep cut <100 Hz and >3700 Hz, gentle presence rise),
    as linear gain per rfft bin of FRAME."""
    pts_f = np.array([0, 50, 100, 125, 160, 200, 250, 300, 350, 400, 500,
                      600, 700, 800, 1000, 1300, 1600, 2000, 2500, 3000,
                      3250, 3500, 3700, 4000, 5000, 6400, 8000], float)
    pts_db = np.array([-200, -40, -20, -12, -6, -2, 0, 1, 2, 3, 3,
                       3, 3, 3, 3, 3, 3, 3, 2, 1,
                       0, -3, -8, -20, -40, -80, -200], float)
    freqs = np.fft.rfftfreq(FRAME, 1.0 / SR)
    db = np.interp(freqs, pts_f, pts_db)
    return 10.0 ** (db / 20.0)


def _fft_filter(x, gain):
    """Zero-phase FFT filtering in FRAME-sized 50%-overlap Hann blocks."""
    n = len(x)
    win = np.hanning(FRAME)
    pad = np.pad(x, (HOP, FRAME))
    out = np.zeros(len(pad))
    for start in range(0, len(pad) - FRAME, HOP):
        blk = pad[start:start + FRAME] * win
        out[start:start + FRAME] += np.fft.irfft(
            np.fft.rfft(blk) * gain, n=FRAME)
    return out[HOP:HOP + n]


def _level_align(x):
    """Scale so active frames carry ~2e7 total spectral power in the
    internal scale (P.862's fixed level alignment), measured over the
    350-3250 Hz band."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / SR)
    band = (freqs >= 350) & (freqs <= 3250)
    # mean-square of the band-limited signal
    ms = np.sum(np.abs(spec[band]) ** 2) / (len(x) ** 2) * 2.0
    # frame spectral power ~= FRAME * sum((win*x)^2) ~= 0.375*FRAME^2*ms
    target_ms = 2e7 / (0.375 * FRAME * FRAME)
    return x * np.sqrt(target_ms / (ms + 1e-20))


def _align(ref, deg, max_shift=SR // 2):
    """Global delay estimate via envelope cross-correlation (P.862's crude
    alignment; the per-utterance refinement is a no-op for clock-aligned
    signals)."""
    n = 1 << int(np.ceil(np.log2(len(ref) + len(deg))))
    env_r = np.abs(ref)
    env_d = np.abs(deg)
    R = np.fft.irfft(np.conj(np.fft.rfft(env_r, n)) * np.fft.rfft(env_d, n),
                     n)
    lags = np.concatenate([np.arange(0, max_shift),
                           np.arange(-max_shift, 0)])
    vals = np.concatenate([R[:max_shift], R[-max_shift:]])
    delay = int(lags[np.argmax(vals)])
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        deg = np.pad(deg, (-delay, 0))
    m = min(len(ref), len(deg))
    return ref[:m], deg[:m]


def _bark_frames(x):
    """[T] -> (bark power [n_frames, N_BARK], frame total power [n_frames])."""
    band_of_bin, widths, _c, _t = _band_tables()
    win = np.hanning(FRAME)
    n_frames = max((len(x) - FRAME) // HOP + 1, 0)
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx] * win
    pspec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    bark = np.zeros((n_frames, N_BARK))
    for b in range(N_BARK):
        sel = band_of_bin == b
        if sel.any():
            bark[:, b] = pspec[:, sel].sum(-1)
    return bark, pspec.sum(-1)


def _loudness(bark):
    """Zwicker loudness (P.862 eq.: Sl * (P0/0.5)^0.23 *
    [(0.5 + 0.5 P/P0)^0.23 - 1]), zero below absolute threshold."""
    _b, widths, _c, P0 = _band_tables()
    sl = 1.866055e-1  # loudness scale calibration
    g = 0.23
    L = sl * (P0 / 0.5) ** g * ((0.5 + 0.5 * bark / P0) ** g - 1.0)
    return np.where(bark > P0, L, 0.0)


# disturbance scale calibration: fitted so white-noise degradations hit the
# published P.862-nb MOS anchor curve, with the symmetric/asymmetric terms
# carrying ~70/30 of the drop like the ITU weighting (see tests/test_pesq.py);
# the ITU code pins these scales through its fixed power tables instead.
CAL_SYM = 1.4334
CAL_ASYM = 0.0691


def _disturbances(ref: np.ndarray, deg: np.ndarray, fs: int = SR):
    """Run the perceptual model; returns (D, DA) aggregate disturbances."""
    ref = np.asarray(ref, np.float64).ravel()
    deg = np.asarray(deg, np.float64).ravel()
    if fs != SR:
        from sound_bubble_tpu_torch.data.resample import resample_poly_np
        ref = resample_poly_np(ref, SR, fs)
        deg = resample_poly_np(deg, SR, fs)

    ref, deg = _align(ref, deg)
    if len(ref) < FRAME:
        # no whole frame: NaN, as for any clip with no frame below (the
        # JAX package's copy raises when the alignment leaves no sample)
        return float("nan"), float("nan")
    ref = _level_align(ref)
    deg = _level_align(deg)
    irs = _irs_gain()
    ref = _fft_filter(ref, irs)
    deg = _fft_filter(deg, irs)

    bark_r, pow_r = _bark_frames(ref)
    bark_d, pow_d = _bark_frames(deg)
    n_frames = min(len(bark_r), len(bark_d))
    if n_frames == 0:
        return float("nan"), float("nan")
    bark_r, bark_d = bark_r[:n_frames], bark_d[:n_frames]
    pow_r, pow_d = pow_r[:n_frames], pow_d[:n_frames]

    _b, widths, _c, P0 = _band_tables()
    silent = pow_r < 1e5  # frame activity threshold (internal scale)
    active = ~silent
    if not active.any():
        return float("nan"), float("nan")

    # per-band frequency compensation (partial equalization of the degraded
    # spectrum to the reference, averaged over active frames, bounded)
    num = (bark_r[active] + 1000.0).sum(0)
    den = (bark_d[active] + 1000.0).sum(0)
    band_pow_ratio = np.clip(num / den, 0.01, 100.0)
    bark_d_eq = bark_d * band_pow_ratio[None, :]

    # per-frame gain compensation of the reference toward the degraded
    frame_ratio = np.clip(
        (np.sum(bark_d_eq * widths, -1) + 5e3)
        / (np.sum(bark_r * widths, -1) + 5e3), 3e-4, 5.0)
    bark_r_eq = bark_r * frame_ratio[:, None]

    L_r = _loudness(bark_r_eq)
    L_d = _loudness(bark_d_eq)

    d = L_d - L_r
    m = 0.25 * np.minimum(L_d, L_r)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # symmetric disturbance: width-weighted RMS over Bark
    D_frame = np.sqrt(np.sum(d ** 2 * widths, -1) / widths.sum())
    # asymmetric disturbance: penalize additive distortion only
    asym = ((bark_d_eq + 50.0) / (bark_r_eq + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))
    DA_frame = np.sum(np.abs(d) * asym * widths, -1) / widths.sum()

    # weight quiet frames down (P.862 h = ((total+1e5)/1e7)^0.04)
    h = np.clip(((pow_r + 1e5) / 1e7) ** 0.04, None, 1.0)
    D_frame = np.minimum(D_frame / h, 45.0)
    DA_frame = np.minimum(DA_frame / h, 45.0 * 12.0)

    def psq_norm(v, split=20, p=6.0):
        """L_p over `split`-frame intervals, then L2 over intervals."""
        n = len(v)
        n_int = max(n // split, 1)
        v = v[:n_int * split].reshape(n_int, -1)
        per = (np.mean(v ** p, -1)) ** (1.0 / p)
        return float(np.sqrt(np.mean(per ** 2)))

    return psq_norm(D_frame), psq_norm(DA_frame)


def raw_to_mos_lqo(raw: float) -> float:
    """P.862.1 raw-score -> MOS-LQO mapping (narrowband)."""
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))


def pesq_nb(ref: np.ndarray, deg: np.ndarray, fs: int = SR) -> float:
    """P.862 narrowband MOS-LQO (P.862.1 mapping) for 1-D float signals."""
    D, DA = _disturbances(ref, deg, fs)
    if np.isnan(D):
        return float("nan")
    raw = 4.5 - CAL_SYM * D - CAL_ASYM * DA
    raw = float(np.clip(raw, -0.5, 4.5))
    return raw_to_mos_lqo(raw)


def pesq_batch(est: np.ndarray, gt: np.ndarray, fs: int) -> np.ndarray:
    """[..., T] pairs -> [...] MOS-LQO (channel loop on host)."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    out = np.empty(est.shape[:-1])
    flat_e = est.reshape(-1, est.shape[-1])
    flat_g = gt.reshape(-1, gt.shape[-1])
    for i, (e, g) in enumerate(zip(flat_e, flat_g)):
        out.flat[i] = pesq_nb(g, e, fs=fs)
    return out
