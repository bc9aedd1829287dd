"""Formant-filtered glottal-pulse voices, batched (port of
`sound_bubble_tpu/datagen/voice.py:formant_voices`).

Klatt-style parallel-formant synthesis, as the JAX package builds its
campaign sources: a syllable track (voiced / unvoiced / plosive-onset /
pause) with per-syllable F0, formant and amplitude targets interpolated
between syllable centers; per-speaker vocal-tract length, F0 range, rate and
breathiness; a glottal impulse train from the running phase of the jittered
F0 contour plus aspiration, frication and plosive bursts; a time-varying
spectral envelope applied frame-wise (20 ms sqrt-Hann STFT, 75 % overlap);
leading silence, noise floor and peak normalization.

The randomness is split from the synthesis: `formant_draws` takes every
random number from an explicit `torch.Generator`, `formant_synth` is a
deterministic function of those draws, and `formant_voices` chains the two.
Every voice is computed at once along a leading batch axis (the JAX package
vmaps one voice).
"""
from __future__ import annotations

import numpy as np
import torch

from sound_bubble_tpu_torch.ops.stft import frame, overlap_add

# (name, low, high) of the per-voice scalar draws and the per-syllable ones
SPEAKER_DRAWS = (("f0_base", 95.0, 240.0), ("vtl", -0.12, 0.12),
                 ("f0_range", 0.5, 1.5), ("rate", 0.8, 1.3),
                 ("breath", 0.02, 0.09))
SYLLABLE_DRAWS = (("dur", 0.08, 0.25), ("u", 0.0, 1.0), ("f0", -0.3, 0.2),
                  ("F1", 300.0, 850.0), ("F2", 950.0, 2400.0),
                  ("F3", 2350.0, 3100.0), ("fric", 0.0, 1.5),
                  ("amp", 0.55, 1.0))


def shapes(n: int, sr: int) -> tuple[int, int, int, int]:
    """(hop, window, syllable slots, frames) of an n-sample voice."""
    hop = max(sr // 200, 1)          # 5 ms
    return hop, 4 * hop, int(n / sr * 5) + 2, n // hop + 5


def default_sil_hi(n: int, sr: int) -> float:
    """The leading-silence cap in samples: min(1.33 s, 0.4 n)."""
    return float(max(int(min(1.33 * sr, 0.4 * n)), int(0.083 * sr) + 1))


def formant_draws(gen: torch.Generator, m: int, n: int, sr: int,
                  sil_hi=None, device="cpu") -> dict:
    """The random numbers of m voices: the speaker and syllable uniforms of
    SPEAKER_DRAWS / SYLLABLE_DRAWS ([m], [m, S]), standard normals `jitter`
    [m, frames], `noise`, `burst`, `floor` [m, n], and the leading-silence
    length `zs` [m] (int64) under the cap sil_hi [m] (default
    `default_sil_hi`)."""
    _, _, n_syl, nf = shapes(n, sr)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    d = {k: uniform((m,), lo, hi) for k, lo, hi in SPEAKER_DRAWS}
    d.update({k: uniform((m, n_syl), lo, hi) for k, lo, hi in
              SYLLABLE_DRAWS})
    d["jitter"] = torch.randn((m, nf), generator=gen, device=device)
    for k in ("noise", "burst", "floor"):
        d[k] = torch.randn((m, n), generator=gen, device=device)
    lo = int(0.083 * sr)
    hi = (torch.full((m,), default_sil_hi(n, sr), device=device)
          if sil_hi is None else torch.as_tensor(sil_hi, device=device))
    hi = torch.clamp(hi.to(torch.int64), min=lo + 1)
    lo_t = torch.clamp(hi - 1, max=lo)
    u = torch.rand((m,), generator=gen, device=device, dtype=torch.float64)
    d["zs"] = torch.clamp(lo_t + (u * (hi - lo_t)).to(torch.int64),
                          max=hi - 1)
    return d


def _smooth(x: torch.Tensor, k: int) -> torch.Tensor:
    """Hann-kernel smoothing along the last axis (edge-padded)."""
    w = np.hanning(k + 2)[1:-1]
    w = (w / w.sum()).astype(np.float32)
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], k // 2), x,
                    x[..., -1:].expand(*x.shape[:-1], k - 1 - k // 2)], -1)
    n = x.shape[-1]
    return sum(float(w[i]) * xp[..., i:i + n] for i in range(k))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """`jnp.interp` row by row: x [L] (shared) at the knots xp [L'] (shared)
    or [m, L'], values fp [m, L'] -> [m, L]; constant outside the knots."""
    m = fp.shape[0]
    xp_b = xp.expand(m, -1).contiguous()
    x_b = x.expand(m, -1).contiguous()
    i = torch.clamp(torch.searchsorted(xp_b, x_b, right=True), 1,
                    xp_b.shape[-1] - 1)
    x0, x1 = xp_b.gather(-1, i - 1), xp_b.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + ((x_b - x0) / torch.where(
        dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x_b < xp_b[:, :1], fp[:, :1], f)
    return torch.where(x_b > xp_b[:, -1:], fp[:, -1:], f)


def formant_synth(d: dict, n: int, sr: int, pause_p=None,
                  f0_base=None) -> torch.Tensor:
    """[m, n] voices from the draws of `formant_draws`. pause_p [m] is the
    pause-syllable probability (default 0.20); f0_base [m] a talker F0 in Hz
    (<= 0 or None: the drawn one)."""
    hop, win, n_syl, nf = shapes(n, sr)
    dev = d["dur"].device
    m = d["dur"].shape[0]
    f32 = torch.float32
    pp = (torch.full((m,), 0.20, device=dev) if pause_p is None
          else torch.as_tensor(pause_p, dtype=f32, device=dev))[:, None]
    fb_in = (torch.full((m,), -1.0, device=dev) if f0_base is None
             else torch.as_tensor(f0_base, dtype=f32, device=dev))

    # per-speaker values
    f0_base = torch.where(fb_in > 0.0, fb_in, d["f0_base"])[:, None]
    vtl = (f0_base / 150.0) ** 0.25 * 2.0 ** d["vtl"][:, None]
    rate, breath = d["rate"][:, None], d["breath"][:, None]

    # syllable plan
    dur = d["dur"] * rate
    bounds = torch.cumsum(dur, -1)
    centers = bounds - dur / 2
    u = d["u"]
    is_pause = u < pp
    is_unv = (u >= pp) & (u < pp + 0.16)
    is_plos = (u >= pp + 0.16) & (u < pp + 0.32)
    voiced_s = ((~is_pause) & (~is_unv)).to(f32)
    f0_s = f0_base * 2.0 ** (d["f0_range"][:, None] * d["f0"])
    f0_s = f0_s * 2.0 ** (-0.2 * centers / (bounds[:, -1:] + 1e-6))
    formants = [vtl * d[k] for k in ("F1", "F2", "F3")]
    fric_s = 2500.0 * 2.0 ** d["fric"]
    amp_s = d["amp"] * (1.0 - is_pause.to(f32))

    # frame tracks (hop rate)
    ft = (torch.arange(nf, dtype=f32, device=dev) + 0.5) * hop / sr
    f0_f = interp(ft, centers, f0_s)
    F1_f, F2_f, F3_f = (interp(ft, centers, v) for v in formants)
    idx = torch.clamp(torch.searchsorted(bounds.contiguous(),
                                         ft.expand(m, -1).contiguous()),
                      0, n_syl - 1)
    amp_f = _smooth(amp_s.gather(-1, idx), 9)
    voiced_f = _smooth(voiced_s.gather(-1, idx), 9)
    fric_f = _smooth(fric_s.gather(-1, idx), 5)
    # plosive bursts at stop-syllable onsets
    dt = ft[None, None, :] - (bounds - dur)[:, :, None]       # [m, S, nf]
    gain_s = is_plos.to(f32) * (0.35 + 0.65 * amp_s)
    # 0 before the onset (exp overflows to inf there, and inf * 0 is nan;
    # XLA's exp saturates instead)
    decay = torch.where(dt >= 0.0, torch.exp(-torch.clamp(dt, min=0.0)
                                             / 0.012), 0.0)
    burst_f = torch.sum(gain_s[:, :, None] * decay, dim=1)

    # sample-rate excitation
    st = torch.arange(n, dtype=f32, device=dev) / sr
    f0_n = interp(st, ft, f0_f)
    jitter = _smooth(d["jitter"], 15)
    f0_n = f0_n * (1.0 + 0.03 * interp(st, ft, jitter))
    amp_n = interp(st, ft, amp_f)
    voiced_n = interp(st, ft, voiced_f)
    phase = torch.cumsum(f0_n, -1) / sr
    fr = phase - torch.floor(phase)
    step = torch.diff(fr, prepend=torch.zeros_like(fr[:, :1]))
    pulse = (step < 0).to(f32) * torch.sqrt(sr / torch.clamp(f0_n, min=1.0))
    burst_n = interp(st, ft, burst_f)
    exc = (pulse * voiced_n * amp_n
           + d["noise"] * amp_n * (0.35 * (1.0 - voiced_n)
                                   + breath * voiced_n)
           + d["burst"] * burst_n * 0.8)

    # frame-wise formant filtering (sqrt-Hann analysis + synthesis OLA)
    w = torch.as_tensor(np.hanning(win + 1)[:-1].astype(np.float32) ** 0.5,
                        device=dev)
    tot = (nf - 1) * hop + win
    frames = frame(torch.nn.functional.pad(exc, (0, tot - n)), win, hop) * w
    spec = torch.fft.rfft(frames)
    freqs = torch.as_tensor((np.fft.rfftfreq(win) * sr).astype(np.float32),
                            device=dev)

    def reso(fc, bw):
        return (bw * bw) / (torch.square(freqs - fc[..., None]) + bw * bw)

    tilt = (1.0 + torch.square(freqs / 700.0)) ** -0.9
    h_v = (1.0 * reso(F1_f, 80.0) + 0.5 * reso(F2_f, 120.0)
           + 0.3 * reso(F3_f, 180.0) + 0.005) * tilt
    fc = fric_f[..., None]
    fbw = 0.35 * fc
    hp = torch.square(freqs / fc) / (1.0 + torch.square(freqs / fc))
    roll = 1.0 / (1.0 + torch.square(freqs / 8000.0))
    h_uv = 0.28 * hp * roll * (fbw ** 2 / (torch.square(freqs - fc)
                                           + fbw ** 2) + 0.30 * hp) + 0.004
    vf = voiced_f[..., None]
    h = vf * h_v + (1.0 - vf) * h_uv
    y = overlap_add(torch.fft.irfft(spec * h, n=win) * w, hop)[:, :n] / 1.5

    # leading silence, floor, peak normalization
    y = torch.where(torch.arange(n, device=dev) < d["zs"][:, None],
                    torch.zeros_like(y), y)
    y = y + 0.0007 * d["floor"]
    return y / (torch.amax(torch.abs(y), dim=-1, keepdim=True) + 1e-9)


def formant_voices(gen: torch.Generator, batch_shape, n: int, sr: int,
                   pause_p=None, sil_hi=None, f0_base=None,
                   device="cpu") -> torch.Tensor:
    """[*batch_shape, n] float32 formant voices. Optional per-voice
    overrides, each [*batch_shape]: `pause_p` (default 0.20), `sil_hi`
    leading-silence cap in samples, `f0_base` talker F0 in Hz (<= 0: draw
    it)."""
    bs = tuple(batch_shape)
    m = int(np.prod(bs)) if bs else 1

    def flat(v):
        return None if v is None else torch.as_tensor(
            v, dtype=torch.float32, device=device).reshape(m)

    d = formant_draws(gen, m, n, sr, flat(sil_hi), device)
    return formant_synth(d, n, sr, flat(pause_p), flat(f0_base)).reshape(
        bs + (n,))
