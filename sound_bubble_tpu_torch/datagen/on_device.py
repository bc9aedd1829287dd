"""Batched mixing and augmentation on the device (port of
`sound_bubble_tpu/datagen/on_device.py`).

Geometry and RIRs come pre-sampled (a campaign pool, `datagen/campaign.py`,
or `ism.compute_rirs_torch`); everything at the sample rate runs batched on
the tensors' device: RIR convolution, per-source peak scaling, SNR-exact
mixing, channel-gain / shift / colored-noise augmentation and clip renorm.

The randomness of each step is split from its synthesis, as in
`campaign.batch_draws` / `make_batch`: `peak_scale_draws`, `augment_draws`
and `training_batch_draws` take every random number from an explicit
`torch.Generator`, and `peak_scale`, `augment` and `make_training_batch`
are deterministic functions of those draws, so the same draws can be handed
to the synthesis from elsewhere.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.ops.fft_conv import fft_conv
from sound_bubble_tpu_torch.ops.noise import powerlaw_draws, powerlaw_noise


def render_sources(voices: torch.Tensor, rirs: torch.Tensor) -> torch.Tensor:
    """Batched RIR convolution. voices [B, S, T], rirs [B, S, M, L] ->
    premix [B, S, M, T] (truncated to T)."""
    out = fft_conv(voices[:, :, None, :], rirs, mode="full")
    return out[..., :voices.shape[-1]]


def peak_scale_draws(gen: torch.Generator, b: int, s: int, lo: float = 0.5,
                     hi: float = 0.9, device="cuda") -> dict:
    """The per-source peak scales U(lo, hi): {"scale": [b, s, 1, 1]}."""
    u = torch.rand((b, s, 1, 1), generator=gen, device=device)
    return {"scale": lo + (hi - lo) * u}


def peak_scale(premix: torch.Tensor, draws: dict) -> torch.Tensor:
    """Per-source random peak normalization (reference `:476-487`)."""
    peak = torch.amax(torch.abs(premix), dim=(-2, -1), keepdim=True)
    return premix / (peak + 1e-9) * draws["scale"]


def mix_to_target_snr(near: torch.Tensor, far: torch.Tensor,
                      target_snr: torch.Tensor, eps: float = 1e-9):
    """Batched exact SNR scaling (the reference quadratic,
    `generate_realdata_from_denoised.py:41-133`, with near == near_hat).

    near/far: [B, M, T] summed near/far signals; target_snr: [B].
    Returns (far_scale [B], mixture [B, M, T])."""
    near_pwr = torch.sum(near[:, 0] ** 2, -1)
    far_pwr = torch.sum(far[:, 0] ** 2, -1)
    target_noise_pwr = near_pwr / (10 ** (target_snr / 10))
    # near_error == 0 here (clean targets) -> k = sqrt(noise_pwr / far_pwr)
    k = torch.sqrt(target_noise_pwr / (far_pwr + eps))
    return k, near + k[:, None, None] * far


def augment_draws(gen: torch.Generator, b: int, m: int, t: int,
                  max_shift: int = 2, p_drop: float = 0.0,
                  device="cuda") -> dict:
    """The random numbers of `augment` for [b, m, t] mixtures: channel gain
    uniforms `gain` [b, m, 1], circular shifts `shift` [b, m] in
    [-max_shift, max_shift], white noise `white` [b, m, t], the pink and
    brown spectra (`powerlaw_draws`), noise level uniforms `level`
    [3, b, 1, 1], and with p_drop > 0 the channel-drop mask `drop`
    [b, m, 1]."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    d = {"gain": rand(b, m, 1),
         "shift": torch.randint(-max_shift, max_shift + 1, (b, m),
                                generator=gen, device=device),
         "white": torch.randn((b, m, t), generator=gen, device=device),
         "pink": powerlaw_draws(gen, (b, m), t, device),
         "brown": powerlaw_draws(gen, (b, m), t, device),
         "level": rand(3, b, 1, 1)}
    if p_drop > 0:
        d["drop"] = rand(b, m, 1) < p_drop
    return d


def augment(mixture: torch.Tensor, gt: torch.Tensor, draws: dict,
            max_gain_db: float = 3.0, noise_levels=(1e-3, 5e-3, 5e-3)):
    """Batched training augmentation (channel gain, circular sample shift,
    white+pink+brown noise, the channel drop of `augment_draws`' p_drop) from
    `draws`. gt follows channel 0."""
    t = mixture.shape[-1]
    gains = 10 ** ((draws["gain"] * 2 - 1) * max_gain_db / 20)
    mixture = mixture * gains
    gt = gt * gains[:, 0:1]

    shifts = draws["shift"]
    ar = torch.arange(t, device=mixture.device)
    idx = (ar[None, None, :] - shifts[..., None]) % t
    mixture = torch.gather(mixture, -1, idx)
    gt = torch.gather(gt, -1, idx[:, 0:1])

    wl, pl, bl = noise_levels
    lv = draws["level"]
    noise = (wl * lv[0]) * draws["white"]
    noise = noise + (pl * lv[1]) * powerlaw_noise(1, draws["pink"], t)
    noise = noise + (bl * lv[2]) * powerlaw_noise(2, draws["brown"], t)
    mixture = mixture + noise

    if "drop" in draws:
        drop = draws["drop"].clone()
        drop[:, 0] = False          # never drop the reference channel
        mixture = torch.where(drop, torch.zeros_like(mixture), mixture)
    return mixture, gt


def training_batch_draws(gen: torch.Generator, b: int, s: int, m: int,
                         t: int, max_shift: int = 2, p_drop: float = 0.0,
                         device="cuda") -> dict:
    """The random numbers of one `make_training_batch` call for voices
    [b, s, t] and m mics: {"peak": `peak_scale_draws`, "augment":
    `augment_draws`}."""
    return {"peak": peak_scale_draws(gen, b, s, device=device),
            "augment": augment_draws(gen, b, m, t, max_shift, p_drop,
                                     device)}


def make_training_batch(voices, rirs, n_near: int, target_snr, draws: dict,
                        augment_kwargs=None):
    """Full batch assembly on the device of the inputs.

    voices: [B, S, T] dry sources (first `n_near` are in-bubble),
    rirs: [B, S, M, L], target_snr: [B], draws: `training_batch_draws`;
    augment_kwargs: `augment`'s max_gain_db / noise_levels.
    Returns (inputs {'mixture'}, targets {'target'})."""
    premix = render_sources(voices, rirs)
    premix = peak_scale(premix, draws["peak"])
    near = torch.sum(premix[:, :n_near], dim=1)   # [B, M, T]
    far = torch.sum(premix[:, n_near:], dim=1)
    _, mixture = mix_to_target_snr(near, far, target_snr)
    gt = near[:, 0:1]
    mixture, gt = augment(mixture, gt, draws["augment"],
                          **(augment_kwargs or {}))
    # renormalize if clipped (reference `:735-741`)
    peak = torch.amax(torch.abs(mixture), dim=(-2, -1), keepdim=True)
    div = torch.clamp(peak, min=1.0)
    return {"mixture": mixture / div}, {"target": gt / div[:, 0:1]}
