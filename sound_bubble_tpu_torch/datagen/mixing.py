"""SNR-exact mixture scaling (port copy of
`sound_bubble_tpu/datagen/mixing.py`, numpy; reference
`generate_realdata_from_denoised.py:26-133`): scale the far/interfering audio
by the positive root of a quadratic so the reference-channel SNR hits the
target EXACTLY (asserted to 1e-3), with denoising-error-aware clipping when
the target is not physically realizable."""
from __future__ import annotations

import numpy as np

from sound_bubble_tpu_torch.metrics.metrics import snr as snr_metric

REFERENCE_CHANNEL = 0


def snr_at_reference(mix, gt_list, reference_channel: int = REFERENCE_CHANNEL):
    """SNR in dB of the mixture's reference channel against the sum of the
    ground truths' (`metrics.snr`, float32)."""
    mix = mix[reference_channel:reference_channel + 1]
    gt = np.zeros_like(mix)
    for audio in gt_list:
        gt = gt + audio[reference_channel:reference_channel + 1]
    return float(snr_metric(mix, gt).mean())


def rescale_mixture_to_target_snr(near_audio: list, far_audio: list,
                                  near_audio_gt: list, target_snr: float,
                                  eps: float = 1e-9):
    """Returns (achieved_target_snr, scaled_far_audio).

    Mixture = near + k*far; Target = near_hat; Noise = near - near_hat + k*far.
    Solve k from ||noise||^2 = ||near_hat||^2 / 10^(snr/10)."""
    ref = REFERENCE_CHANNEL
    near_hat = np.zeros(near_audio_gt[0].shape[-1])
    for audio in near_audio_gt:
        near_hat += audio[ref]
    near = np.zeros_like(near_hat)
    for audio in near_audio:
        near += audio[ref]
    far = np.zeros_like(near_hat)
    for audio in far_audio:
        far += audio[ref]

    near_hat_pwr = np.sum(near_hat ** 2)
    near_hat_pwr_db = 10 * np.log10(near_hat_pwr + eps)
    target_noise_pwr = 10 ** ((near_hat_pwr_db - target_snr) / 10)

    near_error = near - near_hat
    near_error_pwr = np.sum(near_error ** 2)
    far_pwr = np.sum(far ** 2)
    cross = far.dot(near_error)

    if target_noise_pwr < near_error_pwr:
        target_noise_pwr = near_error_pwr
        adjusted = near_hat_pwr_db - 10 * np.log10(target_noise_pwr)
        print(f"[WARNING] target SNR {target_snr}dB cannot be physically "
              f"realized due to denoising, clipping to {adjusted}dB")
        target_snr = adjusted

    roots = np.roots([far_pwr, 2 * cross, near_error_pwr - target_noise_pwr])
    assert not np.iscomplex(roots[0]), \
        "Scale factors are complex, target SNR is too high"
    far_scale = sorted(roots.real)[-1]

    far_audio = [far_scale * audio for audio in far_audio]

    mixture = near.copy()
    for audio in far_audio:
        mixture = mixture + audio[ref]
    achieved = 10 * np.log10((np.sum(near_hat ** 2) + eps)
                             / (np.sum((mixture - near_hat) ** 2) + eps))
    assert abs(achieved - target_snr) < 1e-3, \
        f"SNR is {achieved}, should be {target_snr}"
    return target_snr, far_audio
