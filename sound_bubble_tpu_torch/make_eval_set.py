"""Held-out synthetic eval sets, on the port.

    python -m sound_bubble_tpu_torch.make_eval_set --out data_eval --n 60 \
        --duration 2.5 [--voice formant|harmonic] [--bg_noise P] \
        [--device cuda|cpu]

The counterpart of the repo's `datasets/make_eval_set.py` (the same
arguments, plus `--device`, and the same sample dirs): per radius (1 / 1.5 /
2 m), N test samples split into 0/1/2-in-bubble thirds, rendered by the host
image-source pipeline (`datagen/generate.py:generate_sample`). For the same
seed every geometry, room and SNR, and so every `metadata.json`, is the JAX
script's; `--voice harmonic` sets are the same byte for byte, with or
without `--bg_noise`. `--voice formant` voices (`voice.formant_speechlike`,
synthesized on `--device`) are torch's draws, not jax.random's.
"""
import argparse
import os

import numpy as np

from sound_bubble_tpu_torch.datagen.generate import generate_sample
from sound_bubble_tpu_torch.datagen.voice import formant_speechlike
from sound_bubble_tpu_torch.ops.noise import powerlaw_psd_gaussian
from sound_bubble_tpu_torch.utils import resolve_device


def speechlike(rng, n, sr):
    """Modulated multi-band noise with pauses (a copy of
    `datasets/make_test_samples.py:speechlike`)."""
    t = np.arange(n) / sr
    f0 = rng.uniform(110, 220)
    sig = np.zeros(n)
    for k in range(1, 6):
        sig += rng.uniform(0.3, 1.0) / k * np.sin(
            2 * np.pi * f0 * k * t + rng.uniform(0, 6.28))
    sig *= 1 + 0.8 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    # pauses
    env = (np.sin(2 * np.pi * rng.uniform(0.3, 0.7) * t
                  + rng.uniform(0, 6.28)) > -0.7).astype(float)
    sig = sig * env + 0.02 * rng.standard_normal(n)
    return sig / np.abs(sig).max()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="data_eval")
    p.add_argument("--n", type=int, default=60, help="samples per radius")
    p.add_argument("--duration", type=float, default=2.5)
    p.add_argument("--sr", type=int, default=24000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--snr_min", type=float, default=-5.0,
                   help="reference test_target_snr_min")
    p.add_argument("--snr_max", type=float, default=5.0)
    p.add_argument("--max_order_min", type=int, default=10)
    p.add_argument("--max_order_max", type=int, default=40)
    p.add_argument("--bg_noise", type=float, default=0.0,
                   help="probability a sample carries far-field background "
                        "noise (colored noise through the huge second room "
                        "— reference n_BG in {0,1} semantics)")
    p.add_argument("--voice", default="formant",
                   choices=("formant", "harmonic"),
                   help="source model (formant = datagen.voice; harmonic = "
                        "quasi-speech harmonics)")
    p.add_argument("--device", default="cuda",
                   help="where the formant voices are synthesized: cuda "
                        "(default) or cpu")
    return p


def main(args: argparse.Namespace):
    if args.voice == "formant":
        device = resolve_device(args.device)

        def voice(rng, n, sr):
            return formant_speechlike(rng, n, sr, device=device)
    else:
        voice = speechlike

    radii = {"syn_1m": 1.0, "syn_1_5m": 1.5, "syn_2m": 2.0}
    n_samp = int(args.duration * args.sr)
    for name, radius in radii.items():
        rng = np.random.default_rng(args.seed + int(radius * 10))
        for i in range(args.n):
            n_in = i * 3 // args.n          # thirds: 0, 1, 2 in-bubble
            np.random.seed(int(rng.integers(0, 2 ** 31 - 1)))
            clips = [(voice(rng, n_samp, args.sr), f"synth{j}")
                     for j in range(n_in + 2)]
            noise_data = None
            # (guarded so --bg_noise 0 leaves the rng stream untouched)
            if args.bg_noise > 0 and rng.random() < args.bg_noise:
                # colored-noise ambience (the campaign's BG slot recipe:
                # beta~U(0,2) + slow AM)
                beta = rng.uniform(0.0, 2.0)
                noise_data = powerlaw_psd_gaussian(beta, n_samp, rng=rng)
                t = np.arange(n_samp) / args.sr
                depth = rng.uniform(0.0, 0.5)
                fm, ph = rng.uniform(0.1, 1.0), rng.uniform(0, 2 * np.pi)
                noise_data = noise_data * (
                    1.0 - depth * (0.5 + 0.5 * np.sin(2 * np.pi * fm * t
                                                      + ph)))
            out_dir = os.path.join(args.out, name, "test", f"{i:05d}")
            if os.path.exists(os.path.join(out_dir, "metadata.json")):
                continue
            generate_sample(
                clips, noise_data, n_in, output_dir=out_dir, sr=args.sr,
                duration=args.duration, n_out_range=(1, 2),
                dis_threshold=radius,
                snr_range=(args.snr_min, args.snr_max),
                max_order_range=(args.max_order_min, args.max_order_max))
            if (i + 1) % 10 == 0:
                print(f"{name}: {i + 1}/{args.n}", flush=True)


if __name__ == "__main__":
    main(parser().parse_args())
