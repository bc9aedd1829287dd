"""Seeded synthetic scenes in the reference data format, for smoke runs of
the trainer and for the train-step golden: numpy only, no real speech.

A scene is 6 mics x 2.5 s at 24 kHz (the flagship recipe's clip). Each voice
is a harmonic tone with a syllable-rate envelope, placed at a distance from
the wearer: it reaches each mic with an integer delay and a 1/distance gain.
A "negative" scene has every voice outside the bubble, so its target is
silent (the empty-bubble branch of SNRLP). `write_sample_dirs` writes scenes
as the sample dirs that `data/dataset.py` reads (`mixture.wav`,
`mic00_voiceXX.wav`, `metadata.json`); `golden_batch` gives scenes as one
in-memory batch, as the loader would collate it.
"""
from __future__ import annotations

import json
import os

import numpy as np

from sound_bubble_tpu_torch.data.dataset import DIS_EMBED_ONE_HOT

SR = 24000
CLIP_S = 2.5
N_MICS = 6
RADII = (("syn_1m", 1.0), ("syn_1_5m", 1.5), ("syn_2m", 2.0))


def _voice(rng, n):
    t = np.arange(n) / SR
    f0 = rng.uniform(90.0, 240.0) * (1.0 + 0.03 * np.sin(
        2 * np.pi * rng.uniform(3.0, 6.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k
              for k in range(1, 16))
    env = np.abs(np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t
                        + rng.uniform(0, np.pi))) ** 2
    return sig * env + 0.05 * rng.standard_normal(n)


def make_scene(rng, threshold: float, negative: bool):
    """(mixture [6, N], voices [(distance, mic00 track [N])], n inside)."""
    n = int(CLIP_S * SR)
    n_voices = int(rng.integers(1, 4))
    n_inside = 0 if negative else int(rng.integers(1, n_voices + 1))
    mixture = np.zeros((N_MICS, n))
    voices = []
    for v in range(n_voices):
        dist = (rng.uniform(0.3, threshold - 0.1) if v < n_inside
                else rng.uniform(threshold + 0.3, 3.5))
        dry = _voice(rng, n) * 0.2 / dist
        delays = rng.integers(0, 5, N_MICS)
        for m in range(N_MICS):
            mixture[m, delays[m]:] += dry[:n - delays[m]]
        voices.append((dist, np.concatenate(
            [np.zeros(delays[0]), dry[:n - delays[0]]])))
    mixture += 1e-3 * rng.standard_normal(mixture.shape)
    scale = 0.8 / np.abs(mixture).max()
    return ((mixture * scale).astype(np.float32),
            [(d, (track * scale).astype(np.float32)) for d, track in voices],
            n_inside)


def _write_scene(path, scene):
    from sound_bubble_tpu_torch.data.audio_io import write_audio_file

    mixture, voices, _ = scene
    os.makedirs(path, exist_ok=True)
    write_audio_file(os.path.join(path, "mixture.wav"), mixture, SR)
    meta = {}
    for v, (dist, track) in enumerate(voices):
        meta[f"voice{v:02d}"] = {"dis": float(dist)}
        write_audio_file(os.path.join(path, f"mic00_voice{v:02d}.wav"),
                         track[None], SR)
    for m in range(N_MICS):
        meta[f"mic{m:02d}"] = {}
    meta.update(n_BG=0, real=False)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)


def write_sample_dirs(root: str, seed: int, n_train: int = 4,
                      n_val: int = 2) -> dict[str, list[str]]:
    """root/syn_{1m,1_5m,2m}/{train,val}/NNNNN sample dirs; every third
    scene of each split is negative. Returns {split: [dataset dir, ...]}."""
    rng = np.random.default_rng(seed)
    dirs = {"train": [], "val": []}
    for name, threshold in RADII:
        for split, count in (("train", n_train), ("val", n_val)):
            base = os.path.join(root, name, split)
            for i in range(count):
                _write_scene(os.path.join(base, f"{i:05d}"),
                             make_scene(rng, threshold, i % 3 == 2))
            dirs[split].append(base)
    return dirs


def golden_batch(seed: int = 0):
    """Four scenes (1 m, 1.5 m, 2 m, 1 m; the third negative) as one
    (inputs, targets) batch of numpy arrays, the loader's collation."""
    rng = np.random.default_rng(seed)
    scenes = [(t, make_scene(rng, t, i == 2))
              for i, t in enumerate((1.0, 1.5, 2.0, 1.0))]
    mixture = np.stack([s[0] for _, s in scenes])
    target = np.stack([
        sum((tr for d, tr in s[1] if d <= t),
            np.zeros(mixture.shape[-1], np.float32))[None]
        for t, s in scenes]).astype(np.float32)
    n_in = np.asarray([s[2] for _, s in scenes])
    inputs = {"mixture": mixture, "dis_embed": np.asarray(
        [DIS_EMBED_ONE_HOT[t] for t, _ in scenes], np.float32)}
    targets = {"target": target, "num_target_speakers": n_in,
               "num_interfering_speakers": np.asarray(
                   [len(s[1]) for _, s in scenes]) - n_in,
               "num_noises": np.zeros(4, np.int64)}
    return inputs, targets
