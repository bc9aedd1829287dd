"""Sample-dir datasets for synthetic/real bubble data (port copy of
`sound_bubble_tpu/data/dataset.py`; host numpy code).

Data format (reference SURVEY §2.8): each sample dir holds `mixture.wav`
(M-channel), per-voice reference-channel ground truths `mic00_voiceXX.wav`,
and `metadata.json` with per-voice `{dis, ...}`, `n_BG`, `real`.

Two dataset classes, mirroring
the reference's `src/datasets/general_multisrc_dataset_dis_embed.py` and
`multisrc_dataset_with_perturbations.py`:
- `DistanceEmbedDataset`: bubble radius inferred per source dir from its
  parent name (syn_1m / syn_1_5m / syn_2m / ...), one-hot `dis_embed` emitted;
- `FixedThresholdDataset`: single `dis_threshold` argument, no embedding
  (used by the real_experiments / edge configs).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from sound_bubble_tpu_torch.data.audio_io import read_audio_file
from sound_bubble_tpu_torch.data.perturbations import AudioPerturbations
from sound_bubble_tpu_torch.utils import read_json

# parent-dir (or grandparent) name -> bubble radius (reference `:46-66`)
_DIR_RADIUS = {
    "syn_1m": 1.0, "syn_1_5m": 1.5, "syn_2m": 2.0,
    "glasses_1m": 1.0, "glass_1_5m": 1.5, "glass_2m": 2.0,
    "hearing_1_5m": 1.5, "hearing2_1_5m": 1.5,
}
_GRANDPARENT_RADIUS = {"binural_1_5m": 1.5}

DIS_EMBED_ONE_HOT = {1.0: [0.0, 0.0, 1.0], 1.5: [0.0, 1.0, 0.0],
                     2.0: [1.0, 0.0, 0.0]}


def radius_from_path(dirpath: str) -> float:
    parts = str(dirpath).rstrip("/").split("/")
    if len(parts) >= 2 and parts[-2] in _DIR_RADIUS:
        return _DIR_RADIUS[parts[-2]]
    if len(parts) >= 3 and parts[-3] in _GRANDPARENT_RADIUS:
        return _GRANDPARENT_RADIUS[parts[-3]]
    raise ValueError(f"Invalid distance dataset: {dirpath}")


class _BaseDataset:
    def __init__(self, n_mics=6, sr=48000, directional=True,
                 fair_compare=False, prob_neg=0, perturbations=(),
                 downsample=1, mic_config=(), sig_len=4.5,
                 reference_channels=None, split="val"):
        self.n_mics = n_mics
        self.sr = sr
        self.downsample = downsample
        self.mic_lists = list(mic_config)
        self.reference_mics = [0] if reference_channels is None else list(
            reference_channels)
        self.sig_len = int(sig_len * sr / downsample)
        self.split = split
        self.perturbations = AudioPerturbations(list(perturbations))
        self.valid_dirs: list = []

    def __len__(self):
        return len(self.valid_dirs)

    def _load_sample(self, curr_dir, dis_threshold):
        metadata = read_json(os.path.join(curr_dir, "metadata.json"))
        voices = [k for k in metadata if "voice" in k]
        mics_all = [k for k in metadata if "mic" in k]
        if self.n_mics != len(self.mic_lists):
            raise ValueError(f"n_mics={self.n_mics} but mic_config names "
                             f"{len(self.mic_lists)} mics")

        mixture = read_audio_file(os.path.join(curr_dir, "mixture.wav"),
                                  self.downsample)
        if len(self.mic_lists) < mixture.shape[0]:
            rows = [int(m[-2:]) for m in self.mic_lists]
            mixture = mixture[rows]

        target = np.zeros((len(self.reference_mics), mixture.shape[-1]),
                          np.float32)
        n_tgt = 0
        real = metadata["real"]
        for voice in voices:
            d = (int(metadata[voice]["dis"]) / 100 if real
                 else metadata[voice]["dis"])
            if d <= dis_threshold:
                for ch_idx, mic in enumerate(self.reference_mics):
                    audio = read_audio_file(
                        os.path.join(curr_dir, f"{mics_all[mic]}_{voice}.wav"),
                        self.downsample)
                    target[ch_idx] += audio[0]
                n_tgt += 1

        peak = np.abs(target).max()
        if (n_tgt == 0) != (peak == 0):
            raise ValueError(f"{curr_dir}: {n_tgt} inside speakers but a "
                             f"target of peak {peak}")

        if self.sig_len < mixture.shape[-1]:
            delta = mixture.shape[-1] - self.sig_len
            begin = np.random.randint(1000, delta - 1)
            mixture = mixture[..., begin:begin + self.sig_len]
            target = target[..., begin:begin + self.sig_len]

        if self.split == "train":
            mixture, target = self.perturbations.apply_random_perturbations(
                mixture, target)

        return (np.asarray(mixture, np.float32), np.asarray(target, np.float32),
                n_tgt, len(voices) - n_tgt, metadata)


class DistanceEmbedDataset(_BaseDataset):
    def __init__(self, dataset_dirs, **kwargs):
        super().__init__(**kwargs)
        self.dirs = []
        self.dis_embeds = []
        for entry in dataset_dirs:
            samples = sorted(Path(entry["path"]).glob("[0-9]*"))
            samples = samples[:entry["max_samples"]]
            radius = radius_from_path(entry["path"])
            self.dis_embeds.extend([radius] * len(samples))
            self.dirs.extend(samples)
        self.valid_dirs = self.dirs

    def __getitem__(self, idx):
        idx = idx % len(self.valid_dirs)
        curr_dir = self.valid_dirs[idx]
        dis_thred = self.dis_embeds[idx]
        mixture, target, n_tgt, n_far, metadata = self._load_sample(
            curr_dir, dis_thred)
        if dis_thred not in DIS_EMBED_ONE_HOT:
            raise ValueError("Invalid distance")
        inputs = {
            "mixture": mixture,
            "reference_channels": np.asarray(self.reference_mics, np.int64),
            "dis_embed": np.asarray(DIS_EMBED_ONE_HOT[dis_thred], np.float32),
        }
        targets = {
            "target": target,
            "targets_outside": np.zeros((1, mixture.shape[-1]), np.float32),
            "num_target_speakers": n_tgt,
            "num_interfering_speakers": n_far,
            "num_noises": metadata["n_BG"],
        }
        return inputs, targets


class FixedThresholdDataset(_BaseDataset):
    def __init__(self, dataset_dirs, dis_threshold=1.5, **kwargs):
        super().__init__(**kwargs)
        self.dis_threshold = dis_threshold
        self.dirs = []
        for entry in dataset_dirs:
            samples = sorted(Path(entry["path"]).glob("[0-9]*"))
            self.dirs.extend(samples[:entry["max_samples"]])
        # keep only dirs that actually have metadata (reference `:76-82`)
        self.valid_dirs = [d for d in self.dirs
                           if os.path.exists(Path(d) / "metadata.json")]

    def __getitem__(self, idx):
        curr_dir = self.valid_dirs[idx % len(self.valid_dirs)]
        mixture, target, n_tgt, n_far, metadata = self._load_sample(
            curr_dir, self.dis_threshold)
        inputs = {
            "mixture": mixture,
            "reference_channels": np.asarray(self.reference_mics, np.int64),
        }
        targets = {
            "target": target,
            "targets_outside": np.zeros((1, mixture.shape[-1]), np.float32),
            "num_target_speakers": n_tgt,
            "num_interfering_speakers": n_far,
            "num_noises": metadata.get("n_BG", 0),
        }
        return inputs, targets
