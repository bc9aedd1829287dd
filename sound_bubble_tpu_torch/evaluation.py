"""Eval plumbing (port of `sound_bubble_tpu/evaluation.py`): testcase
loading, offline inference through a PLModule's `model`
(`run_testcase_offline`, the JAX package's `run_testcase`, used by the eval
CLIs) and streaming inference through `FusedStreamer` (`run_testcase`, the
serving CLI's).

GT = sum of the mic00 per-voice tracks with distance <= threshold; one-hot
dis_embed 1m->[0,0,1], 1.5m->[0,1,0], 2m->[1,0,0].
"""
from __future__ import annotations

import csv
import json
import math
import os

import numpy as np
import torch

from sound_bubble_tpu_torch.ops.stft import mod_pad
from sound_bubble_tpu_torch.utils import read_audio_file

ONE_HOT = {1.0: [0.0, 0.0, 1.0], 1.5: [0.0, 1.0, 0.0], 2.0: [1.0, 0.0, 0.0]}


def one_hot(distance_threshold: float):
    if float(distance_threshold) not in ONE_HOT:
        raise ValueError("Invalid distance threshold")
    return [ONE_HOT[float(distance_threshold)]]


def _csv_cell(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else v


def write_records_csv(path, records):
    """Write a list of row dicts as pandas'
    `DataFrame.from_records(records).to_csv(path)` lays them out: a leading
    unnamed index column (0, 1, ...), the union of the rows' keys as columns
    in first-seen order, an empty cell for a missing or NaN value, floats
    in their shortest round-trip form."""
    columns = list(dict.fromkeys(k for row in records for k in row))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + columns)
        for i, row in enumerate(records):
            writer.writerow([i] + [_csv_cell(row.get(k)) for k in columns])


def load_testcase(sample_dir: str, sr: int, distance_threshold: float):
    with open(os.path.join(sample_dir, "metadata.json"), "rb") as f:
        metadata = json.load(f)
    mixture = read_audio_file(os.path.join(sample_dir, "mixture.wav"), sr)

    gt = np.zeros((1, mixture.shape[-1]))
    speakers = [k for k in metadata if k.startswith("voice")]
    dis_near, dis_far, angle_near, angle_far = [], [], [], []
    tgt_speakers = []
    for speaker in speakers:
        d = (metadata[speaker]["dis"] / 100 if metadata["real"]
             else metadata[speaker]["dis"])
        angle = metadata[speaker].get("angle")
        if d <= distance_threshold:
            dis_near.append(d)
            angle_near.append(angle)
            solo = read_audio_file(
                os.path.join(sample_dir, f"mic00_{speaker}.wav"), sr)
            gt += solo
            tgt_speakers.append(metadata[speaker])
        else:
            dis_far.append(d)
            angle_far.append(angle)
    spatial_info = {"angle_near": angle_near, "dis_near": dis_near,
                    "angle_far": angle_far, "dis_far": dis_far}
    return metadata, mixture, gt, tgt_speakers, spatial_info


def run_testcase_offline(model, mixture: np.ndarray,
                         dis_threshold: float = -1) -> np.ndarray:
    """Offline inference (`Net(pad=True)`) on one multichannel mixture
    [M, N] -> [n_srcs, N] through `model`, a PLModule's `model` handle. A
    `dis_threshold` of -1 gives the model no `dis_embed` (the unconditioned
    path); another one its one-hot embedding."""
    inputs = {"mixture": np.asarray(mixture, np.float32)[None]}
    if dis_threshold != -1:
        inputs["dis_embed"] = np.asarray(one_hot(dis_threshold), np.float32)
    outputs = model(inputs)
    return outputs["output"][0].cpu().numpy()


def run_testcase(streamer, mixture: np.ndarray,
                 dis_threshold: float = -1) -> np.ndarray:
    """Stream one multichannel mixture [M, N] through `streamer` (a
    FusedStreamer, reset first) chunk by chunk -> [n_srcs, N]. A
    `dis_threshold` other than -1 sets the streamer's distance embedding.

    The mixture is padded exactly as the offline `Net(pad=True)` pads it
    (up to a chunk multiple, plus the lookahead), and the appended samples
    are trimmed, so the output equals the offline output sample for sample
    and has the mixture's length."""
    cfg = streamer.cfg
    chunk, pad = cfg.stft_chunk_size, cfg.stft_pad_size
    x = torch.from_numpy(np.asarray(mixture, np.float32))[None]
    x, mod = mod_pad(x, chunk, (cfg.stft_back_pad, pad))
    x = x.to(streamer.device)
    n_chunks = (x.shape[-1] - pad) // chunk
    if dis_threshold != -1:
        streamer.set_dis_embed(one_hot(dis_threshold))
    streamer.reset()
    outs = [streamer.feed(x[..., k * chunk:k * chunk + chunk + pad])
            for k in range(n_chunks)]
    y = torch.cat(outs, dim=-1)[0]
    if mod:
        y = y[..., :-mod]
    return y.cpu().numpy()
