"""Synthetic scenario generation: rooms, mic arrays, speaker placement,
source material, rendering and writing sample dirs (port copy of
`sound_bubble_tpu/datagen/generate.py`, numpy and scipy).

Parameter distributions pinned to the reference
(`generate_adaptive_dataset.py`): shoebox 5-8 x 4-8 x 2-4 m, absorption
U(0.1,0.9), image order U{10..71}, head-shaped 6-mic array at a random pose,
in-bubble speakers on [0.3m, min(thresh, Rmax-2)] annuli and out-of-bubble
on [thresh+0.3, Rmax] with min-separation retries, far-field background
noise rendered in a huge second room, per-source peak scaling U(0.5,0.9),
target SNR U(-10,5) train / U(-5,5) test via the exact quadratic rescale,
sample-dir output format {mixture.wav, mic00_voiceXX.wav, metadata.json}.

Every random number comes from numpy's global generator (`np.random`), in
the JAX package's order, so the same seed and the same clips write the same
sample dirs byte for byte. `campaign.sample_scenario` seeds that generator
for the three geometry samplers.
"""
from __future__ import annotations

import json
import os

import numpy as np

from sound_bubble_tpu_torch.data.audio_io import read_audio, write_audio_file
from sound_bubble_tpu_torch.data.resample import resample_poly_np
from sound_bubble_tpu_torch.datagen.ism import ShoeBox
from sound_bubble_tpu_torch.datagen.mixing import (
    rescale_mixture_to_target_snr, snr_at_reference,
)

MIC_WALL_SPACING = 0.5
MIC_HEIGHT = 1.5
OUT_IN_SPACE = 0.3
MIN_HEAD_DIS = 0.3

# head-shaped 6-mic geometry, cm (reference `:288-295`)
HEADPHONE_MICS_CM = np.array([
    [-12.8, -1.5, 0.0],
    [-10.2, 0.0, 11.3],
    [-3.8, 0.0, 16.9],
    [3.8, 0.0, 16.9],
    [10.6, 0.0, 11.7],
    [13.1, -1.5, 0.7],
])


def trim_silence(audio: np.ndarray, top_db: float = 18.0,
                 frame_length: int = 2048, hop: int = 512):
    """librosa.effects.trim equivalent: (trimmed, (begin, end)) sample idx."""
    if len(audio) < frame_length:
        return audio, (0, len(audio))
    n = (len(audio) - frame_length) // hop + 1
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n)[:, None]
    rms = np.sqrt(np.mean(audio[idx] ** 2, axis=1))
    thresh = rms.max() * 10 ** (-top_db / 20)
    above = np.where(rms > thresh)[0]
    if len(above) == 0:
        return audio[:0], (0, 0)
    begin = above[0] * hop
    end = min(above[-1] * hop + frame_length, len(audio))
    return audio[begin:end], (begin, end)


def _load_48k(path):
    data, sr = read_audio(path)
    audio = data[0]
    if sr != 48000:
        audio = resample_poly_np(audio, 48000, sr)
    return audio


def load_voice_clip(files_list, total_samples_48: int, sr: int):
    """Concat <=3 silence-trimmed utterances with random gaps, pad/cut to
    length, resample to `sr`, peak-normalize. Returns audio or None."""
    zero_front = np.random.randint(4000, 64000)
    total_length = zero_front
    pieces = [np.zeros(zero_front)]
    used = 0
    for f in files_list:
        if used >= 3:
            break
        used += 1
        voice = _load_48k(f)
        trimmed, (b, e) = trim_silence(voice, top_db=18)
        if trimmed.std() <= 2e-4 or e - b < 2000:
            continue
        voice = voice[max(b - 2000, 0):min(e + 2000, len(voice))]
        pad_s = int(np.random.uniform(0.2 * 48000, 0.8 * 48000))
        pieces.append(voice)
        pieces.append(np.zeros(pad_s))
        total_length += len(voice) + pad_s
        if total_length >= total_samples_48:
            break
    audio = np.concatenate(pieces, axis=-1)
    if len(audio) < total_samples_48:
        audio = np.pad(audio, (0, total_samples_48 - len(audio)))
    audio = audio[:total_samples_48]
    audio = resample_poly_np(audio, sr, 48000)
    peak = np.abs(audio).max()
    if peak == 0:
        return None
    return audio / peak


def get_noise(noise_list, total_samples: int, sr: int):
    total_samples_48 = total_samples * 2
    total, noises = 0, []
    while total < total_samples_48:
        noise = _load_48k(np.random.choice(noise_list))
        noise = noise / (np.abs(noise).max() + 1e-9)
        noises.append(noise)
        total += len(noise)
    audio = np.concatenate(noises, axis=-1)[:total_samples_48]
    return resample_poly_np(audio, sr, 48000)


def angle_between_2d_vectors(v1, v2):
    m1, m2 = np.linalg.norm(v1), np.linalg.norm(v2)
    if m1 == 0 or m2 == 0:
        return 0.0
    cos = np.dot(v1, v2) / (m1 * m2)
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def get_random_mic_positions_headphone(n_mics, left, right, bottom, top):
    assert n_mics == 6
    cx = np.random.uniform(left + MIC_WALL_SPACING, right - MIC_WALL_SPACING)
    cy = np.random.uniform(bottom + MIC_WALL_SPACING, top - MIC_WALL_SPACING)
    cz = np.random.uniform(MIC_HEIGHT - 0.3, MIC_HEIGHT + 0.3)
    center = np.array([cx, cy, cz])
    theta = np.random.uniform(-np.pi, np.pi)
    mics = HEADPHONE_MICS_CM / 100.0
    c, s = np.cos(theta), np.sin(theta)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
    return center, np.rad2deg(theta), mics @ rz + center


def choose_point_with_circle_keepout(left, right, down, up, center,
                                     r_min, r_max, max_tries=64):
    """A point at radius U(r_min, r_max) from `center` inside the box."""
    for _ in range(max_tries):
        r = np.random.uniform(r_min, r_max)
        offs = np.random.uniform(0, 1)
        angles = np.deg2rad(np.arange(0, 360) + offs)
        px = r * np.cos(angles) + center[0]
        py = r * np.sin(angles) + center[1]
        inside = (px > left) & (px < right) & (py > down) & (py < up)
        if inside.any():
            a = np.random.choice(np.where(inside)[0])
            return r, np.array([px[a], py[a]])
    raise RuntimeError("no radius intersects the room")


def get_random_speaker_positions_dis_uniform(dis_threshold, n_in, n_out,
                                             mic_center, left, right, up,
                                             down):
    voices, dis = [], []
    safe = 0.25
    minx, maxx = left + safe, right - safe
    miny, maxy = down + safe, up - safe
    corners = [[minx, miny], [maxx, miny], [minx, maxy], [maxx, maxy]]
    r_max = max(np.linalg.norm([x - mic_center[0], y - mic_center[1]])
                for x, y in corners) - 0.2

    def far_enough(pos, limit_gap=None, r=None):
        for j, p2 in enumerate(voices):
            if np.linalg.norm(p2 - pos) < 0.5:
                return False
            if limit_gap is not None and j < n_in and \
                    abs(dis[j] - r) < limit_gap:
                return False
        return True

    for _ in range(n_in):
        while True:
            r, pos = choose_point_with_circle_keepout(
                minx, maxx, miny, maxy, mic_center, MIN_HEAD_DIS,
                min(dis_threshold, r_max - 2))
            if far_enough(pos):
                break
        voices.append(pos)
        dis.append(r)
    for _ in range(n_out):
        while True:
            r, pos = choose_point_with_circle_keepout(
                minx, maxx, miny, maxy, mic_center,
                min(dis_threshold + OUT_IN_SPACE, r_max - 0.5), r_max)
            if far_enough(pos, limit_gap=OUT_IN_SPACE, r=r):
                break
        voices.append(pos)
        dis.append(r)
    return voices, dis


def generate_data_scenario(mic_positions, voice_positions, voices_data,
                           noise_data, total_samples, room_dims, sr,
                           n_in, n_out, absorption, max_order):
    """Render all sources in the room; far-field BG noise in a huge second
    room. Returns (near_list, far_list, rt60)."""
    room = ShoeBox(p=room_dims, fs=sr, max_order=max_order,
                   absorption=absorption)
    room.add_microphone_array(mic_positions.T)
    for pos, (sig, _sid) in zip(voice_positions, voices_data):
        room.add_source(pos, signal=sig)
    premix = room.simulate(return_premix=True)
    rt60 = float(np.mean(room.measure_rt60()))

    n_mics = mic_positions.shape[0]
    gt_signals = np.zeros((len(voice_positions), n_mics, total_samples))
    for i in range(len(voice_positions)):
        for j in range(n_mics):
            gt_signals[i][j] = np.pad(premix[i][j],
                                      (0, total_samples))[:total_samples]

    near_list, far_list = [], []
    for i in range(n_in):
        scale = np.random.uniform(0.5, 0.9)
        gt = gt_signals[i] / np.abs(gt_signals[i]).max() * scale
        near_list.append(gt)
    for i in range(n_in, n_in + n_out):
        scale = np.random.uniform(0.5, 0.9)
        gt = gt_signals[i] / np.abs(gt_signals[i]).max() * scale
        far_list.append(gt)

    if noise_data is not None:
        dims2 = [np.random.uniform(30, 40), np.random.uniform(50, 60),
                 np.random.uniform(10, 20)]
        room2 = ShoeBox(p=dims2, fs=sr, max_order=15, absorption=absorption)
        room2.add_microphone_array(mic_positions.T)
        bg = [np.random.uniform(15, dims2[0] - 2),
              np.random.uniform(20, dims2[1] - 2),
              np.random.uniform(3, dims2[2] - 2)]
        room2.add_source(bg, signal=noise_data)
        premix_bg = room2.simulate(return_premix=True)[:, :, 2000:]
        premix_bg = premix_bg * np.random.uniform(0.05, 0.4) \
            / np.abs(premix_bg).max()
        noise_signals = np.zeros((n_mics, total_samples))
        for i in range(n_mics):
            noise_signals[i] = np.pad(premix_bg[0, i],
                                      (0, total_samples))[:total_samples]
        far_list.append(noise_signals)
    return near_list, far_list, rt60


def write_data(room_name, room_info, output_dir, mic_positions, mic_center,
               distances, voice_positions, voices_data, mixture, gt,
               target_snr, snr_clipped, sr, n_in, n_out, n_bg):
    metadata = {}
    head_vector = mic_positions[0, :2] - mic_positions[-1, :2]
    for vidx, d in enumerate(distances):
        pos = voice_positions[vidx]
        angle = angle_between_2d_vectors(pos[:2] - mic_center[:2],
                                         head_vector) - 90
        metadata[f"voice{vidx:02d}"] = dict(
            dis=float(d), angle=float(angle),
            speaker_id=voices_data[vidx][1], position=list(map(float, pos)))
    for midx in range(mixture.shape[0]):
        metadata[f"mic{midx:02d}"] = dict(
            position=list(map(float, mic_positions[midx])))
    metadata.update(n_in=n_in, n_out=n_out, n_BG=n_bg, real=False,
                    room=room_name, room_info=room_info,
                    input_snr=target_snr, snr_clipped=int(snr_clipped))
    os.makedirs(output_dir, exist_ok=True)
    for vidx, audio in enumerate(gt):
        write_audio_file(
            os.path.join(output_dir, f"mic00_voice{vidx:02d}.wav"),
            audio[0], sr)
    write_audio_file(os.path.join(output_dir, "mixture.wav"), mixture, sr)
    with open(os.path.join(output_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=4)


def generate_sample(voice_clips, noise_data, n_inside, *, output_dir,
                    sr=24000, duration=5.0, n_out_range=(1, 2),
                    dis_threshold=1.0, snr_range=(-10, 5), n_mics=6,
                    max_order_range=(10, 72)):
    """Generate one sample dir. `voice_clips` = list of (audio, speaker_id)
    already at `sr` (source-corpus loading is the caller's job)."""
    total_samples = int(duration * sr)
    n_out = np.random.randint(n_out_range[0], n_out_range[1] + 1)
    n_in = n_inside
    n_bg = 1 if noise_data is not None else 0
    voices_data = voice_clips[:n_in + n_out]
    assert len(voices_data) == n_in + n_out, "not enough voice clips"

    right = np.random.uniform(5, 8)
    top = np.random.uniform(4, 8)
    ceiling = np.random.uniform(2, 4)
    left = bottom = 0.0

    mic_center, head_angle, mic_positions = \
        get_random_mic_positions_headphone(n_mics, left, right, bottom, top)
    voice_positions, dis = get_random_speaker_positions_dis_uniform(
        dis_threshold, n_in, n_out, mic_center, left, right, top, bottom)
    voice_positions = np.array([
        list(p) + [np.random.uniform(MIC_HEIGHT - 0.25, MIC_HEIGHT + 0.25)]
        for p in voice_positions])

    for i, pos in enumerate(voice_positions):
        r = np.linalg.norm(pos[:2] - mic_center[:2])
        if i < n_in:
            assert r <= dis_threshold, f"Source {i} too far!"
        else:
            assert r > dis_threshold, f"Source {i} too close!"

    absorption = np.random.uniform(0.1, 0.9)
    max_order = np.random.randint(*max_order_range)

    near_list, far_list, rt60 = generate_data_scenario(
        mic_positions, voice_positions, voices_data, noise_data,
        total_samples, [right, top, ceiling], sr, n_in, n_out,
        absorption, max_order)

    if near_list:
        target_snr = np.random.uniform(*snr_range)
        adjusted_snr, far_list = rescale_mixture_to_target_snr(
            near_list, far_list, near_list, target_snr)
    else:
        target_snr = adjusted_snr = None

    mixture = None
    for audio in near_list + far_list:
        mixture = audio.copy() if mixture is None else mixture + audio
    if np.abs(mixture).max() > 1:
        div = np.abs(mixture).max()
        mixture /= div
        near_list = [a / div for a in near_list]
    if near_list:
        achieved = snr_at_reference(mixture, near_list)
        assert abs(achieved - adjusted_snr) < 1e-3, \
            f"Omni SNR {achieved} != target {adjusted_snr}"

    room_info = {"walls": [left, right, top, bottom],
                 "absorption": float(absorption),
                 "max_order": int(max_order), "rt60": rt60}
    write_data("Synthetic", room_info, output_dir, mic_positions, mic_center,
               dis, voice_positions, voices_data, mixture, near_list,
               adjusted_snr, adjusted_snr != target_snr, sr, n_in, n_out,
               n_bg)
    return output_dir
