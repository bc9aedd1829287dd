"""Scenario geometry for the campaign pool (port copy of three functions of
`sound_bubble_tpu/datagen/generate.py`, numpy; the rest of that module
renders sample dirs from audio files and is not ported).

Reference distributions (`generate_adaptive_dataset.py`): a head-shaped
6-mic array at a random pose in the room, in-bubble speakers on
[0.3 m, min(thresh, Rmax - 2)] annuli and out-of-bubble ones on
[thresh + 0.3, Rmax], with min-separation retries. They draw from numpy's
global generator, which `campaign.sample_scenario` seeds.
"""
from __future__ import annotations

import numpy as np

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
