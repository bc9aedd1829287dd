"""Shoebox image-source geometry (port copy of
`sound_bubble_tpu/datagen/ism.py`: `FDL` and `shoebox_images`, numpy).

Allen & Berkley images of a source in a shoebox room at the origin, up to
`max_order` total reflections; the campaign pool (`datagen/campaign.py`)
turns them into room impulse responses.
"""
from __future__ import annotations

import numpy as np

FDL = 81  # fractional delay filter length (odd)


def shoebox_images(room_dim, source, max_order: int):
    """Image positions + reflection counts for a shoebox at the origin.

    Returns (positions [N,3], n_reflections [N])."""
    room_dim = np.asarray(room_dim, np.float64)
    source = np.asarray(source, np.float64)
    per_axis = []
    for ax in range(3):
        q = np.arange(-(max_order // 2 + 1), max_order // 2 + 2)
        # family +s: x = 2qL + s, n = |2q| ; family -s: x = 2qL - s, n = |2q-1|
        pos = np.concatenate([2 * q * room_dim[ax] + source[ax],
                              2 * q * room_dim[ax] - source[ax]])
        refl = np.concatenate([np.abs(2 * q), np.abs(2 * q - 1)])
        keep = refl <= max_order
        per_axis.append((pos[keep], refl[keep]))
    px, nx = per_axis[0]
    py, ny = per_axis[1]
    pz, nz = per_axis[2]
    NX, NY, NZ = np.meshgrid(nx, ny, nz, indexing="ij")
    total = NX + NY + NZ
    mask = total <= max_order
    PX, PY, PZ = np.meshgrid(px, py, pz, indexing="ij")
    positions = np.stack([PX[mask], PY[mask], PZ[mask]], axis=-1)
    return positions, total[mask]
