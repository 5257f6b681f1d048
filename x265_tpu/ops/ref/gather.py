"""numpy references for the batched window gathers of the device path:
the source and phase-plane block fetches (models/inter_residual.py
``gather_src_blocks``, engine/me.py ``_gather_phase_blocks``) and the
per-lane MC gather + interpolation (``inter_residual._mc_gather``).
"""
from __future__ import annotations

import numpy as np

from .interp import mc_chroma_14, mc_luma_14


def ds_start(v, dim: int, size: int) -> np.ndarray:
    """lax.dynamic_slice start semantics: a negative start counts from
    the end once, then the window is clamped inside the array."""
    v = np.where(np.asarray(v) < 0, np.asarray(v) + dim, v)
    return np.clip(v, 0, dim - size)


def src_blocks(src: np.ndarray, yy, xx, S: int) -> np.ndarray:
    """[N, S, S] windows of a [H, W] plane at (yy, xx)."""
    H, W = src.shape
    oy, ox = ds_start(yy, H, S), ds_start(xx, W, S)
    return np.stack([src[a:a + S, b:b + S] for a, b in zip(oy, ox)])


def phase_blocks(planes: np.ndarray, fy, fx, iy, ix, S: int) -> np.ndarray:
    """[N, S, S] windows of phase plane (fy, fx) of [4, 4, Hm, Wm] planes
    at (iy, ix)."""
    P, Q, Hm, Wm = planes.shape
    a, b = ds_start(fy, P, 1), ds_start(fx, Q, 1)
    c, d = ds_start(iy, Hm, S), ds_start(ix, Wm, S)
    return np.stack([planes[a[i], b[i], c[i]:c[i] + S, d[i]:d[i] + S]
                     for i in range(len(a))])


def mc_lanes(planes: np.ndarray, ridx, x0, y0, mvx, mvy, n: int, taps: int,
             pad: int, bd: int) -> np.ndarray:
    """[N, n, n] 14-bit MC predictions, lane i from reference plane
    ridx[i] at block origin (x0[i], y0[i]) and MV (mvx[i], mvy[i])."""
    fn = mc_luma_14 if taps == 8 else mc_chroma_14
    return np.stack([fn(planes[int(ridx[i])], pad, int(x0[i]), int(y0[i]),
                        n, n, (int(mvx[i]), int(mvy[i])), bd)
                     for i in range(len(x0))])
