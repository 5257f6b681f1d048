"""Device-resident frame planes — the DPB's currency.

Downloading every recon only to re-upload it padded for the next
frame's motion search / residual MC would put two full-frame transfers
across the host link on every frame's critical path.

FramePlanes keeps the canonical copy of a picture where it was produced
— device for the jitted loop-filter output, host for the Python oracle
writer — and materializes the other side lazily.  Padded device variants
(the ME search layout and the 80-pel MC reference layout,
reference picyuv.cpp extendPicBorder analog) are derived ON DEVICE and
cached per layout, so a DPB anchor is padded once and never crosses the
wire again.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np


def _jnp():
    import jax.numpy as jnp
    return jnp


@lru_cache(maxsize=32)
def _pad_fn(pt, pb, pl, pr, out_dtype):
    import jax
    import jax.numpy as jnp

    def pad(a):
        return jnp.pad(a.astype(out_dtype), ((pt, pb), (pl, pr)),
                       mode="edge")
    return jax.jit(pad)


def pad_dev(a, pads, dtype=None):
    """Edge-pad a device plane on device. pads = (top, bottom, left,
    right); dtype optionally casts (uint8 wire for 8-bit content)."""
    import jax.numpy as jnp
    dt = jnp.dtype(dtype if dtype is not None else a.dtype)
    return _pad_fn(*pads, dt.name)(a)


def is_planes(x) -> bool:
    """True for a 3-plane picture (tuple/list or FramePlanes)."""
    return (isinstance(x, (tuple, list)) and len(x) == 3) or \
        isinstance(x, FramePlanes)


class FramePlanes:
    """(y, cb, cr) with lazy host/device mirrors and derived paddings.

    Indexing/iteration yields HOST planes (compat with the plain-tuple
    anchors the encoder used before r5); `.dev()` yields the unpadded
    device int16 planes; `.dev_padded(pad)` the 80-pel MC layout;
    `.dev_luma_me(...)` the ME search layout.
    """

    __slots__ = ("_host", "_dev", "bd", "_derived")

    def __init__(self, host=None, dev=None, bd: int = 8):
        assert host is not None or dev is not None
        self._host = tuple(host) if host is not None else None
        self._dev = tuple(dev) if dev is not None else None
        self.bd = bd
        self._derived = {}

    # --- host side ---
    def host(self):
        if self._host is None:
            import jax
            self._host = tuple(np.asarray(p, np.int32)
                               for p in jax.device_get(self._dev))
        return self._host

    @property
    def host_ready(self) -> bool:
        return self._host is not None

    def __getitem__(self, i):
        return self.host()[i]

    def __len__(self):
        return 3

    def __iter__(self):
        return iter(self.host())

    def host_decimated4(self):
        """(y, cb, cr)[::4, ::4] on the host, downloaded decimated (the
        weightp moment fit reads only this grid — 1/16 of the bytes)."""
        key = "dec4"
        if key not in self._derived:
            if self._host is not None:
                self._derived[key] = tuple(np.asarray(p)[::4, ::4]
                                           for p in self._host)
            else:
                import jax

                self._derived[key] = tuple(
                    np.asarray(p)
                    for p in jax.device_get(
                        tuple(_decimate4(p) for p in self._dev)))
        return self._derived[key]

    # --- device side ---
    def dev(self):
        """(y, cb, cr) device planes, int16, unpadded."""
        if self._dev is None:
            import jax.numpy as jnp
            self._dev = tuple(jnp.asarray(np.asarray(p, np.int16))
                              for p in self._host)
        return self._dev

    def dev_padded(self, pad: int = 80):
        """MC reference layout: luma edge-padded by `pad` on every side,
        chroma by pad//2 (matches api.encoder._pad_ref)."""
        key = ("mc", pad)
        if key not in self._derived:
            y, cb, cr = self.dev()
            hp = pad // 2
            self._derived[key] = (
                pad_dev(y, (pad, pad, pad, pad), np.int16),
                pad_dev(cb, (hp, hp, hp, hp), np.int16),
                pad_dev(cr, (hp, hp, hp, hp), np.int16))
        return self._derived[key]

    def dev_luma_me(self, P: int, ph: int, pw: int):
        """ME search layout: luma padded to (ph, pw) with edge rows, then
        P more on every side, on the narrow wire dtype (uint8 for 8-bit
        content — matches engine.me.motion_fused's host upload)."""
        key = ("me", P, ph, pw)
        if key not in self._derived:
            y = self.dev()[0]
            H, W = y.shape
            wire = np.uint8 if self.bd == 8 else np.int16
            self._derived[key] = pad_dev(
                y, (P, P + (ph - H), P, P + (pw - W)), wire)
        return self._derived[key]


class MELuma:
    """Luma-only motion-search reference handle backed by a device plane
    (e.g. the weighted reference: built on device so the full-res
    weighted plane never crosses the wire)."""

    __slots__ = ("_dev", "bd", "_derived")

    def __init__(self, dev, bd: int = 8):
        self._dev = dev
        self.bd = bd
        self._derived = {}

    def dev_luma_me(self, P: int, ph: int, pw: int):
        key = ("me", P, ph, pw)
        if key not in self._derived:
            H, W = self._dev.shape
            wire = np.uint8 if self.bd == 8 else np.int16
            self._derived[key] = pad_dev(
                self._dev, (P, P + (ph - H), P, P + (pw - W)), wire)
        return self._derived[key]


@lru_cache(maxsize=1)
def _decimate4_fn():
    import jax

    def dec(p):
        return p[::4, ::4]
    return jax.jit(dec)


def _decimate4(p):
    return _decimate4_fn()(p)
