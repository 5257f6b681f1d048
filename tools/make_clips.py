"""Deterministic test-clip generator for the quality/BD-rate harness.

The image has no real video assets (zero egress), so the harness uses
procedurally generated *video-like* content: multi-octave value-noise
textures (natural-image-ish 1/f spectrum), global subpixel pans, zooms,
independently moving textured objects, a scene cut and a fade — the moving
parts that exercise ME/MC, mode decision, scenecut and weighted
prediction. Both encoders (x265 binary and x265_tpu) see identical input,
so BD-rate deltas between them are meaningful even though the content is
synthetic (BASELINE.md caveat is recorded in STATUS.md).

All clips are seeded and bit-reproducible: the reference operating points
(bench_refpoints.json) stay valid across rounds as long as this file does
not change.
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from x265_tpu.io.y4m import VideoInfo, write_y4m  # noqa: E402


def _upsample_bilinear(a: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear resize [h,w] -> [H,W] (edge-clamped)."""
    h, w = a.shape
    ys = np.linspace(0, h - 1, H)
    xs = np.linspace(0, w - 1, W)
    y0 = np.clip(ys.astype(int), 0, h - 2)
    x0 = np.clip(xs.astype(int), 0, w - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a00 = a[y0][:, x0]
    a01 = a[y0][:, x0 + 1]
    a10 = a[y0 + 1][:, x0]
    a11 = a[y0 + 1][:, x0 + 1]
    return (a00 * (1 - fy) * (1 - fx) + a01 * (1 - fy) * fx
            + a10 * fy * (1 - fx) + a11 * fy * fx)


def value_noise(rng, H: int, W: int, octaves=(8, 16, 32, 64, 128),
                gains=(1.0, 0.6, 0.35, 0.2, 0.12)) -> np.ndarray:
    """Multi-octave value noise in [0,1] with a natural-ish spectrum."""
    out = np.zeros((H, W))
    for cells, g in zip(octaves, gains):
        grid = rng.standard_normal((cells, int(cells * W / H) + 2))
        out += g * _upsample_bilinear(grid, H, W)
    out -= out.min()
    out /= max(1e-9, out.max())
    return out


def _sample(master: np.ndarray, oy: float, ox: float,
            H: int, W: int) -> np.ndarray:
    """Bilinear subpixel crop [H,W] at float offset (oy, ox)."""
    y0 = int(np.floor(oy))
    x0 = int(np.floor(ox))
    fy = oy - y0
    fx = ox - x0
    win = master[y0:y0 + H + 1, x0:x0 + W + 1]
    return (win[:H, :W] * (1 - fy) * (1 - fx)
            + win[:H, 1:W + 1] * (1 - fy) * fx
            + win[1:H + 1, :W] * fy * (1 - fx)
            + win[1:H + 1, 1:W + 1] * fy * fx)


def _to420(yf: np.ndarray, cbf: np.ndarray, crf: np.ndarray):
    y = np.clip(yf, 0, 255).astype(np.uint8)
    cb = np.clip(cbf, 0, 255)
    cr = np.clip(crf, 0, 255)
    cb = cb.reshape(cb.shape[0] // 2, 2, cb.shape[1] // 2, 2).mean((1, 3))
    cr = cr.reshape(cr.shape[0] // 2, 2, cr.shape[1] // 2, 2).mean((1, 3))
    return y, cb.astype(np.uint8), cr.astype(np.uint8)


def clip_pan(W=1280, H=720, n=50, speed=(1.3, 2.7), seed=10):
    """Textured landscape, constant subpixel pan + two moving objects."""
    rng = np.random.default_rng(seed)
    MH, MW = H + 200, W + 200
    master_y = value_noise(rng, MH, MW) * 200 + 28
    master_cb = value_noise(rng, MH, MW, (8, 24), (1.0, 0.4)) * 90 + 83
    master_cr = value_noise(rng, MH, MW, (6, 20), (1.0, 0.4)) * 90 + 83
    obj = value_noise(rng, 96, 128) * 160 + 60
    obj2 = value_noise(rng, 64, 64) * 160 + 48
    grain = rng.standard_normal((4, H, W)) * 1.2
    for i in range(n):
        oy = 10 + speed[0] * i
        ox = 10 + speed[1] * i
        yf = _sample(master_y, oy, ox, H, W).copy()
        cbf = _sample(master_cb, oy, ox, H, W)
        crf = _sample(master_cr, oy, ox, H, W)
        # objects move against the pan
        o1y, o1x = int(180 + 0.8 * i), int(200 + 6.0 * i) % (W - 128)
        yf[o1y:o1y + 96, o1x:o1x + 128] = obj
        o2y, o2x = int(420 + 2.5 * i) % (H - 64), int(900 - 4.0 * i) % (W - 64)
        yf[o2y:o2y + 64, o2x:o2x + 64] = obj2
        yf += grain[i % 4]
        yield _to420(yf, cbf, crf)


def clip_zoom(W=1280, H=720, n=50, seed=20):
    """Slow zoom-in + rotation-ish shear: radial motion field."""
    rng = np.random.default_rng(seed)
    MH, MW = H + 400, W + 400
    master_y = value_noise(rng, MH, MW) * 205 + 25
    master_cb = value_noise(rng, MH, MW, (10, 30), (1.0, 0.5)) * 80 + 88
    master_cr = value_noise(rng, MH, MW, (12, 28), (1.0, 0.5)) * 80 + 88
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n):
        s = 1.0 + 0.004 * i           # zoom factor
        th = 0.0008 * i               # slight rotation
        cy, cx = MH / 2, MW / 2
        sy = cy + ((yy - H / 2) * np.cos(th) - (xx - W / 2) * np.sin(th)) / s
        sx = cx + ((yy - H / 2) * np.sin(th) + (xx - W / 2) * np.cos(th)) / s
        y0 = np.clip(sy.astype(int), 0, MH - 2)
        x0 = np.clip(sx.astype(int), 0, MW - 2)
        fy = sy - y0
        fx = sx - x0

        def samp(m):
            return (m[y0, x0] * (1 - fy) * (1 - fx)
                    + m[y0, x0 + 1] * (1 - fy) * fx
                    + m[y0 + 1, x0] * fy * (1 - fx)
                    + m[y0 + 1, x0 + 1] * fy * fx)

        yield _to420(samp(master_y), samp(master_cb), samp(master_cr))


def clip_cutfade(W=1280, H=720, n=50, seed=30):
    """Scene A pans, hard cut at n//2 to scene B, fade-out last 12."""
    rng = np.random.default_rng(seed)
    MH, MW = H + 120, W + 120
    a_y = value_noise(rng, MH, MW) * 190 + 35
    a_cb = value_noise(rng, MH, MW, (8, 16), (1.0, 0.5)) * 70 + 93
    a_cr = value_noise(rng, MH, MW, (8, 16), (1.0, 0.5)) * 70 + 93
    b_y = value_noise(rng, MH, MW, (6, 12, 48, 96), (1.0, 0.7, 0.3, 0.15)) \
        * 210 + 20
    b_cb = value_noise(rng, MH, MW, (10, 20), (1.0, 0.5)) * 85 + 85
    b_cr = value_noise(rng, MH, MW, (14, 24), (1.0, 0.5)) * 85 + 85
    cut = n // 2
    for i in range(n):
        if i < cut:
            oy, ox = 5 + 0.9 * i, 5 + 1.8 * i
            yf = _sample(a_y, oy, ox, H, W)
            cbf = _sample(a_cb, oy, ox, H, W)
            crf = _sample(a_cr, oy, ox, H, W)
        else:
            j = i - cut
            oy, ox = 5 + 1.4 * j, 100 - 1.1 * j
            yf = _sample(b_y, oy, ox, H, W)
            cbf = _sample(b_cb, oy, ox, H, W)
            crf = _sample(b_cr, oy, ox, H, W)
            left = n - 1 - i
            if left < 12:                 # fade to black (weightp food)
                g = (left + 1) / 13.0
                yf = yf * g + 16 * (1 - g)
                cbf = (cbf - 128) * g + 128
                crf = (crf - 128) * g + 128
        yield _to420(yf, cbf, crf)


def clip_crowd1080(W=1920, H=1080, n=32, seed=40):
    """High-detail texture with mild pan — the 1080p fps clip."""
    rng = np.random.default_rng(seed)
    MH, MW = H + 100, W + 100
    master_y = value_noise(rng, MH, MW,
                           (12, 24, 48, 96, 192),
                           (1.0, 0.6, 0.4, 0.25, 0.15)) * 210 + 22
    master_cb = value_noise(rng, MH, MW, (10, 40), (1.0, 0.5)) * 85 + 85
    master_cr = value_noise(rng, MH, MW, (16, 36), (1.0, 0.5)) * 85 + 85
    for i in range(n):
        oy, ox = 8 + 0.7 * i, 8 + 1.9 * i
        yf = _sample(master_y, oy, ox, H, W)
        cbf = _sample(master_cb, oy, ox, H, W)
        crf = _sample(master_cr, oy, ox, H, W)
        yield _to420(yf, cbf, crf)


CLIPS = {
    "pan720": (clip_pan, 1280, 720, 50),
    "zoom720": (clip_zoom, 1280, 720, 50),
    "cutfade720": (clip_cutfade, 1280, 720, 50),
    "crowd1080": (clip_crowd1080, 1920, 1080, 32),
}


def write_clip(name: str, path: str) -> str:
    gen, W, H, n = CLIPS[name]
    write_y4m(path, gen(), VideoInfo(W, H, 25, 1))
    return path


def _cache_key() -> str:
    """Content hash of this file: editing the generator invalidates the
    cache; re-checkouts with identical content keep it (an mtime key
    missed both ways — same-second edits and fresh clones)."""
    import hashlib
    with open(os.path.abspath(__file__), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:12]


_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".clip_cache")


def frames_of(name: str):
    """Frames of a named clip, disk-cached inside the checkout:
    generation is deterministic but costs ~30-90 s of pure numpy for the
    1080p clip."""
    gen, W, H, n = CLIPS[name]
    os.makedirs(_CACHE_DIR, exist_ok=True)
    path = os.path.join(_CACHE_DIR, f"{name}_{_cache_key()}.npz")
    import glob
    for stale in glob.glob(os.path.join(_CACHE_DIR, f"{name}_*.npz")):
        if stale != path:
            try:
                os.unlink(stale)
            except OSError:
                pass
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return [(z[f"y{i}"].astype(np.int32),
                         z[f"cb{i}"].astype(np.int32),
                         z[f"cr{i}"].astype(np.int32))
                        for i in range(int(z["n"]))]
        except Exception:
            pass
    frames = [(y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32))
              for (y, cb, cr) in gen()]
    try:
        arrs = {"n": np.int64(len(frames))}
        for i, (y, cb, cr) in enumerate(frames):
            # int16 covers 8/10-bit sample ranges at half the npz size
            arrs[f"y{i}"] = y.astype(np.int16)
            arrs[f"cb{i}"] = cb.astype(np.int16)
            arrs[f"cr{i}"] = cr.astype(np.int16)
        tmp = path + ".tmp"
        np.savez(tmp, **arrs)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                   path)
    except Exception:
        pass
    return frames


if __name__ == "__main__":
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/clips"
    os.makedirs(outdir, exist_ok=True)
    for name in CLIPS:
        p = os.path.join(outdir, name + ".y4m")
        write_clip(name, p)
        print(p)
