"""64x64 CU coding (the depth-0 quadtree level; x265 compressInterCU
codes 64x64 skip/merge CUs at analysis.cpp:1146, and estimateResidualQT
forces the implicit TU split 64 -> 4x32 at search.cpp:3178).

Round-2 VERDICT ranked the missing 64x64 CUs as the #1 quality gap:
every flat/static region paid a 16x16-CU syntax floor. These tests pin
the new depth-0 path across all three implementations (Python oracle
writer, native C++ writer, device-precomputed residual) and decode
conformance (in-repo decoder + libde265)."""
import numpy as np

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import RC_CQP, param_default_preset
from x265_tpu.decoder import de265
from x265_tpu.decoder.decoder import HEVCDecoder


def _smooth_noise(h, w, cell, rng):
    """Bilinear-upsampled random grid (aperiodic texture — a periodic
    pattern lets ME lock onto aliased displacements and breaks the
    uniform-MV premise of these tests)."""
    g = rng.normal(0.0, 1.0, (h // cell + 2, w // cell + 2))
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    return (g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0 + 1][:, x0 + 1] * fy * fx)


def _clip(n=3, w=192, h=128, shift=2, noise=0, seed=11):
    """Textured frames under uniform global motion. `noise` scales a
    SMOOTH per-frame brightness field (a fade-like delta): ME still
    locks onto the texture with one global MV (iid per-frame noise
    would pull subpel refinement toward noise-averaging offsets), but
    the delta survives quantization as per-TU residual."""
    rng = np.random.default_rng(seed)
    tex = (_smooth_noise(h, w, 32, rng) + 0.6 * _smooth_noise(h, w, 16, rng)
           + 0.3 * _smooth_noise(h, w, 8, rng))
    base = np.clip(128 + 55 * tex / 1.4, 0, 255).astype(int)
    delta = _smooth_noise(h, w, 64, np.random.default_rng(seed + 100))
    out = []
    for i in range(n):
        y = np.roll(base, shift * i, axis=1)
        if noise:
            y = y + np.rint(noise * i * delta).astype(int)
        y = np.clip(y, 0, 255)
        out.append((y.astype(np.uint8),
                    np.clip(120 + (y[::2, ::2] >> 3), 0, 255)
                    .astype(np.uint8),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def _params(w, h, qp):
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.rc_mode, p.qp = RC_CQP, qp
    p.bframes = 0
    p.sao = False
    p.aq_mode = 0
    p.cu_tree = False
    p.scenecut = 0
    p.ref = 1
    return p


def _encode(frames, qp=30, use_native=True, split=True, force64=False):
    h, w = frames[0][0].shape
    p = _params(w, h, qp)
    enc = Encoder(p)
    enc.use_native = use_native
    enc.use_device_residual = split
    if force64:
        # force a uniform motion field and drop the promotion gates:
        # these tests pin the 64x64 *coding* paths (three-way residual
        # bit-exactness), not the analyzer's willingness to unify MVs
        # on this clip (low-QP subpel refinement legitimately prefers
        # per-block fractional MVs on the fade component)
        orig32, orig64 = enc._merge_cu32, enc._merge_cu64

        def unify(dec):
            if dec.inter8 is None or not dec.inter8.any():
                return
            sel = dec.inter8.astype(bool)
            flat = dec.mv8[sel].reshape(int(sel.sum()), -1)
            vals, counts = np.unique(flat, axis=0, return_counts=True)
            dec.mv8[:] = vals[counts.argmax()].reshape(2, 2)
            dec.inter8[:] = True
            dec.dir8[:] = 1
            if dec.ref8 is not None:
                dec.ref8[:] = 0
            dec.cu_log2_map[:] = 4

        def m32(dec, satd16=None, qp=None, rd_ctx=None):
            unify(dec)
            return orig32(dec)

        enc._merge_cu32 = m32
        enc._merge_cu64 = (
            lambda dec, satd16=None, qp=None, rd_ctx=None: orig64(dec))
    seen = []
    orig_p = enc._p_decisions

    def spy(*a, **k):
        dec = orig_p(*a, **k)
        seen.append(dec.cu_log2_map.copy())
        return dec

    enc._p_decisions = spy
    stream = enc.encode(frames)
    return stream, seen


def test_cu64_skip_static_conformance():
    """Static content: P frames should code whole CTBs as 64x64 skip."""
    frames = _clip(n=3, shift=0, noise=0)
    stream, seen = _encode(frames, qp=30)
    assert any((m == 6).any() for m in seen), "no 64x64 CU promoted"
    ours = HEVCDecoder().decode(stream)
    assert len(ours) == 3
    if de265.available():
        ext = de265.decode(stream)
        for o, e in zip(ours, ext):
            assert np.array_equal(o.y, e[0].astype(np.int32))
            assert np.array_equal(o.cb, e[1].astype(np.int32))
            assert np.array_equal(o.cr, e[2].astype(np.int32))


def test_cu64_residual_three_way_bitexact():
    """64x64 CUs WITH residual (implicit 4x32 TU split): oracle, native
    CPU, and device-precomputed paths must produce identical bytes, and the
    stream must decode identically on both decoders."""
    frames = _clip(n=3, shift=2, noise=4, seed=5)
    a, seen = _encode(frames, qp=10, use_native=True, split=False,
                      force64=True)
    assert any((m == 6).any() for m in seen), "no 64x64 CU promoted"
    b, _ = _encode(frames, qp=10, use_native=True, split=True,
                   force64=True)
    c, _ = _encode(frames, qp=10, use_native=False, split=False,
                   force64=True)
    assert a == b, "device-precomputed residual diverges from native CPU"
    assert a == c, "native diverges from the Python oracle"
    ours = HEVCDecoder().decode(a)
    # residual survives: recon must track the noisy source closely
    mse = np.mean((ours[-1].y - frames[-1][0].astype(np.int32)) ** 2)
    assert mse < 12.0, mse
    if de265.available():
        ext = de265.decode(a)
        for o, e in zip(ours, ext):
            assert np.array_equal(o.y, e[0].astype(np.int32))
            assert np.array_equal(o.cb, e[1].astype(np.int32))
            assert np.array_equal(o.cr, e[2].astype(np.int32))


def test_cu64_with_dqp_and_bframes():
    """64x64 CUs under per-CTB QP maps (cu_qp_delta inside the first
    coded TU of the tree) and B frames (merge/skip at depth 0)."""
    frames = _clip(n=5, shift=1, noise=4, seed=9)
    h, w = frames[0][0].shape
    p = _params(w, h, 26)
    p.aq_mode = 2          # dqp on
    p.bframes = 2
    enc = Encoder(p)
    orig32, orig64 = enc._merge_cu32, enc._merge_cu64
    enc._merge_cu32 = lambda dec, satd16=None, qp=None, rd_ctx=None: orig32(dec)
    enc._merge_cu64 = lambda dec, satd16=None, qp=None, rd_ctx=None: orig64(dec)
    stream = enc.encode(frames)
    ours = HEVCDecoder().decode(stream)
    assert len(ours) == 5
    if de265.available():
        ext = de265.decode(stream)
        assert len(ext) == 5
        for o, e in zip(ours, ext):
            assert np.array_equal(o.y, e[0].astype(np.int32))
            assert np.array_equal(o.cb, e[1].astype(np.int32))
            assert np.array_equal(o.cr, e[2].astype(np.int32))
