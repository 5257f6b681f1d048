"""Intra 32x32 CU promotion (quadtree depth-1 intra RDO).

x265 recurses intra CU depths 0-3 with per-depth RDO
(analysis.cpp:514 compressIntraCU, search.cpp:1509 estIntraPredQT);
round-3 VERDICT ranked the missing intra-32 level the #1 quality gap
(a pure syntax floor on flat/gradient content). These tests pin the
batched recon-in-loop promotion (models/intra_rdo.py) and decode
conformance of streams carrying 32x32 intra CUs.
"""
import numpy as np
import pytest

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import RC_CQP, param_default_preset
from x265_tpu.decoder import de265
from x265_tpu.decoder.decoder import HEVCDecoder
from x265_tpu.models.intra_frame import decide_intra_frame_device
from x265_tpu.models.intra_rdo import rd_intra_promote32


def _flat_frame(w, h, seed=5):
    """Half flat-with-steps, half noise: some groups should promote to
    32 (header savings win), textured edge regions should not."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.where(xx < w // 2, 60 + (yy // 8),
                 rng.integers(0, 256, (h, w))).astype(np.int32)
    cb = (120 + (xx[::2, ::2] // 16)).astype(np.int32)
    cr = np.full((h // 2, w // 2), 130, np.int32)
    return y, cb, cr


def test_promotion_mutates_maps():
    W, H = 128, 96
    p = param_default_preset("medium")
    p.width, p.height = W, H
    y, cb, cr = _flat_frame(W, H)
    dec = decide_intra_frame_device(y, W, H, cu_log2=4)
    n = rd_intra_promote32((y, cb, cr), dec, 30, p)
    assert n > 0
    # promoted cells: full 4x4 8-blocks at log2 5 with a uniform mode
    ys, xs = np.nonzero(dec.cu_log2_map == 5)
    assert len(ys) == 0 or len(ys) % 16 == 0
    for gy in set(ys // 4):
        for gx in set(xs // 4):
            cells = dec.cu_log2_map[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4]
            if (cells == 5).any():
                assert (cells == 5).all()
                m = dec.luma_mode8[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4]
                assert (m == m[0, 0]).all()


def test_lossless_skips_promotion():
    W, H = 64, 64
    p = param_default_preset("medium")
    p.width, p.height = W, H
    p.lossless = True
    y, cb, cr = _flat_frame(W, H)
    dec = decide_intra_frame_device(y, W, H, cu_log2=4)
    assert rd_intra_promote32((y, cb, cr), dec, 30, p) == 0


def _encode_one(frame, w, h, qp=30):
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.rc_mode, p.qp = RC_CQP, qp
    p.keyint = 1
    p.bframes = 0
    enc = Encoder(p)
    stream = bytearray(enc.headers())
    stream += enc.encode_frame(*frame)
    stream += enc.flush()
    n32 = int((enc._last_analysis.cu_log2_map == 5).sum())
    enc.close()
    return bytes(stream), n32


def test_conformance_own_decoder():
    W, H = 128, 96
    frame = _flat_frame(W, H)
    stream, n32 = _encode_one(frame, W, H)
    assert n32 >= 16          # at least one 32 CU actually in the stream
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 1
    # lossy: recon must be sane, not equal — check PSNR floor
    err = (pics[0].y.astype(np.float64) - frame[0]) ** 2
    psnr = 10 * np.log10(255.0 ** 2 / max(err.mean(), 1e-9))
    assert psnr > 25.0


@pytest.mark.skipif(not de265.available(), reason="libde265 not present")
def test_conformance_libde265():
    W, H = 128, 96
    frame = _flat_frame(W, H)
    stream, n32 = _encode_one(frame, W, H)
    assert n32 >= 16
    ours = HEVCDecoder().decode(stream)
    theirs = de265.decode(stream)
    assert np.array_equal(np.asarray(theirs[0][0], np.int32), ours[0].y)
    assert np.array_equal(np.asarray(theirs[0][1], np.int32), ours[0].cb)
    assert np.array_equal(np.asarray(theirs[0][2], np.int32), ours[0].cr)


def test_intra32_in_p_frame():
    """Intra regions of a P frame promote too (scene-change half)."""
    W, H = 128, 96
    rng = np.random.default_rng(9)
    f0y = rng.integers(0, 256, (H, W)).astype(np.int32)
    cb = np.full((H // 2, W // 2), 120, np.int32)
    cr = np.full((H // 2, W // 2), 130, np.int32)
    # frame 1: left half = frame 0 (inter wins), right half = new flat
    # content (intra wins, flat => 32 promotion)
    f1y = f0y.copy()
    f1y[:, W // 2:] = 70
    p = param_default_preset("medium")
    p.width, p.height = W, H
    p.rc_mode, p.qp = RC_CQP, 30
    p.bframes = 0
    p.keyint = 250
    p.scenecut = 0        # keep frame 1 a P frame
    enc = Encoder(p)
    stream = bytearray(enc.headers())
    stream += enc.encode_frame(f0y, cb, cr)
    stream += enc.encode_frame(f1y, cb, cr)
    stream += enc.flush()
    dec_map = enc._last_analysis.cu_log2_map
    intra32 = ((dec_map == 5) & ~enc._last_analysis.inter8.astype(bool))
    enc.close()
    assert intra32.any()
    pics = HEVCDecoder().decode(bytes(stream))
    assert len(pics) == 2
