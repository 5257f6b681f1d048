"""Temporal MVP (8.5.3.2.7-8.5.3.2.9): collocated merge/AMVP candidate.

Reference analog: x265 cudata.cpp getInterMergeCandidates (temporal step)
/ fillMvpCand; collocated motion compression to 16x16.
"""
import numpy as np
import pytest

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import param_default_preset, param_parse
from x265_tpu.decoder import de265
from x265_tpu.decoder.decoder import HEVCDecoder
from x265_tpu.hevc.inter_tools import ColCtx, temporal_mv


def _pan_clip(n=6, w=96, h=64, seed=4):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.int32)
    frames = []
    for i in range(n):
        yy = np.clip(np.roll(base, i * 3, axis=1)
                     + rng.integers(-5, 5, (h, w)), 0, 255)
        frames.append((yy.astype(np.uint8),
                       np.full((h // 2, w // 2), 120, np.uint8),
                       np.full((h // 2, w // 2), 130, np.uint8)))
    return frames


def _params(bframes=0, pyramid=False, tmvp=True, w=96, h=64):
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.bframes = bframes
    p.b_pyramid = pyramid
    p.b_adapt = 0
    p.scenecut = 0
    p.aq_mode = 0
    p.cu_tree = False
    p.sao = False
    p.tmvp = tmvp
    param_parse(p, "qp", "30")
    return p


def test_temporal_mv_derivation():
    # single col block, L0 motion, scaled from td=1 to tb=2
    dir16 = np.array([[1]], np.int32)
    mv16 = np.zeros((1, 1, 2, 2), np.int32)
    mv16[0, 0, 0] = (8, -4)
    refpoc16 = np.zeros((1, 1, 2), np.int32)
    refpoc16[0, 0, 0] = 2          # col pic 3 refs poc 2 -> td = 1
    col = ColCtx(3, dir16, mv16, refpoc16)
    # current poc 4 targets poc 2 -> tb = 2 -> scale x2
    mv = temporal_mv(col, 0, 0, 16, 16, 16, 16, 64, 0, 2, 4, True, 1)
    assert mv == (16, -8)
    # same distance: unscaled
    mv = temporal_mv(col, 0, 0, 16, 16, 16, 16, 64, 0, 3, 4, True, 1)
    assert mv == (8, -4)
    # intra col block -> unavailable
    col2 = ColCtx(3, np.zeros((1, 1), np.int32), mv16, refpoc16)
    assert temporal_mv(col2, 0, 0, 16, 16, 16, 16, 64, 0, 2, 4,
                       True, 1) is None


@pytest.mark.parametrize("bframes,pyramid", [(0, False), (2, False),
                                             (3, True)])
def test_tmvp_conformance(bframes, pyramid):
    frames = _pan_clip()
    enc = Encoder(_params(bframes, pyramid))
    bs = enc.encode(frames)
    ours = HEVCDecoder().decode(bs)
    assert len(ours) == len(frames)
    if de265.available():
        ext = de265.decode(bs)
        for o, e in zip(ours, ext):
            assert np.array_equal(o.y, e[0].astype(np.int32))
            assert np.array_equal(o.cb, e[1].astype(np.int32))
            assert np.array_equal(o.cr, e[2].astype(np.int32))


def test_tmvp_native_matches_python():
    frames = _pan_clip(n=5)
    enc_n = Encoder(_params(2))
    bs_n = enc_n.encode(frames)
    enc_p = Encoder(_params(2))
    enc_p.use_native = False
    bs_p = enc_p.encode(frames)
    assert bs_n == bs_p


def test_tmvp_flag_signalled():
    frames = _pan_clip(n=3)
    enc = Encoder(_params(0))
    enc.encode(frames)
    assert enc.sps.temporal_mvp_enabled
    enc2 = Encoder(_params(0, tmvp=False))
    enc2.encode(frames)
    assert not enc2.sps.temporal_mvp_enabled
