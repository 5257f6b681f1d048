"""Weighted prediction (P slices): pred_weight_table + 8.5.4.2.3.2.

Reference analog: x265 weightPrediction.cpp (weightAnalyse) and the
WeightParam application in predict.cpp.
"""
import numpy as np

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import param_default_preset, param_parse
from x265_tpu.decoder import de265
from x265_tpu.decoder.decoder import HEVCDecoder


def _fade_clip(w=96, h=64, n=4, seed=3):
    rng = np.random.default_rng(seed)
    base = (rng.integers(0, 200, (h, w)) * 0.3 +
            np.mgrid[0:h, 0:w][1] * 0.9).astype(np.float64)
    cbb = rng.integers(80, 170, (h // 2, w // 2)).astype(np.float64)
    crb = rng.integers(80, 170, (h // 2, w // 2)).astype(np.float64)
    frames = []
    for i in range(n):
        g = 1.0 - 0.16 * i
        y = np.clip(base * g, 0, 255).astype(np.uint8)
        cb = np.clip((cbb - 128) * g + 128, 0, 255).astype(np.uint8)
        cr = np.clip((crb - 128) * g + 128, 0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def _params(w=96, h=64, **kw):
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.bframes = 0
    p.scenecut = 0
    p.aq_mode = 0
    p.cu_tree = False
    p.sao = False
    param_parse(p, "qp", "30")
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def test_weight_analysis_detects_fade():
    from x265_tpu.engine.weightp import analyze_slice_weights
    f = _fade_clip(n=2)
    wl, _ = analyze_slice_weights(f[1], f[0], 8)
    assert wl is not None
    w, off = wl
    assert w < (1 << 6)          # fade to black => scale < 1.0
    # static content => no weights
    wl2, wc2 = analyze_slice_weights(f[0], f[0], 8)
    assert wl2 is None and wc2 is None


def test_weightp_saves_bits_and_conforms():
    frames = _fade_clip()
    enc = Encoder(_params(weightp=True))
    bs = enc.encode(frames)
    bs_u = Encoder(_params(weightp=False)).encode(frames)
    assert len(bs) < len(bs_u)           # fade: weights must win
    ours = HEVCDecoder().decode(bs)
    assert len(ours) == len(frames)
    last = enc._last_recon
    assert np.array_equal(ours[-1].y, np.asarray(last[0]).astype(np.int32))
    assert np.array_equal(ours[-1].cb, np.asarray(last[1]).astype(np.int32))
    assert np.array_equal(ours[-1].cr, np.asarray(last[2]).astype(np.int32))
    if de265.available():
        ext = de265.decode(bs)
        for o, e in zip(ours, ext):
            assert np.array_equal(o.y, e[0].astype(np.int32))
            assert np.array_equal(o.cb, e[1].astype(np.int32))
            assert np.array_equal(o.cr, e[2].astype(np.int32))


def test_weightp_native_matches_python():
    frames = _fade_clip(n=3)
    enc_n = Encoder(_params(weightp=True))
    bs_n = enc_n.encode(frames)
    enc_p = Encoder(_params(weightp=True))
    enc_p.use_native = False
    bs_p = enc_p.encode(frames)
    assert bs_n == bs_p


def test_pred_weight_table_roundtrip():
    from x265_tpu.hevc.headers import (
        PPS, SPS, ShortTermRPS, SliceHeader, SLICE_P,
        parse_slice_header, write_slice_header)
    sps = SPS(width=96, height=64, short_term_rps=[])
    pps = PPS(weighted_pred=True)
    sh = SliceHeader(
        first_slice_in_pic=True, slice_type=SLICE_P, qp=30,
        pic_order_cnt_lsb=1, rps_in_sps=False,
        short_term_rps=ShortTermRPS(num_negative=2, delta_poc_s0=[-1, -2],
                                    used_s0=[True, True]),
        num_ref_idx_l0_active=2, max_num_merge_cand=5,
        luma_log2_weight_denom=6,
        chroma_log2_weight_denom=5,
        luma_weights_l0=[(34, -5), None],
        chroma_weights_l0=[((32, 7), (30, -2)), None])
    bw = write_slice_header(sh, sps, pps, 1)
    sh2, _ = parse_slice_header(bw.data(), 1, sps, pps)
    assert sh2.luma_log2_weight_denom == 6
    assert sh2.chroma_log2_weight_denom == 5
    assert sh2.luma_weights_l0 == [(34, -5), None]
    assert sh2.chroma_weights_l0 == [((32, 7), (30, -2)), None]
