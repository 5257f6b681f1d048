"""Differential tests: the native C++ slice finalizer must be bin-exact
with the Python reference writer for P and B slices (the x265 TestBench
pattern, SURVEY.md §4, applied to the entropy stage)."""
import numpy as np

from x265_tpu import native
from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import RC_CQP, param_default_preset
from x265_tpu.engine.ctu_writer import FrameSyntaxWriter
from x265_tpu.hevc.headers import (
    SLICE_B, SLICE_P, ShortTermRPS, SliceHeader,
)


def _setup(w=96, h=64, qp=30):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 70 * np.sin(xx / 11.0) * np.cos(yy / 13.0)).astype(int)
    frames = []
    for i in range(4):
        y = np.clip(np.roll(base, i * 2, 1) + rng.integers(-6, 6, (h, w)),
                    0, 255)
        frames.append((y.astype(np.uint8),
                       np.clip(120 + 20 * np.sin(xx[::2, ::2] / 9.0) + i,
                               0, 255).astype(np.uint8),
                       np.clip(130 + 20 * np.cos(yy[::2, ::2] / 7.0),
                               0, 255).astype(np.uint8)))
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.qp, p.rc_mode, p.bframes = qp, RC_CQP, 2
    p.rc_lookahead = 0        # close mini-GOPs at bframes+1 (x265-style
    #                           latency is rc_lookahead frames otherwise)
    enc = Encoder(p)
    enc.encode_frame(*frames[0])
    return enc, frames


def _pad_refs(refs, pad=80):
    return tuple(
        [tuple(np.pad(np.asarray(pl).astype(np.int16),
                      pad >> (0 if i == 0 else 1), mode="edge")
               for i, pl in enumerate(planes)) for planes in lst]
        for lst in refs)


def test_native_p_slice_bin_exact():
    enc, frames = _setup()
    anchor = enc.anchor
    f = frames[3]
    dec = enc._p_decisions(f[0], anchor[1][0])
    sh = SliceHeader(first_slice_in_pic=True, slice_type=SLICE_P,
                     qp=enc._slice_qp(SLICE_P), pic_order_cnt_lsb=3,
                     rps_in_sps=False,
                     short_term_rps=ShortTermRPS(
                         num_negative=1, delta_poc_s0=[-3], used_s0=[True]),
                     max_num_merge_cand=5)
    wr = FrameSyntaxWriter(enc.sps, enc.pps, sh, False,
                           refs=([anchor[1]], []), ref_poc=((0,), ()),
                           cur_poc=3)
    py = wr.encode_slice_data(*[np.asarray(x) for x in f], dec)
    nat, recon, cbf4, _qp4 = native.encode_slice_px(
        f[0], f[1], f[2], dec.cu_log2_map, dec.luma_mode8, dec.chroma_mode8,
        dec.inter8, dec.dir8, dec.mv8, 1, 5,
        _pad_refs(([anchor[1]], [])), ((0,), ()), 3, 80,
        6, 3, enc._slice_qp(SLICE_P), False, True, True, 0, 0)
    assert nat == py
    assert np.array_equal(recon[0], wr.y)
    assert np.array_equal(recon[1], wr.cb)
    assert np.array_equal(recon[2], wr.cr)
    # cbf map equal wherever it matters for deblock (inter blocks)
    inter4 = np.repeat(np.repeat(dec.inter8, 2, 0), 2, 1)[:cbf4.shape[0],
                                                          :cbf4.shape[1]]
    assert np.array_equal(cbf4[inter4.astype(bool)],
                          wr.dbs.cbf4[inter4.astype(bool)])


def test_native_b_slice_bin_exact():
    enc, frames = _setup()
    a0 = enc.anchor
    # build the next anchor through the normal path
    out = enc.encode_frame(*frames[1])
    out += enc.encode_frame(*frames[2])
    out += enc.encode_frame(*frames[3])   # closes mini-GOP (bframes=2)
    a1 = enc.anchor
    assert a1[0] == 3
    f = frames[1]
    dec = enc._b_decisions(f[0], a0[1][0], a1[1][0])
    sh = SliceHeader(first_slice_in_pic=True, slice_type=SLICE_B,
                     qp=enc._slice_qp(SLICE_B), pic_order_cnt_lsb=1,
                     rps_in_sps=False,
                     short_term_rps=ShortTermRPS(
                         num_negative=1, delta_poc_s0=[-1], used_s0=[True],
                         num_positive=1, delta_poc_s1=[2], used_s1=[True]),
                     max_num_merge_cand=5)
    wr = FrameSyntaxWriter(enc.sps, enc.pps, sh, False,
                           refs=([a0[1]], [a1[1]]), ref_poc=((0,), (3,)),
                           cur_poc=1)
    py = wr.encode_slice_data(*[np.asarray(x) for x in f], dec)
    nat, recon, _, _qp4 = native.encode_slice_px(
        f[0], f[1], f[2], dec.cu_log2_map, dec.luma_mode8, dec.chroma_mode8,
        dec.inter8, dec.dir8, dec.mv8, 0, 5,
        _pad_refs(([a0[1]], [a1[1]])), ((0,), (3,)), 1, 80,
        6, 3, enc._slice_qp(SLICE_B), False, True, True, 0, 0)
    assert nat == py
    assert np.array_equal(recon[0], wr.y)
