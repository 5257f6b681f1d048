"""Device loop filter (models/loopfilter.py) must be bit-exact vs the
numpy reference (hevc/deblock.py) — the TestBench correctness pattern
(SURVEY §4.1) for the deblock kernel family, plus stream-level equality
of the integrated encoder path."""
import numpy as np
import pytest

from x265_tpu.hevc.deblock import NOPOC, DeblockState, deblock_frame
from x265_tpu.models.loopfilter import deblock_frame_device


def _random_state(rng, h, w, with_motion):
    h4, w4 = h // 4, w // 4
    st = DeblockState(h, w)
    # random CU grid edges on the 8-px grid
    cl4 = rng.choice([3, 4, 5], size=(h4, w4))
    xs = (np.arange(w4) * 4)[None, :]
    ys = (np.arange(h4) * 4)[:, None]
    st.edge_v = (xs % (1 << cl4)) == 0
    st.edge_h = (ys % (1 << cl4)) == 0
    st.cbf4 = rng.random((h4, w4)) < 0.4
    is_intra4 = rng.random((h4, w4)) < (0.3 if with_motion else 1.0)
    if with_motion:
        mv4 = rng.integers(-32, 32, (h4, w4, 2, 2)).astype(np.int32)
        refpoc4 = rng.choice([0, 4, NOPOC], size=(h4, w4, 2))
        refpoc4[..., 0] = np.where(is_intra4, NOPOC, refpoc4[..., 0])
    else:
        mv4 = np.zeros((h4, w4, 2, 2), np.int32)
        refpoc4 = np.full((h4, w4, 2), NOPOC, np.int64)
    return st, is_intra4, mv4, refpoc4.astype(np.int64)


@pytest.mark.parametrize("with_motion,qp_map", [(False, False),
                                                (True, False),
                                                (True, True)])
def test_device_deblock_bit_exact(with_motion, qp_map):
    rng = np.random.default_rng(3 + with_motion + 2 * qp_map)
    h, w = 96, 128
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    cr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    st, is_intra4, mv4, refpoc4 = _random_state(rng, h, w, with_motion)
    qp = (rng.integers(18, 40, (h // 4, w // 4)).astype(np.int32)
          if qp_map else 30)
    ref = deblock_frame(y.copy(), cb.copy(), cr.copy(), st, is_intra4,
                        mv4, refpoc4, qp, 0, 0, 1, -1, 8)
    dev = deblock_frame_device((y, cb, cr), st, is_intra4, mv4, refpoc4,
                               qp, 0, 0, 1, -1, 8)
    for r, d, name in zip(ref, dev, "y cb cr".split()):
        assert np.array_equal(np.asarray(r, np.int32),
                              np.asarray(d, np.int32)), name


def test_device_deblock_fused_sao_stats_match():
    """The fused deblock+stats dispatch must return the same stats the
    standalone SAO analysis computes on the deblocked recon."""
    from x265_tpu.hevc.sao import _eo_stats, _bo_stats
    rng = np.random.default_rng(9)
    h, w = 64, 128
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    cr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    src = (np.clip(y + rng.integers(-3, 4, y.shape), 0, 255),
           np.clip(cb + rng.integers(-3, 4, cb.shape), 0, 255),
           np.clip(cr + rng.integers(-3, 4, cr.shape), 0, 255))
    st, is_intra4, mv4, refpoc4 = _random_state(rng, h, w, True)
    out = deblock_frame_device((y, cb, cr), st, is_intra4, mv4, refpoc4,
                               30, 0, 0, 0, 0, 8, sao_src=src,
                               ctb_log2=6)
    recon, stats = out[:3], out[3]
    ctb = 64
    cy, cx = -(-h // ctb), -(-w // ctb)
    ecnt, esum = _eo_stats(src[0].astype(np.int64),
                           np.asarray(recon[0], np.int64), cy, cx, ctb)
    assert np.array_equal(np.asarray(stats[0][0], np.int64), ecnt)
    assert np.array_equal(np.asarray(stats[0][1], np.int64), esum)
    bcnt, bsum = _bo_stats(src[1].astype(np.int64),
                           np.asarray(recon[1], np.int64), cy, cx,
                           ctb >> 1, 8)
    assert np.array_equal(np.asarray(stats[1][2], np.int64), bcnt)
    assert np.array_equal(np.asarray(stats[1][3], np.int64), bsum)


def test_encoder_streams_identical_device_vs_cpu_loopfilter():
    """Full-encoder differential: device vs numpy loop filter must yield
    byte-identical streams (recon feeds ME/SAO downstream)."""
    from x265_tpu.api.encoder import Encoder
    from x265_tpu.api.params import RC_CQP, param_default_preset
    rng = np.random.default_rng(21)
    h, w = 96, 112
    base = rng.integers(0, 255, (h, w)).astype(np.int32)
    frames = [(np.clip(np.roll(base, 2 * i, 1)
                       + rng.integers(-3, 4, (h, w)), 0, 255)
               .astype(np.uint8),
               np.full((h // 2, w // 2), 120, np.uint8),
               np.full((h // 2, w // 2), 130, np.uint8))
              for i in range(4)]
    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.rc_mode, p.qp = RC_CQP, 30
    p.bframes = 2

    def enc(dev):
        e = Encoder(p.copy() if hasattr(p, "copy") else p)
        e.use_device_loopfilter = dev
        return e.encode(frames)

    a = enc(True)
    b = enc(False)
    assert a == b
