"""The finalizer split must not change a single bit: encoding with the
device inter-residual pipeline (native consumes precomputed levels/cbf/recon
and emits bins only) must produce byte-identical streams to the all-CPU
native path (reference analog: compressCTU/encodeCTU produce the same
stream regardless of which thread ran the pixel math)."""
import numpy as np
import pytest

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import RC_CQP, param_default_preset, param_parse


def _clip(n=6, seed=7, w=176, h=144):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(int)
    out = []
    for i in range(n):
        y = np.clip(np.roll(base, 3 * i, 1) + np.roll(base // 3, i, 0)
                    + rng.integers(-4, 5, (h, w)), 0, 255)
        out.append((y.astype(np.uint8),
                    np.clip(120 + (y[::2, ::2] >> 3), 0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def _encode(frames, split, **kw):
    p = param_default_preset("medium")
    p.width, p.height = frames[0][0].shape[1], frames[0][0].shape[0]
    p.rc_mode, p.qp = RC_CQP, 30
    for k, v in kw.items():
        if k == "parse":
            for nm, val in v:
                param_parse(p, nm, val)
        else:
            setattr(p, k, v)
    enc = Encoder(p)
    enc.use_device_residual = split
    return enc.encode(frames)


@pytest.mark.parametrize("cfg", [
    dict(),                                      # medium: B frames, SAO, AQ
    dict(bframes=0, sao=False, aq_mode=0, cu_tree=False),   # plain IPPP
    dict(rdoq_level=2, ref=2),                   # RDOQ + multiref
    dict(sign_hide=False, deblock=False),
])
def test_split_streams_identical(cfg):
    frames = _clip()
    a = _encode(frames, split=False, **cfg)
    b = _encode(frames, split=True, **cfg)
    assert a == b, (len(a), len(b), cfg)


def test_split_streams_identical_main10():
    frames = [(y.astype(np.uint16) * 4, cb.astype(np.uint16) * 4,
               cr.astype(np.uint16) * 4) for (y, cb, cr) in _clip(4)]
    a = _encode(frames, split=False, bit_depth=10, bframes=2)
    b = _encode(frames, split=True, bit_depth=10, bframes=2)
    assert a == b
