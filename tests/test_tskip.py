"""Transform skip (--tskip; 7.3.8.11 transform_skip_flag, quant.cpp
transformNxN tskip branch). 4x4 TBs — chroma of 8x8 CUs in production,
plus intra NxN luma in the oracle — pick DCT-vs-skip by the shared
integer RD cost; streams decode bit-exactly in libde265 and the in-repo
decoder, and native matches the oracle byte-for-byte.
"""
import numpy as np
import pytest

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import param_default_preset, param_parse


def _frames(n, seed=3, h=64, w=96):
    """Screen-content-like frames (sharp edges, flat runs) where
    transform skip actually wins TBs."""
    rng = np.random.default_rng(seed)
    out = []
    base = np.zeros((h, w), np.uint8)
    base[::8, :] = 250                      # sharp horizontal lines
    base[:, ::16] = 10
    base[20:30, 30:60] = 128
    for i in range(n):
        y = np.roll(base, i * 3, axis=1).copy()
        y[40:50, 10:40] = rng.integers(0, 255, (10, 30))
        out.append((y, np.roll(base, i)[::2, ::2].copy(),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def _params(**kw):
    p = param_default_preset("medium")
    p.width, p.height = 96, 64
    p.bframes = kw.pop("bframes", 1)
    p.b_adapt = 0
    p.scenecut = 0
    p.aq_mode = 0
    p.cu_tree = False
    p.sao = kw.pop("sao", False)
    param_parse(p, "qp", str(kw.pop("qp", 30)))
    param_parse(p, "tskip")
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.mark.slow
def test_tskip_conformance_libde265():
    from x265_tpu.decoder import de265
    from x265_tpu.decoder.decoder import HEVCDecoder

    frames = _frames(4)
    p = _params(rdoq_level=2)
    bs = Encoder(p).encode(frames)
    p2 = _params(rdoq_level=2)
    p2.tskip = False
    bs_off = Encoder(p2).encode(frames)
    assert bs != bs_off                     # the tool changes the stream

    ours = HEVCDecoder().decode(bs)
    ref = de265.decode(bs)
    assert len(ours) == len(ref) == 4
    for i, (a, b) in enumerate(zip(ours, ref)):
        bb = b if isinstance(b, tuple) else (b.y, b.cb, b.cr)
        for pa, pb in zip((a.y, a.cb, a.cr), bb):
            assert np.array_equal(np.asarray(pa), np.asarray(pb)), i


@pytest.mark.slow
def test_tskip_native_matches_oracle():
    frames = _frames(3)
    streams = []
    for use_native in (True, False):
        enc = Encoder(_params(rdoq_level=2))
        enc.use_native = use_native
        enc.use_device_residual = False
        streams.append(enc.encode(frames))
    assert streams[0] == streams[1]


@pytest.mark.slow
def test_tskip_with_sao_conformance():
    """--tskip + SAO exercises the double-finalize fallback (the collect/
    replay pass cannot carry ts flags)."""
    from x265_tpu.decoder import de265

    frames = _frames(4)
    bs = Encoder(_params(sao=True, rdoq_level=2)).encode(frames)
    ref = de265.decode(bs)
    assert len(ref) == 4


@pytest.mark.slow
def test_tskip_device_path_matches_cpu():
    """With --tskip the 8x8 class stays on the native path; the 16/32/64
    device classes are unaffected — streams must still be byte-equal."""
    frames = _frames(4)
    streams = []
    for dev_res in (True, False):
        enc = Encoder(_params(rdoq_level=2))
        enc.use_device_residual = dev_res
        streams.append(enc.encode(frames))
    assert streams[0] == streams[1]
