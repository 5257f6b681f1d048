"""Encoder-side scaling lists (--scaling-list default; spec 7.4.5,
x265 analog scalinglist.cpp setDefaultScalingList + Quant setScalingList).

The SPS signals scaling_list_enabled with no data present (=> spec
default matrices); quant/RDOQ/dequant in the oracle writer, the native
finalizer and the device residual pipeline all apply the same
per-position m, and the in-repo decoder + libde265 agree bit-exactly.
"""
import numpy as np
import pytest

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import param_default_preset, param_parse
from x265_tpu.hevc.tables import default_scaling_matrix


def _frames(n, seed=11, h=64, w=96):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.uint8)
    out = []
    for i in range(n):
        y = base[i:i + h, i * 2:i * 2 + w]
        out.append((np.ascontiguousarray(y),
                    np.full((h // 2, w // 2), 120, np.uint8),
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
    param_parse(p, "scaling-list", "default")
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def test_default_matrix_derivation():
    m4 = default_scaling_matrix(4, True)
    assert (m4 == 16).all()
    m8 = default_scaling_matrix(8, True)
    assert m8[7, 7] == 115 and m8[0, 0] == 16
    m16 = default_scaling_matrix(16, False)
    assert m16[0, 0] == 16              # DC stays 16
    assert m16[1, 1] == 16              # from base[0,0]
    assert m16[15, 15] == 91            # base[7,7] inter
    assert m16[2, 2] == default_scaling_matrix(8, False)[1, 1]


def test_sps_signals_default_lists():
    from x265_tpu.hevc.bitstream import split_annexb, \
        strip_emulation_prevention
    from x265_tpu.hevc.headers import parse_sps
    enc = Encoder(_params())
    for nal in split_annexb(enc.headers()):
        if (nal[0] >> 1) & 0x3F == 33:
            sps = parse_sps(strip_emulation_prevention(nal[2:]))
            assert sps.scaling_list_enabled
            assert sps.scaling_list_data is None    # defaults
            return
    raise AssertionError("no SPS found")


@pytest.mark.slow
def test_scaling_conformance_libde265():
    """I+P+B stream with default lists (RDOQ on) decodes bit-exactly in
    libde265 AND the in-repo decoder, and differs from the flat stream."""
    from x265_tpu.decoder import de265
    from x265_tpu.decoder.decoder import HEVCDecoder

    frames = _frames(5)
    p = _params(rdoq_level=2)
    bs = Encoder(p).encode(frames)
    p2 = _params(rdoq_level=2)
    p2.scaling_lists = ""
    bs_flat = Encoder(p2).encode(frames)
    assert bs != bs_flat

    ours = HEVCDecoder().decode(bs)
    ref = de265.decode(bs)
    assert len(ours) == len(ref) == 5
    for i, (a, b) in enumerate(zip(ours, ref)):
        bb = b if isinstance(b, tuple) else (b.y, b.cb, b.cr)
        for pa, pb in zip((a.y, a.cb, a.cr), bb):
            assert np.array_equal(np.asarray(pa), np.asarray(pb)), i


@pytest.mark.slow
def test_scaling_native_matches_oracle():
    frames = _frames(3)
    streams = []
    for use_native in (True, False):
        enc = Encoder(_params(rdoq_level=2))
        enc.use_native = use_native
        enc.use_device_residual = False
        streams.append(enc.encode(frames))
    assert streams[0] == streams[1]


@pytest.mark.slow
def test_scaling_device_matches_cpu():
    """The device residual pipeline (inter CUs) applies the same default
    matrices: byte-identical stream with use_device_residual on/off."""
    frames = _frames(4)
    streams = []
    for dev_res in (True, False):
        enc = Encoder(_params(rdoq_level=2))
        enc.use_device_residual = dev_res
        streams.append(enc.encode(frames))
    assert streams[0] == streams[1]
