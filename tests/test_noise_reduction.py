"""DCT-domain noise reduction (x265 --nr-intra/--nr-inter; denoiseDct
dct.cpp:744 + noiseReductionUpdate frameencoder.cpp:2098)."""
import numpy as np

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import param_default_preset, param_parse


def _noisy_clip(n=6, w=96, h=64, seed=6):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 210, (h, w)).astype(np.int32)
    return [(np.clip(base + rng.integers(-18, 18, (h, w)), 0, 255)
             .astype(np.uint8),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for _ in range(n)]


def _params(nri=0, nrj=0):
    p = param_default_preset("medium")
    p.width, p.height = 96, 64
    p.bframes = 0
    p.scenecut = 0
    p.aq_mode = 0
    p.cu_tree = False
    p.sao = False
    param_parse(p, "qp", "30")
    p.nr_intra, p.nr_inter = nri, nrj
    return p


def test_nr_reduces_bits_on_noise():
    frames = _noisy_clip()
    b_off = Encoder(_params()).encode(frames)
    b_on = Encoder(_params(500, 500)).encode(frames)
    assert len(b_on) < len(b_off)


def test_nr_native_matches_python():
    frames = _noisy_clip(n=4)
    bn = Encoder(_params(500, 500)).encode(frames)
    ep = Encoder(_params(500, 500))
    ep.use_native = False
    assert bn == ep.encode(frames)


def test_nr_offsets_formula():
    enc = Encoder(_params(1000, 0))
    enc._nr["sum"][0, 1] = 100
    enc._nr["cnt"][0] = 10
    off = enc._nr_offsets()
    # (strength*count + sum/2) // (sum+1), DC forced 0
    assert off[0, 1] == (1000 * 10 + 50) // 101
    assert off[0, 0] == 0
    assert off[8, 1] == 0        # inter strength 0 with no history
