"""Tile-parallel analysis over a device mesh (SURVEY.md §2.4 P1/P2
re-imagining): band sharding, ppermute reference halos, psum'd RC state.
Runs on the 8-virtual-device CPU mesh from conftest."""
import numpy as np
import jax
import pytest

from x265_tpu.parallel.tiles import make_tile_mesh, sharded_frame_analysis

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 devices")


@needs_8
def test_sharded_analysis_matches_cross_band_motion():
    mesh = make_tile_mesh(8)
    S = 16
    R = 8
    H, W = S * 2 * 8, 128
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    # vertical motion crossing band boundaries: edge-replicated shift
    # (real motion semantics — NOT np.roll, which wraps frame edges; the
    # halo exchange must clamp at the frame top/bottom like
    # extendPicBorder, not wrap around the ring)
    ref = np.concatenate([np.repeat(y[:1], 5, axis=0), y[:-5]])
    modes, icost, mcost, fc = sharded_frame_analysis(mesh, y, ref, S=S, R=R)
    mcost = np.asarray(mcost)
    # every interior block finds its zero-cost match 5 rows down — this
    # requires correct cross-band halos (bands are 32 rows, shift is 5)
    assert int(mcost[:-1].max()) == 0
    # single-device reference: dense sweep over the edge-padded ref must
    # match the sharded result everywhere, including frame-edge bands
    ref_pad = np.pad(ref, R, mode="edge")
    nby, nbx = H // S, W // S
    expected = np.full((nby, nbx), 1 << 30, np.int64)
    for dy in range(2 * R + 1):
        for dx in range(2 * R + 1):
            sh = ref_pad[dy:dy + H, dx:dx + W]
            sad = np.abs(y - sh).reshape(nby, S, nbx, S).sum(axis=(1, 3))
            expected = np.minimum(expected, sad)
    assert np.array_equal(mcost.astype(np.int64), expected)
    assert modes.shape[0] == (H // S) * (W // S)
    assert float(fc) >= 0


@needs_8
def test_sharded_rc_psum_equals_sum_of_bands():
    mesh = make_tile_mesh(8)
    S = 16
    H, W = S * 2 * 8, 128
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = rng.integers(0, 256, (H, W)).astype(np.int32)
    modes, icost, mcost, fc = sharded_frame_analysis(mesh, y, ref, S=S, R=8)
    manual = float(np.minimum(np.asarray(icost).reshape(H // S, W // S),
                              np.asarray(mcost) * 2.0).sum())
    assert abs(float(fc) - manual) / max(1.0, manual) < 1e-5


def test_mesh_inter_encode_matches_single_device():
    """P frames through Encoder.attach_mesh on 4 devices: the CU-lane
    inter-residual batches shard over the mesh (_inter_multi), and the
    stream is byte-identical to the single-device encode."""
    from x265_tpu.api.encoder import Encoder
    from x265_tpu.api.params import RC_CQP, param_default_preset

    W, H = 128, 64
    rng = np.random.default_rng(11)
    base = rng.integers(40, 200, (H, W + 16))
    frames = [(np.clip(base[:, 2 * i:2 * i + W]
                       + rng.integers(-2, 3, (H, W)), 0, 255)
               .astype(np.uint8),
               np.full((H // 2, W // 2), 120, np.uint8),
               np.full((H // 2, W // 2), 133, np.uint8)) for i in range(2)]

    def encode(mesh):
        p = param_default_preset("medium")
        p.width, p.height = W, H
        p.rc_mode, p.qp = RC_CQP, 30
        p.bframes = 0
        p.rc_lookahead = 0
        p.scenecut = 0
        p.slices = 4
        e = Encoder(p)
        if mesh is not None:
            e.attach_mesh(mesh)
        return e.encode(frames)

    one = encode(None)
    assert encode(make_tile_mesh(4)) == one
    from x265_tpu.decoder.decoder import HEVCDecoder
    assert len(HEVCDecoder().decode(one)) == len(frames)
