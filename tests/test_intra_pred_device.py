"""Differential test: the table-driven batched intra prediction
(models/intra_pred.py) vs the native filter_refs+predict_intra via the
debug_pred hook — all 35 modes, luma+chroma, strong smoothing on/off."""
import ctypes

import numpy as np
import pytest

from x265_tpu import native
from x265_tpu.models.intra_pred import predict_intra_batch


@pytest.mark.parametrize("nt", [4, 8, 16, 32])
def test_pred_matches_native(nt):
    lib = native.get_lib()
    lib.debug_pred.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rng = np.random.default_rng(nt)
    R = 4 * nt + 1
    N = 70
    refs = rng.integers(0, 256, (N, R)).astype(np.int32)
    # flat-ish rows exercise the strong-smoothing bilinear branch
    refs[::3] = np.clip(100 + np.round(np.linspace(0, 6, R)).astype(np.int32)
                        + rng.integers(-1, 2, R), 0, 255)
    modes = np.concatenate([np.arange(35), np.arange(35)]).astype(np.int32)
    for strong in (0, 1):
        for luma in (True, False):
            pred = np.asarray(predict_intra_batch(
                refs, np.ones((N, R), bool), modes, nt, 8, luma,
                bool(strong)))
            for i in range(N):
                want = np.zeros((nt, nt), np.int32)
                r = np.ascontiguousarray(refs[i])
                lib.debug_pred(r.ctypes.data, nt, int(modes[i]),
                               0 if luma else 1, strong, want.ctypes.data)
                assert np.array_equal(pred[i], want), (
                    nt, int(modes[i]), luma, strong)
