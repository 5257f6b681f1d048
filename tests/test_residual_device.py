"""Differential tests: the device residual kernels (models/residual.py) must
be bit-exact vs the numpy oracle (ops/ref/transform.py) and the native
finalizer's debug hooks — the TestBench correctness pattern (SURVEY §4.1)
for the decide/emit split."""
import numpy as np
import pytest

from x265_tpu.models.residual import (
    dequantize_b, fwd_transform_b, inv_transform_b, quantize_b, rdoq_b,
    sbh_b, tq_chain,
)
from x265_tpu.ops.ref.transform import (
    dequantize, forward_transform, inverse_transform, quantize, rdoq,
    sign_bit_hiding_adjust,
)
from x265_tpu.hevc.tables import SCANS


@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)])
@pytest.mark.parametrize("bd", [8, 10])
def test_transforms_match_oracle(n, dst, bd):
    rng = np.random.default_rng(n + bd)
    hi = (1 << bd) - 1
    resi = rng.integers(-hi, hi + 1, (24, n, n)).astype(np.int32)
    got = np.asarray(fwd_transform_b(resi, n, dst, bd))
    want = np.stack([forward_transform(r, dst, bd) for r in resi])
    assert np.array_equal(got, want)

    coeff = rng.integers(-3000, 3000, (24, n, n)).astype(np.int32)
    got = np.asarray(inv_transform_b(coeff, n, dst, bd))
    want = np.stack([inverse_transform(c, dst, bd) for c in coeff])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_intra", [True, False])
def test_quant_dequant_match_oracle(bd, is_intra):
    rng = np.random.default_rng(bd)
    for n in (4, 8, 16, 32):
        log2 = n.bit_length() - 1
        coeff = rng.integers(-20000, 20000, (16, n, n)).astype(np.int32)
        qps = rng.integers(1, 63 if bd == 10 else 51, 16).astype(np.int32)
        got = np.asarray(quantize_b(coeff, qps, n, is_intra, bd))
        want = np.stack([quantize(c, int(q), log2, is_intra, bd)
                         for c, q in zip(coeff, qps)])
        assert np.array_equal(got, want), (n, bd)

        lvl = rng.integers(-3000, 3000, (16, n, n)).astype(np.int32)
        got = np.asarray(dequantize_b(lvl, qps, n, bd))
        want = np.stack([dequantize(v, int(q), log2, bd)
                         for v, q in zip(lvl, qps)])
        assert np.array_equal(got, want), (n, bd)


@pytest.mark.parametrize("bd", [8, 10])
def test_rdoq_matches_oracle(bd):
    rng = np.random.default_rng(3 + bd)
    for n in (4, 8, 16, 32):
        log2 = n.bit_length() - 1
        resi = rng.integers(-200, 200, (12, n, n)).astype(np.int32)
        qps = rng.integers(18, 46, 12).astype(np.int32)
        coeff = np.stack([forward_transform(r, False, bd) for r in resi])
        lvl = np.stack([quantize(c, int(q), log2, False, bd)
                        for c, q in zip(coeff, qps)])
        got = np.asarray(rdoq_b(coeff, lvl, qps, n, bd))
        want = np.stack([rdoq(c, v, int(q), log2, None, bd)
                         for c, v, q in zip(coeff, lvl, qps)])
        assert np.array_equal(got, want), (n, bd)


def test_sbh_matches_oracle():
    rng = np.random.default_rng(9)
    for n in (4, 8, 16, 32):
        log2 = n.bit_length() - 1
        lvl = rng.integers(-4, 5, (20, n, n)).astype(np.int32)
        sis = (rng.integers(0, 3, 20) if log2 <= 3
               else np.zeros(20)).astype(np.int32)
        got = np.asarray(sbh_b(lvl, sis, n))
        want = np.stack([
            sign_bit_hiding_adjust(v, np.asarray(
                SCANS[(log2, int(si)) if (log2, int(si)) in SCANS
                      else (log2, 0)]).reshape(-1))
            for v, si in zip(lvl, sis)])
        assert np.array_equal(got, want), n


def test_tq_chain_matches_native_debug():
    """End-to-end chain vs the native debug_tq/debug_itq hooks."""
    from x265_tpu import native
    lib = native.get_lib()
    import ctypes
    lib.debug_tq.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.debug_itq.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
    rng = np.random.default_rng(4)
    for n in (4, 8, 16, 32):
        for qp in (22, 34, 45):
            resi = rng.integers(-255, 256, (6, n, n)).astype(np.int32)
            qps = np.full(6, qp, np.int32)
            lvl, rres, cbf = tq_chain(resi, qps, np.zeros(6, np.int32),
                                      n, False, True, 8, False, False,
                                      False)
            lvl = np.asarray(lvl)
            for i in range(6):
                out = np.zeros((n, n), np.int32)
                r = np.ascontiguousarray(resi[i])
                lib.debug_tq(r.ctypes.data, n, qp, 0, out.ctypes.data)
                assert np.array_equal(out, lvl[i]), (n, qp)
