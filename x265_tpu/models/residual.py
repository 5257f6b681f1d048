"""Exact-integer residual pipeline on the device — the decide/emit split.

Device side of the finalizer split (reference analog: x265 separates
Analysis::compressCTU pixel math from encodeCTU bin emission,
frameencoder.cpp:1519 vs 1533; quant.cpp:397 transformNxN). Everything
here reproduces the native finalizer's integer arithmetic BIT-EXACTLY —
forward/inverse transform (spec 8.6 HM scaling), quant (171/85 deadzone),
integer RDOQ (shared RDOQ_LAM32 fixed-point lambda), sign-bit-hiding,
dequant — so the CPU consumes (levels, cbf, recon) tensors and emits
CABAC bins only, with streams byte-identical to the all-CPU path
(differential-tested in tests/test_residual_device.py).

Kernels are batched over TUs of one static size; per-TU QP is a tensor
(AQ/cuTree qp_map). Transform/quant/dequant are int32-exact (bounds in
docstrings); RDOQ cost accumulation needs wider integers and runs under a
scoped jax.experimental.enable_x64.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from x265_tpu.ops.ref.transform import DCT, DST4
from x265_tpu.hevc.tables import (
    QUANT_SCALES, DEQUANT_SCALES, RDOQ_LAM32, SCANS,
)


def _tmat(n: int, dst: bool) -> np.ndarray:
    return (DST4 if (dst and n == 4) else DCT[n]).astype(np.int32)


def _default_m(n: int, is_intra: bool) -> np.ndarray:
    """Default scaling matrix (spec 7.4.5 / Tables 7-5,7-6) as an [n,n]
    int32 trace constant. Only the DEFAULT lists are supported on the
    device path (--scaling-list default; param coerces custom files)."""
    from x265_tpu.hevc.tables import default_scaling_matrix
    return default_scaling_matrix(n, is_intra).astype(np.int32)


def _rshift_round(x, s):
    """(x + (1 << (s-1))) >> s, arithmetic shift (s static int >= 1)."""
    return (x + (1 << (s - 1))) >> s


@partial(jax.jit, static_argnames=("n", "dst", "bd"))
def fwd_transform_b(resi: jnp.ndarray, n: int, dst: bool,
                    bd: int) -> jnp.ndarray:
    """Batched forward transform [N,n,n] int32 -> [N,n,n] int32.

    Bounds: stage-1 acc <= 32*90*2^(bd+1) < 2^31; stage-2 acc <=
    32*90*2^16 < 2^31 — int32 exact.
    """
    t = jnp.asarray(_tmat(n, dst))
    log2 = n.bit_length() - 1
    s1 = log2 + bd - 9
    s2 = log2 + 6
    resi = resi.astype(jnp.int32)
    # tmp[k][y] = sum_x t[k,x] * resi[y,x]
    tmp = jnp.einsum("kx,nyx->nky", t, resi,
                     preferred_element_type=jnp.int32)
    tmp = _rshift_round(tmp, s1)
    # coeff[ky][kx] = sum_y t[ky,y] * tmp[kx,y]
    out = jnp.einsum("ay,nky->nak", t, tmp,
                     preferred_element_type=jnp.int32)
    return _rshift_round(out, s2)


@partial(jax.jit, static_argnames=("n", "dst", "bd"))
def inv_transform_b(coeff: jnp.ndarray, n: int, dst: bool,
                    bd: int) -> jnp.ndarray:
    """Batched normative inverse transform, 16-bit inter-stage clamp.
    Bounds: acc <= 32*90*2^15 < 2^30 — int32 exact."""
    t = jnp.asarray(_tmat(n, dst))
    s2 = 20 - bd
    coeff = coeff.astype(jnp.int32)
    # tmp[y][kx] = sum_ky t[ky,y] * coeff[ky,kx]  >> 7, clip16
    tmp = jnp.einsum("ka,nkx->nax", t, coeff,
                     preferred_element_type=jnp.int32)
    tmp = jnp.clip(_rshift_round(tmp, 7), -32768, 32767)
    # resi[y][x] = sum_kx t[kx,x] * tmp[y,kx] >> s2, clip16
    out = jnp.einsum("kx,nyk->nyx", t, tmp,
                     preferred_element_type=jnp.int32)
    return jnp.clip(_rshift_round(out, s2), -32768, 32767)


@partial(jax.jit, static_argnames=("n", "is_intra", "bd", "scaling"))
def quantize_b(coeff: jnp.ndarray, qp: jnp.ndarray, n: int, is_intra: bool,
               bd: int, scaling: bool = False) -> jnp.ndarray:
    """Batched deadzone quant; qp [N] per-TU. Bounds: |c|*scale < 2^30,
    offset <= 171<<20 => sum < 2^31 — int32 exact. With scaling lists the
    per-position quant coefficient is quantScale[rem]*16/m (x265
    ScalingList quantCoef derivation; default m >= 16 keeps the bound)."""
    log2 = n.bit_length() - 1
    per = qp.astype(jnp.int32) // 6
    rem = qp.astype(jnp.int32) % 6
    tr_shift = 15 - bd - log2
    qbits = (14 + per + tr_shift)[:, None, None]
    scale = jnp.asarray(QUANT_SCALES, jnp.int32)[rem][:, None, None]
    if scaling:
        scale = (scale * 16) // jnp.asarray(_default_m(n, is_intra))[None]
    offset = jnp.asarray(171 if is_intra else 85, jnp.int32) << (qbits - 9)
    c = coeff.astype(jnp.int32)
    a = jnp.abs(c)
    v = jnp.minimum((a * scale + offset) >> qbits, 32767)
    return jnp.where(c < 0, -v, v)


def _deq_core(lvl, per, rem, bs, rounded: bool, m=None):
    """Shared dequant core without int64:
    (t*2^per + rnd) >> bs == t << (per-bs)              (per >= bs)
                          == (t + rnd') >> (bs-per)     (per < bs)
    with t = lvl*scale*16 (|t| <= 32767*1152 < 2^26). rnd' = 2^(bs-per-1)
    when `rounded` (normative dequant), else 0 (RDOQ's deq).

    m: optional [n,n] scaling matrix (int). The m path widens to int64
    (t can exceed 2^31 after the up-shift with m up to 255) and is only
    reachable through tq_chain/rdoq_b, which trace under enable_x64."""
    if m is None:
        scale = (jnp.asarray(DEQUANT_SCALES, jnp.int32)[rem] * 16)
    else:
        scale = (jnp.asarray(DEQUANT_SCALES, jnp.int64)[rem][..., None, None]
                 * jnp.asarray(m, jnp.int64))
        per = per[..., None, None]
        t = lvl.astype(jnp.int64) * scale
        sh = per - bs
        up = t << jnp.maximum(sh, 0)
        dn_s = jnp.maximum(-sh, 0)
        if rounded:
            rnd = jnp.where(
                dn_s > 0,
                jnp.asarray(1, jnp.int64) << jnp.maximum(dn_s - 1, 0), 0)
        else:
            rnd = 0
        dn = (t + rnd) >> dn_s
        return jnp.where(sh >= 0, up, dn)
    while scale.ndim < lvl.ndim:
        scale = scale[..., None]
        per = per[..., None]
    t = lvl.astype(jnp.int32) * scale
    sh = per - bs
    up = t << jnp.maximum(sh, 0)
    dn_s = jnp.maximum(-sh, 0)
    if rounded:
        rnd = jnp.where(dn_s > 0,
                        jnp.asarray(1, jnp.int32) << jnp.maximum(dn_s - 1, 0),
                        0)
    else:
        rnd = 0
    dn = (t + rnd) >> dn_s
    return jnp.where(sh >= 0, up, dn)


@partial(jax.jit, static_argnames=("n", "bd", "scaling", "is_intra"))
def dequantize_b(lvl: jnp.ndarray, qp: jnp.ndarray, n: int,
                 bd: int, scaling: bool = False,
                 is_intra: bool = False) -> jnp.ndarray:
    """Batched normative dequant + clamp16 (int32-only on the flat path;
    the scaling-list path needs enable_x64 in the caller's trace)."""
    log2 = n.bit_length() - 1
    qp = qp.astype(jnp.int32)
    m = _default_m(n, is_intra) if scaling else None
    d = _deq_core(lvl, qp // 6, qp % 6, bd + log2 - 5, rounded=True, m=m)
    return jnp.clip(d, -32768, 32767).astype(jnp.int32)


def _ilog2(l: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(l)) for l >= 1, exact (threshold-count form)."""
    lg = jnp.zeros_like(l)
    for k in range(1, 16):
        lg = lg + (l >= (1 << k)).astype(l.dtype)
    return lg


@partial(jax.jit, static_argnames=("n", "bd", "scaling", "is_intra",
                                   "psy_fx"))
def _rdoq_x64(coeff, lvl, qp, n, bd, scaling: bool = False,
              is_intra: bool = False, consts=None, psy_fx: int = 0):
    """int64 body of rdoq_b — must be traced with x64 enabled.

    consts: optional [8] int32 Q15 fractional-bit constants
    (hevc.rate_model estBit analog) for the batch's plane; None keeps
    the static bin-count model.

    psy_fx: Q8 psy-rdoq strength — AC coefficients earn an energy
    credit (psy_fx * 32 * |dequant(l)|) >> 8 (quant.cpp:610 psy path,
    luma only; matches ops/ref/transform.rdoq bit-exactly)."""
    log2 = n.bit_length() - 1
    qp = qp.astype(jnp.int32)
    per = qp // 6
    rem = qp % 6
    bs = bd + log2 - 5
    tr_shift = 15 - bd - log2
    # estBit path: real fractional bits get the full lambda2; the
    # static bin-count model keeps its 0.4-calibrated table
    from x265_tpu.hevc.tables import RDOQ_LAM32_FULL
    lam_tab = RDOQ_LAM32 if consts is None else RDOQ_LAM32_FULL
    lam_fx = (jnp.asarray(lam_tab, jnp.int64)[qp]
              << (2 * tr_shift))[:, None, None]
    c = coeff.astype(jnp.int64)
    sgn = jnp.sign(lvl).astype(jnp.int64)
    l0 = jnp.abs(lvl).astype(jnp.int64)
    m = _default_m(n, is_intra) if scaling else None

    def deq(l32):
        return _deq_core(l32, per, rem, bs, rounded=False,
                         m=m).astype(jnp.int64)

    if consts is not None:
        K = consts.astype(jnp.int64)

        def rcost(l):
            # shared estBit formula (hevc/rate_model.py module doc)
            esc = jnp.maximum(l - 5, 1)
            lg = _ilog2(esc).astype(jnp.int64)
            remb = jnp.where(l < 6, jnp.maximum(l - 2, 0) << 15,
                             (4 + 2 * lg) << 15)
            rf = jnp.where(
                l == 0, K[0],
                K[1] + 32768 + jnp.where(
                    l == 1, K[2],
                    K[3] + jnp.where(l == 2, K[4], K[5] + remb)))
            return (lam_fx * rf) >> 15

        cg_gain = K[7] - K[6]
    else:
        def rcost(l):
            r = jnp.where(l > 0, 3, 1).astype(jnp.int64)
            lg = _ilog2(jnp.maximum(l, 1))
            return lam_fx * (r + jnp.where(l > 1, 2 + 2 * lg, 0))

    if psy_fx:
        ac = jnp.ones((n, n), bool).at[0, 0].set(False)[None]

        def credit(l):
            return jnp.where(ac, (psy_fx * 32
                                  * deq(l.astype(jnp.int32))) >> 8, 0)
    else:
        def credit(l):
            return 0

    def cost(l):
        e = c - sgn * deq(l.astype(jnp.int32))
        return 32 * e * e + rcost(l) - credit(l)

    best_l = l0
    best = cost(l0)
    for cand in (jnp.maximum(l0 - 1, 0), jnp.zeros_like(l0)):
        cc = cost(cand)
        take = cc < best
        best = jnp.where(take, cc, best)
        best_l = jnp.where(take, cand, best_l)
    out = sgn * best_l

    # CG zeroing: 32*(d_zero - d_now) < rate saved by coding csbf=0
    ncg = n // 4
    l_abs = jnp.abs(out)
    e_now = c - jnp.sign(out) * deq(l_abs.astype(jnp.int32))

    def cg_sum(x):
        return x.reshape(-1, ncg, 4, ncg, 4).sum(axis=(2, 4))

    d_zero = cg_sum(c * c)
    d_now = cg_sum(e_now * e_now)
    r_now = cg_sum(rcost(l_abs))
    if psy_fx:
        r_now = r_now - cg_sum(credit(l_abs))
    any_nz = cg_sum(l_abs) > 0
    # lam_fx is [N,1,1], broadcasting over the [N,ncg,ncg] CG grid
    if consts is not None:
        save = r_now + ((lam_fx * cg_gain) >> 15)
    else:
        save = r_now - lam_fx
    zero_cg = any_nz & (32 * (d_zero - d_now) < save)
    z = zero_cg[:, :, None, :, None]
    out5 = out.reshape(-1, ncg, 4, ncg, 4)
    out5 = jnp.where(z, 0, out5)
    return out5.reshape(-1, n, n).astype(jnp.int32)


def rdoq_b(coeff, lvl, qp, n: int, bd: int, scaling: bool = False,
           is_intra: bool = False, consts=None, psy_fx: int = 0):
    """Batched integer RDOQ (bit-exact vs rdoq_adjust / oracle rdoq)."""
    from jax import enable_x64
    with enable_x64():
        return _rdoq_x64(coeff, lvl, qp, n, bd, scaling, is_intra,
                         None if consts is None else jnp.asarray(consts),
                         psy_fx)


@partial(jax.jit, static_argnames=("n",))
def sbh_b(lvl: jnp.ndarray, scan_sel: jnp.ndarray, n: int) -> jnp.ndarray:
    """Batched sign-bit-hiding pre-adjust (sbh_adjust / oracle
    sign_bit_hiding_adjust): per 16-coeff scan group with lastNZ-firstNZ>3,
    force parity(sum|l|) == sign(firstNZ) by nudging the first NZ level.

    lvl [N,n,n]; scan_sel [N] in {0,1,2} picks the scan order (diag/hor/
    vert — mode-dependent for small intra TUs).
    """
    log2 = n.bit_length() - 1
    scans = [SCANS[(log2, si)] if (log2, si) in SCANS else SCANS[(log2, 0)]
             for si in (0, 1, 2)]
    scans = jnp.asarray(np.stack([np.asarray(s, np.int32).reshape(-1)
                                  for s in scans]))        # [3, n*n]
    N = lvl.shape[0]
    flat = lvl.reshape(N, n * n)
    scan = scans[scan_sel]                                  # [N, n*n]
    s = jnp.take_along_axis(flat, scan, axis=1)             # scanned order
    ncg = (n * n) // 16
    g = s.reshape(N, ncg, 16)
    nz = g != 0
    any_nz = nz.any(axis=2)
    first = jnp.argmax(nz, axis=2)                          # first NZ idx
    last = 15 - jnp.argmax(nz[:, :, ::-1], axis=2)
    asum = jnp.abs(g).sum(axis=2)
    firstval = jnp.take_along_axis(g, first[:, :, None], axis=2)[:, :, 0]
    want = (firstval < 0).astype(jnp.int32)
    need = any_nz & (last - first > 3) & ((asum & 1) != want)
    # adjustment: +/-1 toward even parity; |1| goes to 2 (never to 0)
    adj = jnp.where(jnp.abs(firstval) == 1,
                    firstval + jnp.sign(firstval),
                    firstval - jnp.sign(firstval))
    newval = jnp.where(need, adj, firstval)
    g = jnp.where(
        (jnp.arange(16)[None, None, :] == first[:, :, None]) &
        need[:, :, None],
        newval[:, :, None], g)
    s = g.reshape(N, n * n)
    # inverse scatter: flat[scan[i]] = s[i]
    out = jnp.zeros_like(flat).at[jnp.arange(N)[:, None], scan].set(s)
    return out.reshape(N, n, n)


@partial(jax.jit, static_argnames=("n", "dst", "is_intra", "bd", "sdh",
                                   "do_rdoq", "lossless", "scaling",
                                   "psy_fx"))
def _tq_chain(resi: jnp.ndarray, qp: jnp.ndarray, scan_sel: jnp.ndarray,
              n: int, dst: bool, is_intra: bool, bd: int, sdh: bool,
              do_rdoq: bool, lossless: bool, scaling: bool = False,
              consts=None, psy_fx: int = 0):
    if lossless:
        cbf = jnp.any(resi != 0, axis=(1, 2))
        return resi, resi, cbf
    cf = fwd_transform_b(resi, n, dst, bd)
    lvl = quantize_b(cf, qp, n, is_intra, bd, scaling)
    if do_rdoq:
        lvl = _rdoq_x64(cf, lvl, qp, n, bd, scaling, is_intra, consts,
                        psy_fx)
    if sdh:
        lvl = jnp.where(jnp.any(lvl != 0, axis=(1, 2))[:, None, None],
                        sbh_b(lvl, scan_sel, n), lvl)
    cbf = jnp.any(lvl != 0, axis=(1, 2))
    deq = dequantize_b(lvl, qp, n, bd, scaling, is_intra)
    rr = inv_transform_b(deq, n, dst, bd)
    rres = jnp.where(cbf[:, None, None], rr, 0)
    return lvl, rres, cbf


def tq_chain(resi, qp, scan_sel, n: int, dst: bool, is_intra: bool,
             bd: int, sdh: bool, do_rdoq: bool, lossless: bool,
             scaling: bool = False, consts=None, psy_fx: int = 0):
    """The full coeffs_from_pred / tb_process transform chain for a batch
    of same-size TUs: residual -> (levels, recon-residual, cbf).

    resi [N,n,n] int32; qp [N] (already plane-adjusted Qp'); scan_sel [N]
    scan index for SBH. Returns (levels int32 [N,n,n], rres int32 [N,n,n],
    cbf bool [N]). Traced under x64 so the RDOQ cost accumulation is
    int64-exact.
    """
    from x265_tpu.utils import checks
    if checks.enabled():      # X265TPU_CHECKIFY=1: instrumented graph
        return checks.checked_tq_chain(resi, qp, scan_sel, n, dst,
                                       is_intra, bd, sdh, do_rdoq,
                                       lossless, scaling, consts)
    from jax import enable_x64
    with enable_x64():
        return _tq_chain(resi, qp, scan_sel, n, dst, is_intra, bd, sdh,
                         do_rdoq, lossless, scaling, consts, psy_fx)
