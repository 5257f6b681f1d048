"""Device loop filter: whole-frame deblock (+ fused SAO statistics).

Round-2 profiling put CPU deblock at ~0.4 s/frame (720p) and ~1.4 s
(1080p) — the single largest host stage of the P/B path (VERDICT r2
"What's weak" #2, "Next round" #3). The filter math is identical to the
numpy reference in hevc/deblock.py (spec 8.7.2; x265 deblock.cpp
pelFilterLumaStrong/pelFilterChroma recast as dense whole-frame array
ops); this module is the jnp port, jitted as ONE dispatch that also
computes the SAO EO/BO statistics on the deblocked output
(sao.cpp:735 calcSaoStatsCTU) so SAO costs no extra round trip.

Boundary-strength derivation stays on the host: it is tiny (4x4-granular
maps) and data-dependent on decision maps the host already holds.

Differential-tested bit-exact against hevc/deblock.py
(tests/test_loopfilter_device.py).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from x265_tpu.hevc.deblock import BETA_TABLE, TC_TABLE


def _luma_pass(y, bs4, qp4, beta_off, tc_off, bypass4, bd):
    """All vertical luma edges (call on transposed planes for the
    horizontal pass). Mirrors _filter_luma_vertical exactly."""
    H, W = y.shape
    if W < 16:
        return y
    cols4 = np.arange(2, W // 4, 2)
    xs = cols4 * 4
    nE = len(xs)
    H4 = H // 4
    y = y.astype(jnp.int32)

    pi = xs[:, None] + np.arange(-4, 0)[None, :]
    qi = xs[:, None] + np.arange(0, 4)[None, :]
    P = y[:, pi].reshape(H4, 4, nE, 4)
    Q = y[:, qi].reshape(H4, 4, nE, 4)

    bs = bs4[:, cols4]
    qpl = ((qp4[:, cols4 - 1] + qp4[:, cols4] + 1) >> 1).astype(jnp.int32)
    qb = jnp.clip(qpl + (beta_off << 1), 0, 51)
    beta = (jnp.asarray(BETA_TABLE)[qb] << (bd - 8)).astype(jnp.int32)
    tq = jnp.clip(qpl + 2 * (bs - 1) + (tc_off << 1), 0, 53)
    tc = (jnp.asarray(TC_TABLE)[tq] << (bd - 8)).astype(jnp.int32)

    dp = jnp.abs(P[:, :, :, 1] - 2 * P[:, :, :, 2] + P[:, :, :, 3])
    dq = jnp.abs(Q[:, :, :, 2] - 2 * Q[:, :, :, 1] + Q[:, :, :, 0])
    dp0, dp3 = dp[:, 0], dp[:, 3]
    dq0, dq3 = dq[:, 0], dq[:, 3]
    d = dp0 + dp3 + dq0 + dq3
    do_filter = (bs > 0) & (d < beta) & (tc > 0)

    def _strong_line(k):
        sp = jnp.abs(P[:, k, :, 0] - P[:, k, :, 3])
        sq = jnp.abs(Q[:, k, :, 0] - Q[:, k, :, 3])
        pq = jnp.abs(P[:, k, :, 3] - Q[:, k, :, 0])
        return ((2 * (dp[:, k] + dq[:, k]) < (beta >> 2)) &
                (sp + sq < (beta >> 3)) & (pq < ((5 * tc + 1) >> 1)))

    strong = do_filter & _strong_line(0) & _strong_line(3)
    weak = do_filter & ~strong
    dEp1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    dEq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    def b4(a):
        return jnp.broadcast_to(a[:, None, :], (H4, 4, nE))

    tc4 = b4(tc)
    strong4, weak4 = b4(strong), b4(weak)

    p3, p2, p1, p0 = (P[:, :, :, i] for i in range(4))
    q0, q1, q2, q3 = (Q[:, :, :, i] for i in range(4))
    maxv = (1 << bd) - 1
    clip3 = lambda lo, hi, v: jnp.minimum(jnp.maximum(v, lo), hi)

    sp0 = clip3(p0 - 2 * tc4, p0 + 2 * tc4,
                (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = clip3(p1 - 2 * tc4, p1 + 2 * tc4, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = clip3(p2 - 2 * tc4, p2 + 2 * tc4,
                (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = clip3(q0 - 2 * tc4, q0 + 2 * tc4,
                (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = clip3(q1 - 2 * tc4, q1 + 2 * tc4, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = clip3(q2 - 2 * tc4, q2 + 2 * tc4,
                (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wactive = weak4 & (jnp.abs(delta) < 10 * tc4)
    d1 = clip3(-tc4, tc4, delta)
    wp0 = jnp.clip(p0 + d1, 0, maxv)
    wq0 = jnp.clip(q0 - d1, 0, maxv)
    tch = tc4 >> 1
    dpv = clip3(-tch, tch, (((p2 + p0 + 1) >> 1) - p1 + d1) >> 1)
    wp1 = jnp.clip(p1 + dpv, 0, maxv)
    dqv = clip3(-tch, tch, (((q2 + q0 + 1) >> 1) - q1 - d1) >> 1)
    wq1 = jnp.clip(q1 + dqv, 0, maxv)
    wEp1 = wactive & b4(dEp1)
    wEq1 = wactive & b4(dEq1)

    np0 = jnp.where(strong4, sp0, jnp.where(wactive, wp0, p0))
    np1 = jnp.where(strong4, sp1, jnp.where(wEp1, wp1, p1))
    np2 = jnp.where(strong4, sp2, p2)
    nq0 = jnp.where(strong4, sq0, jnp.where(wactive, wq0, q0))
    nq1 = jnp.where(strong4, sq1, jnp.where(wEq1, wq1, q1))
    nq2 = jnp.where(strong4, sq2, q2)

    byp_p = b4(bypass4[:, cols4 - 1])
    byp_q = b4(bypass4[:, cols4])
    np0 = jnp.where(byp_p, p0, np0)
    np1 = jnp.where(byp_p, p1, np1)
    np2 = jnp.where(byp_p, p2, np2)
    nq0 = jnp.where(byp_q, q0, nq0)
    nq1 = jnp.where(byp_q, q1, nq1)
    nq2 = jnp.where(byp_q, q2, nq2)

    newP = jnp.stack([P[:, :, :, 0], np2, np1, np0],
                     axis=-1).reshape(H, nE, 4)
    newQ = jnp.stack([nq0, nq1, nq2, Q[:, :, :, 3]],
                     axis=-1).reshape(H, nE, 4)
    out = y.at[:, pi].set(newP)
    out = out.at[:, qi].set(newQ)
    return out


def _chroma_pass(c, bs4, qp4, lut, tc_off, bypass4, bd):
    """All vertical chroma edges (bS==2 only); mirrors
    _filter_chroma_vertical with the qp-map+LUT path."""
    Hc, Wc = c.shape
    if Wc < 16:
        return c
    xs = np.arange(8, Wc, 8)
    nE = len(xs)
    Hc4 = Hc // 4
    c = c.astype(jnp.int32)

    bs = bs4[::2, :][:Hc4, (xs >> 1)]
    mask_seg = bs == 2
    qgrid = qp4[::2, :][:Hc4]
    qpl = ((qgrid[:, (xs >> 1) - 1] + qgrid[:, (xs >> 1)] + 1) >> 1)
    qpl = lut[jnp.clip(qpl, 0, 51)]
    tq = jnp.clip(qpl + 2 + (tc_off << 1), 0, 53)
    tc = (jnp.asarray(TC_TABLE)[tq] << (bd - 8)).astype(jnp.int32)

    pi = xs[:, None] + np.arange(-2, 0)[None, :]
    qi = xs[:, None] + np.arange(0, 2)[None, :]
    P = c[:, pi].reshape(Hc4, 4, nE, 2)
    Q = c[:, qi].reshape(Hc4, 4, nE, 2)
    p1, p0 = P[:, :, :, 0], P[:, :, :, 1]
    q0, q1 = Q[:, :, :, 0], Q[:, :, :, 1]

    tc3 = tc[:, None, :]
    delta = jnp.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc3, tc3)
    maxv = (1 << bd) - 1
    m = jnp.broadcast_to(mask_seg[:, None, :], (Hc4, 4, nE))
    byp_p = jnp.broadcast_to(
        bypass4[::2, :][:Hc4, (xs >> 1) - 1][:, None, :], (Hc4, 4, nE))
    byp_q = jnp.broadcast_to(
        bypass4[::2, :][:Hc4, (xs >> 1)][:, None, :], (Hc4, 4, nE))
    np0 = jnp.where(m & ~byp_p, jnp.clip(p0 + delta, 0, maxv), p0)
    nq0 = jnp.where(m & ~byp_q, jnp.clip(q0 - delta, 0, maxv), q0)

    out = c.at[:, xs - 1].set(np0.reshape(Hc, nE))
    out = out.at[:, xs].set(nq0.reshape(Hc, nE))
    return out


def _deblock_body(y, cb, cr, bs_v, bs_h, qp4, bypass4, lut_cb, lut_cr,
                  beta_off, tc_off, bd):
    y = _luma_pass(y, bs_v, qp4, beta_off, tc_off, bypass4, bd)
    cb = _chroma_pass(cb, bs_v, qp4, lut_cb, tc_off, bypass4, bd)
    cr = _chroma_pass(cr, bs_v, qp4, lut_cr, tc_off, bypass4, bd)
    y = _luma_pass(y.T, bs_h.T, qp4.T, beta_off, tc_off, bypass4.T, bd).T
    cb = _chroma_pass(cb.T, bs_h.T, qp4.T, lut_cb, tc_off,
                      bypass4.T, bd).T
    cr = _chroma_pass(cr.T, bs_h.T, qp4.T, lut_cr, tc_off,
                      bypass4.T, bd).T
    return y, cb, cr


@partial(jax.jit, static_argnames=("beta_off", "tc_off", "bd"))
def _deblock_jit(y, cb, cr, bs_v, bs_h, qp4, bypass4, lut_cb, lut_cr,
                 beta_off, tc_off, bd):
    # int16/uint8 wire; the filter math runs int32
    y, cb, cr = (p.astype(jnp.int32) for p in (y, cb, cr))
    y, cb, cr = _deblock_body(y, cb, cr, bs_v, bs_h, qp4, bypass4,
                              lut_cb, lut_cr, beta_off, tc_off, bd)
    return (y.astype(jnp.int16), cb.astype(jnp.int16),
            cr.astype(jnp.int16))


@partial(jax.jit, static_argnames=("beta_off", "tc_off", "bd", "ctb",
                                   "cy", "cx"))
def _deblock_sao_jit(y, cb, cr, src_y, src_cb, src_cr, bs_v, bs_h, qp4,
                     bypass4, lut_cb, lut_cr, beta_off, tc_off, bd,
                     ctb, cy, cx):
    """Deblock + SAO statistics on the deblocked recon, one dispatch."""
    from x265_tpu.hevc.sao import _plane_stats_jax
    y, cb, cr = (p.astype(jnp.int32) for p in (y, cb, cr))
    src_y, src_cb, src_cr = (p.astype(jnp.int32)
                             for p in (src_y, src_cb, src_cr))
    y, cb, cr = _deblock_body(y, cb, cr, bs_v, bs_h, qp4, bypass4,
                              lut_cb, lut_cr, beta_off, tc_off, bd)
    stats = (_plane_stats_jax(src_y, y, cy, cx, ctb, bd),
             _plane_stats_jax(src_cb, cb, cy, cx, ctb >> 1, bd),
             _plane_stats_jax(src_cr, cr, cy, cx, ctb >> 1, bd))
    return (y.astype(jnp.int16), cb.astype(jnp.int16),
            cr.astype(jnp.int16), stats)


def _sao_apply_plane(rec, typ, cls, offs, ctb, bd):
    """Device SAO apply for one plane — bit-exact vs hevc.sao.apply_plane
    (spec 8.7.3; x265 applyPixelOffsets, sao.cpp:274)."""
    from x265_tpu.hevc.sao import EO_DIRS, SAO_BO, SAO_EO
    H, W = rec.shape
    cy, cx = typ.shape
    maxv = (1 << bd) - 1
    iy = jnp.minimum(jnp.arange(H) // ctb, cy - 1)
    ix = jnp.minimum(jnp.arange(W) // ctb, cx - 1)
    ptyp = typ[iy][:, ix]
    pcls = cls[iy][:, ix]
    poffs = offs[iy][:, ix]                        # [H, W, 4]

    big = 1 << 20

    def shifted(day, dax):
        a = jnp.full((H, W), big, jnp.int32)
        ys = slice(max(0, day), H + min(0, day))
        xs = slice(max(0, dax), W + min(0, dax))
        ys_s = slice(max(0, -day), H + min(0, -day))
        xs_s = slice(max(0, -dax), W + min(0, -dax))
        return a.at[ys_s, xs_s].set(rec[ys, xs])

    add = jnp.zeros((H, W), jnp.int32)
    for eo in range(4):
        day, dax = EO_DIRS[eo]
        a = shifted(day, dax)
        b = shifted(-day, -dax)
        valid = (a != big) & (b != big)
        s = jnp.sign(rec - a) + jnp.sign(rec - b)
        cat = jnp.where(s == -2, 1,
                        jnp.where(s == -1, 2,
                                  jnp.where(s == 1, 3,
                                            jnp.where(s == 2, 4, 0))))
        cat = jnp.where(valid, cat, 0)
        sel = (ptyp == SAO_EO) & (pcls == eo)
        for c in range(1, 5):
            add = add + jnp.where(sel & (cat == c), poffs[..., c - 1], 0)
    band = rec >> (bd - 5)
    selb = ptyp == SAO_BO
    for i in range(4):
        add = add + jnp.where(selb & (band == ((pcls + i) % 32)),
                              poffs[..., i], 0)
    return jnp.clip(rec + add, 0, maxv)


@partial(jax.jit, static_argnames=("ctb", "bd"))
def _sao_apply_jit(y, cb, cr, ty, cly, offy, tc, clcb, clcr, offcb,
                   offcr, ctb, bd):
    y, cb, cr = (p.astype(jnp.int32) for p in (y, cb, cr))
    y = _sao_apply_plane(y, ty, cly, offy, ctb, bd)
    cb = _sao_apply_plane(cb, tc, clcb, offcb, ctb >> 1, bd)
    cr = _sao_apply_plane(cr, tc, clcr, offcr, ctb >> 1, bd)
    return (y.astype(jnp.int16), cb.astype(jnp.int16),
            cr.astype(jnp.int16))


def sao_apply_device(rec_dev, sp, ctb_log2: int, bd: int = 8):
    """Apply SAO to device-resident recon planes from a SaoParams; the
    parameter maps (a few KB) are the only upload and the result stays on
    device (the post-SAO recon is the next frames' reference — VERDICT r4
    next #2: no recon round trips)."""
    ctb = 1 << ctb_log2
    return _sao_apply_jit(
        rec_dev[0], rec_dev[1], rec_dev[2],
        jnp.asarray(np.asarray(sp.type_y, np.int32)),
        jnp.asarray(np.asarray(sp.class_y, np.int32)),
        jnp.asarray(np.asarray(sp.off_y, np.int32)),
        jnp.asarray(np.asarray(sp.type_c, np.int32)),
        jnp.asarray(np.asarray(sp.class_cb, np.int32)),
        jnp.asarray(np.asarray(sp.class_cr, np.int32)),
        jnp.asarray(np.asarray(sp.off_cb, np.int32)),
        jnp.asarray(np.asarray(sp.off_cr, np.int32)),
        ctb, int(bd))


def _chroma_luts(cb_qp_off, cr_qp_off):
    from x265_tpu.hevc.tables import CHROMA_QP_TABLE

    def lut(off):
        return np.array(
            [int(CHROMA_QP_TABLE[min(max(0, q + off), 57)])
             for q in range(52)], np.int32)

    return lut(cb_qp_off), lut(cr_qp_off)


def deblock_frame_device(recon, st, is_intra4, mv4, refpoc4, qp,
                         beta_off=0, tc_off=0, cb_qp_off=0, cr_qp_off=0,
                         bd=8, sao_src=None, ctb_log2=6, sync=True,
                         keep_device=False):
    """Device counterpart of hevc.deblock.deblock_frame (bit-exact).

    qp: scalar or per-4x4 luma QP map. When sao_src (the source planes)
    is given, also returns the SAO statistics of the deblocked recon
    computed in the same dispatch: (y, cb, cr, stats); else (y, cb, cr).
    Outputs are int16 numpy planes.

    sync=False: the dispatch is submitted asynchronously and a
    zero-argument finisher is returned — call it later to collect the
    results. This is the frame-pipeline hook (SURVEY §2.4 P2): the
    device filters frame N while the host runs frame N+1's entropy.
    """
    from x265_tpu.hevc.deblock import derive_bs
    y, cb, cr = recon
    h4, w4 = st.cbf4.shape
    bs_v = derive_bs(st.edge_v, is_intra4, st.cbf4, mv4, refpoc4,
                     vertical=True)
    bs_h = derive_bs(st.edge_h, is_intra4, st.cbf4, mv4, refpoc4,
                     vertical=False)
    if np.isscalar(qp) or np.ndim(qp) == 0:
        qp4 = np.full((h4, w4), int(qp), np.int32)
    else:
        qp4 = np.asarray(qp, np.int32)
    lut_cb, lut_cr = _chroma_luts(cb_qp_off, cr_qp_off)
    # narrow upload: recon fits uint8 at 8-bit depth (half the bytes of
    # int16); device arrays pass through untouched
    wire = np.uint8 if bd == 8 else np.int16

    def up(p):
        if hasattr(p, "devices"):          # already a device array
            return p
        return jnp.asarray(np.asarray(p, wire))

    args = (up(y), up(cb), up(cr))
    if sao_src is None:
        out = _deblock_jit(*args, jnp.asarray(bs_v), jnp.asarray(bs_h),
                           jnp.asarray(qp4), jnp.asarray(st.bypass4),
                           jnp.asarray(lut_cb), jnp.asarray(lut_cr),
                           int(beta_off), int(tc_off), int(bd))

        def finish():
            if keep_device:
                return out                 # (y, cb, cr) device int16
            # int16 on the wire; int32 to the caller (SAO/metrics code
            # uses a 1<<20 out-of-picture sentinel that int16 would wrap)
            yy, cbb, crr = (np.asarray(o, np.int32)
                            for o in jax.device_get(out))
            return yy, cbb, crr
    else:
        ctb = 1 << ctb_log2
        H, W = np.asarray(y).shape
        cy, cx = -(-H // ctb), -(-W // ctb)
        from x265_tpu.utils import devcache
        out = _deblock_sao_jit(
            *args,
            devcache.src_plane(sao_src[0], bd),
            devcache.src_plane(sao_src[1], bd),
            devcache.src_plane(sao_src[2], bd),
            jnp.asarray(bs_v), jnp.asarray(bs_h), jnp.asarray(qp4),
            jnp.asarray(st.bypass4), jnp.asarray(lut_cb),
            jnp.asarray(lut_cr), int(beta_off), int(tc_off), int(bd),
            ctb, cy, cx)

        def finish():
            if keep_device:
                # recon stays on device; only the (small) SAO statistics
                # cross the wire — the host RDO needs them, the pixels
                # it does not
                return out[:3], jax.device_get(out[3])
            o = jax.device_get(out)
            yy, cbb, crr = (np.asarray(x, np.int32) for x in o[:3])
            return yy, cbb, crr, o[3]
    return finish if not sync else finish()
