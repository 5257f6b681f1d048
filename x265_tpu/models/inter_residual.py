"""Batched inter-CU residual pipeline — the P/B-frame half of the
finalizer split.

For every inter CU the decision maps already fix (MV, dir, ref), so
motion compensation, transform, quant, RDOQ, SBH, dequant and recon have
no intra-frame dependency at all: the whole frame's inter CUs of one size
run as ONE batched device computation (reference analog: the per-CU
serial Predict::motionCompensation + Quant::transformNxN walk,
predict.cpp / quant.cpp:397, recast as tensor ops). Results feed the
native writer's precomputed (emit-only) mode — streams are byte-identical
to the all-CPU path (tests/test_finalizer_split.py).

Bit-exactness notes: the 8/4-tap MC uses the same "tap-0 == 64" algebra
as mc_14 (slice_writer.cpp:491) — the generic separable path equals every
xf/yf special case exactly because 64 = 2^6 divides the stage shifts.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from x265_tpu.hevc.tables import CHROMA_QP_TABLE
from x265_tpu.models.residual import _tq_chain

_LUMA_FILT = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], np.int32)
_CHROMA_FILT = np.array([
    [0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
    [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4], [-2, 10, 58, -2]],
    np.int32)


def gather_src_blocks(src, yy, xx, size):
    """[N, size, size] i32 source tiles at (yy, xx) — dynamic_slice clamp
    semantics (XLA emits one parallel gather for the vmap)."""
    N = yy.shape[0]

    def one(i):
        return jax.lax.dynamic_slice(src, (yy[i], xx[i]), (size, size))

    return jax.vmap(one)(jnp.arange(N)).astype(jnp.int32)


def _mc_gather(planes, ridx, x0, y0, mvx, mvy, filt, fb, n, taps, pad, bd):
    """14-bit MC prediction for a batch of blocks from stacked ref planes.

    planes [R, Hp, Wp] int; ridx/x0/y0/mvx/mvy [N]; filt [P, taps];
    fb: mv fractional bits (2 luma, 3 chroma). Returns [N, n, n] int32.
    """
    N = x0.shape[0]
    half = taps // 2
    mask = (1 << fb) - 1
    xi = x0 + (mvx >> fb)
    yi = y0 + (mvy >> fb)
    xf = mvx & mask
    yf = mvy & mask
    side = n + taps - 1
    filt = jnp.asarray(filt)

    def one(i):
        win = jax.lax.dynamic_slice(
            planes, (ridx[i], pad + yi[i] - half + 1, pad + xi[i] - half + 1),
            (1, side, side))[0].astype(jnp.int32)
        fx = filt[xf[i]]
        fy = filt[yf[i]]
        # horizontal: tmp[j, x] = sum_t fx[t] * win[j, x + t]  >> (bd-8)
        cols = jnp.stack([win[:, t:t + n] for t in range(taps)], axis=-1)
        hor = (cols @ fx) >> (bd - 8)                 # [side, n]
        rows = jnp.stack([hor[t:t + n, :] for t in range(taps)], axis=0)
        out = jnp.tensordot(fy, rows, axes=1) >> 6    # [n, n]
        return out

    return jax.vmap(one)(jnp.arange(N))


def _tq_quads(res, qvec, m, N, bd, sdh, do_rdoq, lossless, scaling,
              kk=None, pfx=0):
    """res [N,2m,2m] -> per-quadrant transform chain at m (z-order);
    returns (lvl [N,2m,2m], rres [N,2m,2m], cbf [N,4]). Serves both the
    64x64 implicit RQT split and the explicit inter RQT level."""
    q = res.reshape(N, 2, m, 2, m).transpose(0, 1, 3, 2, 4)
    q = q.reshape(N * 4, m, m)
    lv, rr, cb_ = _tq_chain(q, jnp.repeat(qvec, 4),
                            jnp.zeros((N * 4,), jnp.int32), m,
                            False, False, bd, sdh, do_rdoq,
                            lossless, scaling, kk, pfx)

    def back(a):
        return (a.reshape(N, 2, 2, m, m).transpose(0, 1, 3, 2, 4)
                .reshape(N, 2 * m, 2 * m))

    return back(lv), back(rr), cb_.reshape(N, 4)


def _inter_class_body(src_y, src_cb, src_cr,
                 r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                 xy, mv, dirm, ref_i, qp, wp,
                 n, bd, sdh, do_rdoq, lossless, pad, wld, wcd,
                 cb_off, cr_off, scaling=False, consts=None, psy_fx=0,
                 rqt=False, rate_kk=None):
    """One CU-size class of inter CUs: MC + residual chain, all planes.

    xy [N,2] luma top-left; mv [N,2,2] (list, x/y) qpel; dirm [N] 1/2/3;
    ref_i [N] L0 ref; qp [N] slice/CTB QpY (pre bd offset); wp [4,3,3]
    (flag,w,off) explicit L0 weights; wld/wcd denoms.
    Returns (lvl_y [N,n,n], lvl_cb, lvl_cr [N,n/2,n/2], cbf [N,3],
    rec_y [N,n,n], rec_cb, rec_cr).
    """
    N = xy.shape[0]
    hs = n // 2
    maxv = (1 << bd) - 1
    x0 = xy[:, 0]
    y0 = xy[:, 1]

    def pred_plane(pl, planes0, planes1, size, fb, taps, filt, padc):
        xx = x0 if pl == 0 else x0 >> 1
        yy = y0 if pl == 0 else y0 >> 1
        use0 = (dirm & 1) > 0
        use1 = (dirm & 2) > 0
        r0 = jnp.where(use0, ref_i, 0)
        p0 = _mc_gather(planes0, r0, xx, yy, mv[:, 0, 0], mv[:, 0, 1],
                        filt, fb, size, taps, padc, bd)
        p1 = _mc_gather(planes1, jnp.zeros_like(ref_i), xx, yy,
                        mv[:, 1, 0], mv[:, 1, 1], filt, fb, size, taps,
                        padc, bd)
        # bi: (p0 + p1 + off) >> (15-bd)
        shift_bi = 15 - bd
        bi = jnp.clip((p0 + p1 + (1 << (shift_bi - 1))) >> shift_bi,
                      0, maxv)
        # uni from the used list
        p14 = jnp.where(use0[:, None, None], p0, p1)
        shift_u = 14 - bd
        uni = jnp.clip((p14 + (1 << (shift_u - 1))) >> shift_u, 0, maxv)
        # explicit weighted uni (L0 only, 8.5.4.2.3.2)
        we = wp[jnp.where(use0, r0, 0), pl]            # [N,3] flag,w,off
        wflag = (we[:, 0] > 0) & use0 & ~use1
        denom = wld if pl == 0 else wcd                # static per slice
        log2wd = denom + 14 - bd
        o = (we[:, 2] << (bd - 8))[:, None, None]
        wgt = we[:, 1][:, None, None]
        if log2wd >= 1:
            wv = (p14 * wgt + (1 << (log2wd - 1))) >> log2wd
        else:
            wv = p14 * wgt
        wuni = jnp.clip(wv + o, 0, maxv)
        pred = jnp.where((dirm == 3)[:, None, None], bi,
                         jnp.where(wflag[:, None, None], wuni, uni))
        return pred

    pred_y = pred_plane(0, r0y, r1y, n, 2, 8, jnp.asarray(_LUMA_FILT),
                        pad)
    pred_cb = pred_plane(1, r0cb, r1cb, hs, 3, 4, jnp.asarray(_CHROMA_FILT),
                         pad >> 1)
    pred_cr = pred_plane(2, r0cr, r1cr, hs, 3, 4, jnp.asarray(_CHROMA_FILT),
                         pad >> 1)

    def block_src(plane, size):
        xx = x0 if plane == 0 else x0 >> 1
        yy = y0 if plane == 0 else y0 >> 1
        return gather_src_blocks((src_y, src_cb, src_cr)[plane],
                                 yy, xx, size)

    sy = block_src(0, n)
    scb = block_src(1, hs)
    scr = block_src(2, hs)

    qpy = qp + 6 * (bd - 8)
    # chroma QP (8.6.1 via table; offsets are traced scalars)
    def cqp(off):
        bdo = 6 * (bd - 8)
        q = jnp.clip(qp + off, -bdo, 57)
        tab = jnp.asarray(CHROMA_QP_TABLE)
        return jnp.where(q < 0, q + bdo, tab[jnp.maximum(q, 0)] + bdo)

    zsel = jnp.zeros((N,), jnp.int32)
    kl = None if consts is None else consts[0]
    kc = None if consts is None else consts[1]
    if n <= 32:
        lvl_y, rres_y, cbf_y = _tq_chain(sy - pred_y, qpy, zsel, n, False,
                                         False, bd, sdh, do_rdoq, lossless,
                                         scaling, kl, psy_fx)
        lvl_cb, rres_cb, cbf_cb = _tq_chain(scb - pred_cb, cqp(cb_off),
                                            zsel, hs, False, False, bd,
                                            sdh, do_rdoq, lossless, scaling,
                                            kc)
        lvl_cr, rres_cr, cbf_cr = _tq_chain(scr - pred_cr, cqp(cr_off),
                                            zsel, hs, False, False, bd,
                                            sdh, do_rdoq, lossless, scaling,
                                            kc)
        cbf = jnp.stack([cbf_y, cbf_cb, cbf_cr], axis=1)
    else:
        lvl_y, rres_y, qcbf_y = _tq_quads(sy - pred_y, qpy, n // 2, N,
                                          bd, sdh, do_rdoq, lossless,
                                          scaling, kl, psy_fx)
        lvl_cb, rres_cb, qcbf_cb = _tq_quads(scb - pred_cb, cqp(cb_off),
                                             hs // 2, N, bd, sdh, do_rdoq,
                                             lossless, scaling, kc)
        lvl_cr, rres_cr, qcbf_cr = _tq_quads(scr - pred_cr, cqp(cr_off),
                                             hs // 2, N, bd, sdh, do_rdoq,
                                             lossless, scaling, kc)
        cbf = jnp.stack([qcbf_y, qcbf_cb, qcbf_cr], axis=2)  # [N,4,3]
    tusplit = jnp.zeros((N,), jnp.int32)
    if rqt and 16 <= n <= 32 and not lossless:
        # explicit RQT level (x265 estimateResidualQT, search.cpp:2863):
        # re-run the chain with the TU split into 4 quadrants and keep
        # the per-CU winner of 32*SSE + lambda*estBits (+ the tree's
        # extra cbf/flag bins charged to the split)
        from x265_tpu.models.rdo import _tb_rate_bits_j
        from x265_tpu.hevc.tables import RDOQ_LAM32_FULL
        lam = (jnp.asarray(np.asarray(RDOQ_LAM32_FULL), jnp.float32)[qpy]
               / float(1 << 15))        # bits domain
        ly2, ry2, qy2 = _tq_quads(sy - pred_y, qpy, n // 2, N, bd, sdh,
                                  do_rdoq, lossless, scaling, kl, psy_fx)
        lcb2, rcb2, qcb2 = _tq_quads(scb - pred_cb, cqp(cb_off), hs // 2,
                                     N, bd, sdh, do_rdoq, lossless,
                                     scaling, kc)
        lcr2, rcr2, qcr2 = _tq_quads(scr - pred_cr, cqp(cr_off), hs // 2,
                                     N, bd, sdh, do_rdoq, lossless,
                                     scaling, kc)

        def sse3(ra, rb, rc):
            e1 = ((sy - pred_y) - ra).astype(jnp.float32)
            e2 = ((scb - pred_cb) - rb).astype(jnp.float32)
            e3 = ((scr - pred_cr) - rc).astype(jnp.float32)
            return ((e1 * e1).sum((1, 2)) + (e2 * e2).sum((1, 2))
                    + (e3 * e3).sum((1, 2)))

        def rate_whole(lv, kkrow, m):
            return jnp.where(jnp.any(lv != 0, (1, 2)),
                             _tb_rate_bits_j(lv, kkrow), 0.0)

        def rate_quads(lv, kkrow, m):
            q = (lv.reshape(N, 2, m, 2, m).transpose(0, 1, 3, 2, 4)
                 .reshape(N * 4, m, m))
            r = jnp.where(jnp.any(q != 0, (1, 2)),
                          _tb_rate_bits_j(q, kkrow), 0.0)
            return r.reshape(N, 4).sum(1)

        kkl = rate_kk[0]
        kkc = rate_kk[1]
        rate_a = (rate_whole(lvl_y, kkl, n)
                  + rate_whole(lvl_cb, kkc, hs)
                  + rate_whole(lvl_cr, kkc, hs))
        rate_b = (rate_quads(ly2, kkl, n // 2)
                  + rate_quads(lcb2, kkc, hs // 2)
                  + rate_quads(lcr2, kkc, hs // 2))
        # tree-bin overhead of the split: 4 extra cbf_luma + up to 8
        # child chroma cbfs, ~8 bins net of the shared flag
        cost_a = 32.0 * sse3(rres_y, rres_cb, rres_cr) + lam * rate_a
        cost_b = (32.0 * sse3(ry2, rcb2, rcr2)
                  + lam * (rate_b + 8.0))
        split = cost_b < cost_a
        tusplit = split.astype(jnp.int32)
        sm = split[:, None, None]
        lvl_y = jnp.where(sm, ly2, lvl_y)
        rres_y = jnp.where(sm, ry2, rres_y)
        lvl_cb = jnp.where(sm, lcb2, lvl_cb)
        rres_cb = jnp.where(sm, rcb2, rres_cb)
        lvl_cr = jnp.where(sm, lcr2, lvl_cr)
        rres_cr = jnp.where(sm, rcr2, rres_cr)
        # per-quadrant cbf (z-order) regardless of the choice: an
        # unsplit CU broadcasts its single cbf to all 4 cells
        whole = jnp.stack(
            [jnp.any(lvl_y != 0, (1, 2)), jnp.any(lvl_cb != 0, (1, 2)),
             jnp.any(lvl_cr != 0, (1, 2))], axis=1)          # [N,3]
        quads = jnp.stack([qy2, qcb2, qcr2], axis=2)         # [N,4,3]
        cbf = jnp.where(split[:, None, None], quads,
                        jnp.broadcast_to(whole[:, None, :], quads.shape))
    rec_y = jnp.clip(pred_y + rres_y, 0, maxv)
    rec_cb = jnp.clip(pred_cb + rres_cb, 0, maxv)
    rec_cr = jnp.clip(pred_cr + rres_cr, 0, maxv)
    # int16 wire: halves the device->host transfer (levels clamp to
    # +-32767, recon to the pixel range)
    return (lvl_y.astype(jnp.int16), lvl_cb.astype(jnp.int16),
            lvl_cr.astype(jnp.int16), cbf, rec_y.astype(jnp.int16),
            rec_cb.astype(jnp.int16), rec_cr.astype(jnp.int16), tusplit)


_inter_class = partial(jax.jit, static_argnames=(
    "n", "bd", "sdh", "do_rdoq", "lossless", "pad", "wld", "wcd",
    "cb_off", "cr_off", "scaling", "psy_fx"))(_inter_class_body)


@partial(jax.jit, static_argnames=("ns", "bd", "sdh", "do_rdoq", "lossless",
                                   "pad", "wld", "wcd", "cb_off", "cr_off",
                                   "scaling", "psy_fx", "rqt"))
def _inter_multi(src_y, src_cb, src_cr,
                 r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                 per_class, wp, ns, bd, sdh, do_rdoq, lossless, pad,
                 wld, wcd, cb_off, cr_off, scaling=False, consts=None,
                 psy_fx=0, rqt=False, rate_kk=None):
    """Several CU-size classes in ONE dispatch (one host round trip
    instead of one per class). per_class: tuple of (xy, mv, dirm, ref_i,
    qp) batches matching `ns`."""
    outs = []
    for (n, args) in zip(ns, per_class):
        xy, mv, dirm, ref_i, qp = args
        outs.append(_inter_class_body(
            src_y, src_cb, src_cr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
            xy, mv, dirm, ref_i, qp, wp, n, bd, sdh, do_rdoq, lossless,
            pad, wld, wcd, cb_off, cr_off, scaling, consts, psy_fx,
            rqt, rate_kk))
    return tuple(outs)


@partial(jax.jit, static_argnames=("ns", "bd", "sdh", "do_rdoq", "lossless",
                                   "pad", "wld", "wcd", "cb_off", "cr_off",
                                   "scaling", "psy_fx", "rqt"))
def _inter_multi_planes(src_y, src_cb, src_cr,
                        r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                        per_class, wp, ns, bd, sdh, do_rdoq, lossless,
                        pad, wld, wcd, cb_off, cr_off, scaling=False,
                        consts=None, psy_fx=0, rqt=False, rate_kk=None):
    """_inter_multi + ON-DEVICE scatter of every class's levels/recon
    into full-frame planes.  The device->host copy then carries
    ~frame-sized tensors instead of worst-case padded per-lane batches
    (~9 MB instead of ~50 MB per 1080p frame).  Padding lanes carry an
    out-of-range xy
    sentinel and are dropped by the scatter (mode='drop').

    Returns (lvl_y, lvl_cb, lvl_cr [i16], cbf8, has8 [u8],
    rec_y, rec_cb, rec_cr [u8 when bd==8 else i16])."""
    h, w = src_y.shape
    maxv = (1 << bd) - 1
    rdt = jnp.uint8 if bd == 8 else jnp.int16
    lvl_y = jnp.zeros((h, w), jnp.int16)
    lvl_cb = jnp.zeros((h // 2, w // 2), jnp.int16)
    lvl_cr = jnp.zeros((h // 2, w // 2), jnp.int16)
    rec_y = jnp.clip(src_y, 0, maxv).astype(rdt)
    rec_cb = jnp.clip(src_cb, 0, maxv).astype(rdt)
    rec_cr = jnp.clip(src_cr, 0, maxv).astype(rdt)
    cbf8 = jnp.zeros((h // 8, w // 8), jnp.uint8)
    has8 = jnp.zeros((h // 8, w // 8), jnp.uint8)
    tus8 = jnp.zeros((h // 8, w // 8), jnp.uint8)
    for (n, args) in zip(ns, per_class):
        xy, mv, dirm, ref_i, qp = args
        ly, lcb, lcr, cbf, ry, rcb, rcr, tus = _inter_class_body(
            src_y, src_cb, src_cr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
            xy, mv, dirm, ref_i, qp, wp, n, bd, sdh, do_rdoq, lossless,
            pad, wld, wcd, cb_off, cr_off, scaling, consts, psy_fx,
            rqt, rate_kk)
        x0 = xy[:, 0]
        y0 = xy[:, 1]
        ii = jnp.arange(n)
        yy = y0[:, None, None] + ii[None, :, None]
        xx = x0[:, None, None] + ii[None, None, :]
        lvl_y = lvl_y.at[yy, xx].set(ly, mode="drop")
        rec_y = rec_y.at[yy, xx].set(ry.astype(rdt), mode="drop")
        hh = ii[:n // 2]
        cyy = (y0 >> 1)[:, None, None] + hh[None, :, None]
        cxx = (x0 >> 1)[:, None, None] + hh[None, None, :]
        lvl_cb = lvl_cb.at[cyy, cxx].set(lcb, mode="drop")
        lvl_cr = lvl_cr.at[cyy, cxx].set(lcr, mode="drop")
        rec_cb = rec_cb.at[cyy, cxx].set(rcb.astype(rdt), mode="drop")
        rec_cr = rec_cr.at[cyy, cxx].set(rcr.astype(rdt), mode="drop")
        r = n >> 3
        jj = jnp.arange(r)
        byy = (y0 >> 3)[:, None, None] + jj[None, :, None]
        bxx = (x0 >> 3)[:, None, None] + jj[None, None, :]
        if cbf.ndim == 2:
            bits = (cbf[:, 0].astype(jnp.uint8)
                    | (cbf[:, 1].astype(jnp.uint8) << 1)
                    | (cbf[:, 2].astype(jnp.uint8) << 2))
            bmap = jnp.broadcast_to(bits[:, None, None],
                                    (bits.shape[0], r, r))
        else:
            # cbf [N,4,3], z-order quadrants; each 32x32 quadrant's
            # 8x8-block range carries its own bits
            qbits = (cbf[:, :, 0].astype(jnp.uint8)
                     | (cbf[:, :, 1].astype(jnp.uint8) << 1)
                     | (cbf[:, :, 2].astype(jnp.uint8) << 2))    # [N,4]
            half = r // 2
            rows = []
            for qy in range(2):
                cols = [jnp.broadcast_to(
                    qbits[:, qy * 2 + qx][:, None, None],
                    (qbits.shape[0], half, half)) for qx in range(2)]
                rows.append(jnp.concatenate(cols, axis=2))
            bmap = jnp.concatenate(rows, axis=1)
        cbf8 = cbf8.at[byy, bxx].set(bmap, mode="drop")
        has8 = has8.at[byy, bxx].set(jnp.ones_like(bmap), mode="drop")
        tmap = jnp.broadcast_to(tus.astype(jnp.uint8)[:, None, None],
                                (tus.shape[0], r, r))
        tus8 = tus8.at[byy, bxx].set(tmap, mode="drop")
    return (lvl_y, lvl_cb, lvl_cr, cbf8, has8, rec_y, rec_cb, rec_cr,
            tus8)


@partial(jax.jit, static_argnames=("B", "ts", "ntx"))
def _gather_tiles_jit(plane, idx, B, ts, ntx):
    """Gather B ts-x-ts tiles (row-major tile indices) from a plane —
    the sparse-readback primitive: quantized levels are zero outside
    coded TBs, so only cbf tiles are copied to the host."""
    ty = idx // ntx
    tx = idx % ntx

    def one(i):
        return jax.lax.dynamic_slice(plane, (ty[i] * ts, tx[i] * ts),
                                     (ts, ts))
    return jax.vmap(one)(jnp.arange(B))


@partial(jax.jit, static_argnames=("Bs", "tss", "ntxs"))
def _gather_tiles3_jit(py, pcb, pcr, iy, icb, icr, Bs, tss, ntxs):
    """Three-plane tile gather in ONE dispatch (one host round trip
    instead of three)."""
    return tuple(_gather_tiles_jit.__wrapped__(pl_, ix, B, ts, ntx)
                 for (pl_, ix, B, ts, ntx)
                 in zip((py, pcb, pcr), (iy, icb, icr), Bs, tss, ntxs))


def _sparse_planes_download(planes_dev, masks, tss):
    """Materialize host int16 planes from device level planes, moving
    only the tiles whose cbf `mask` (tile grid, row-major) is set —
    batched across the three planes so the wire pays ONE round trip.
    Falls back to full downloads when occupancy makes them cheaper."""
    metas = []
    for plane_dev, mask, ts in zip(planes_dev, masks, tss):
        nty, ntx = mask.shape
        ys, xs = np.nonzero(mask)
        count = len(ys)
        out = np.zeros(plane_dev.shape, np.int16)
        metas.append([ys, xs, count, ntx, out])
    if all(m[2] == 0 for m in metas):
        return tuple(m[4] for m in metas)
    if any(m[2] > 0.5 * mask.size
           for m, mask in zip(metas, masks)):
        got = jax.device_get(tuple(planes_dev))
        return tuple(np.asarray(g, np.int16) for g in got)
    Bs = []
    idxs = []
    for (ys, xs, count, ntx, _out) in metas:
        B = 32
        while B < count:
            B <<= 1
        idx = np.zeros(B, np.int32)
        idx[:count] = (ys * ntx + xs).astype(np.int32)
        Bs.append(B)
        idxs.append(jnp.asarray(idx))
    tiles3 = jax.device_get(_gather_tiles3_jit(
        *planes_dev, *idxs, tuple(Bs), tuple(tss),
        tuple(m[3] for m in metas)))
    outs = []
    for (ys, xs, count, _ntx, out), tiles, ts in zip(metas, tiles3, tss):
        if count:
            t = np.asarray(tiles)
            ii = np.arange(ts)
            yy = (ys * ts)[:, None, None] + ii[None, :, None]
            xx = (xs * ts)[:, None, None] + ii[None, None, :]
            out[yy, xx] = t[:count]
        outs.append(out)
    return tuple(outs)


def build_inter_pre(src, decisions, refs_padded, qp_slice, p, wp_native,
                    sdh, rdoq_level, mesh=None, slice_type=1):
    """Assemble the precomputed-residual dict for the native writer.

    src: (y, cb, cr) numpy planes; decisions: FrameDecisions with
    inter8/dir8/mv8/ref8/cu_log2_map/qp_map; refs_padded: ([(y,cb,cr)
    padded int16] per list) — the same arrays handed to the native call;
    wp_native: (wp[4,3,3] int32, luma_denom, chroma_denom) or None.
    Returns the `pre` dict for native.encode_slice_px, or None when there
    is nothing to precompute.

    mesh: optional jax Mesh — the CU-lane batches shard over its 'tile'
    axis (data parallelism over CUs) with source/reference planes
    replicated; the SAME jitted graph runs partitioned by GSPMD, so
    levels/cbf/recon are identical to the single-device path
    (SURVEY §2.4 P3/P4 re-imagined; validated by dryrun_multichip).
    """
    from jax import enable_x64
    if decisions.inter8 is None or not np.any(decisions.inter8):
        return None
    h, w = src[0].shape
    h8, w8 = decisions.cu_log2_map.shape
    bd = p.bit_depth
    maxv = (1 << bd) - 1

    pad = 80
    from x265_tpu.utils import devcache
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        def lanes_sharding():
            return NamedSharding(mesh, _P("tile"))

        def repl(a):
            return jax.device_put(
                np.asarray(a),
                NamedSharding(mesh, _P(*([None] * np.ndim(a)))))
    else:
        repl = jnp.asarray

    def stack_refs(lst, plane):
        from x265_tpu.engine.planes import FramePlanes
        if not lst:
            # dummy full-size plane (never selected; dir excludes the list)
            sh_ = ((h + 2 * pad, w + 2 * pad) if plane == 0
                   else (h // 2 + pad, w // 2 + pad))
            z = np.zeros((1,) + sh_, np.int16)
            return repl(z) if mesh is not None else jnp.asarray(z)
        if mesh is not None:     # replicated upload (no cache reuse)
            return repl(np.stack([np.asarray(
                r.dev_padded(pad)[plane] if isinstance(r, FramePlanes)
                else r[plane]) for r in lst]))

        def one(r):
            if isinstance(r, FramePlanes):
                # device-resident anchor: padded ON DEVICE, never wired
                return r.dev_padded(pad)[plane]
            # host planes: per-plane cached uploads (anchors serve many
            # frames)
            return devcache.get_or(("ref80", id(r[plane])), r[plane],
                                   lambda rr=r[plane]: jnp.asarray(rr))
        return jnp.stack([one(r) for r in lst])

    r0y = stack_refs(refs_padded[0], 0)
    r0cb = stack_refs(refs_padded[0], 1)
    r0cr = stack_refs(refs_padded[0], 2)
    r1y = stack_refs(refs_padded[1], 0)
    r1cb = stack_refs(refs_padded[1], 1)
    r1cr = stack_refs(refs_padded[1], 2)
    if mesh is None:
        # cached thin-wire upload (shared with the SAO-stats dispatch);
        # the jitted body gathers + upcasts to int32 where it computes
        sy = devcache.src_plane(src[0], bd)
        scb = devcache.src_plane(src[1], bd)
        scr = devcache.src_plane(src[2], bd)
    else:
        sy = repl(np.asarray(src[0], dtype=np.int32))
        scb = repl(np.asarray(src[1], dtype=np.int32))
        scr = repl(np.asarray(src[2], dtype=np.int32))
    if wp_native is not None:
        wp_arr = repl(np.asarray(wp_native[0], np.int32))
        wld, wcd = int(wp_native[1]), int(wp_native[2])
    else:
        wp_arr = repl(np.zeros((4, 3, 3), np.int32))
        wld = wcd = 0

    # mesh=None rides the plane-scatter path: no host-side buffers needed
    if mesh is not None:
        lvl_y = np.zeros((h, w), np.int16)
        lvl_cb = np.zeros((h // 2, w // 2), np.int16)
        lvl_cr = np.zeros((h // 2, w // 2), np.int16)
        cbf8 = np.zeros((h8, w8), np.uint8)
        has8 = np.zeros((h8, w8), np.uint8)
        rec_y = np.asarray(src[0], dtype=np.int16).copy()
        rec_cb = np.asarray(src[1], dtype=np.int16).copy()
        rec_cr = np.asarray(src[2], dtype=np.int16).copy()

    inter8 = decisions.inter8.astype(bool)
    ref8 = (decisions.ref8 if decisions.ref8 is not None
            else np.zeros((h8, w8), np.int32))
    qmap = decisions.qp_map
    ctb_l2 = p.ctb_log2
    any_pre = False
    classes = []          # (n, N, x0, y0, ys8, xs8, device batch args)
    # --tskip: 8x8 CUs have 4x4 chroma TBs with a per-TB transform_skip
    # decision the pre-tensor wire cannot carry — leave that class to the
    # native compute path (which decides identically)
    sizes = (4, 5, 6) if p.tskip else (3, 4, 5, 6)
    for s_log2 in sizes:
        n = 1 << s_log2
        if n > min(h, w):
            continue
        r = n >> 3
        ys8, xs8 = np.nonzero(
            (decisions.cu_log2_map == s_log2) & inter8 &
            ((np.arange(h8)[:, None] % r) == 0) &
            ((np.arange(w8)[None, :] % r) == 0))
        # full CUs only (partial frame-edge CUs stay on the CPU path)
        keep = ((ys8 * 8 + n) <= h) & ((xs8 * 8 + n) <= w)
        ys8, xs8 = ys8[keep], xs8[keep]
        N = len(ys8)
        # N == 0 classes still dispatch (all-padding lanes): dropping
        # them would change the static `ns` signature frame-to-frame and
        # recompile the fused graph (tens of seconds each) — the
        # exact trap the FIXED-batch-shape rule below exists to avoid
        any_pre = any_pre or N > 0
        x0 = (xs8 * 8).astype(np.int32)
        y0 = (ys8 * 8).astype(np.int32)
        mv = np.ascontiguousarray(decisions.mv8[ys8, xs8]).astype(np.int32)
        dirm = decisions.dir8[ys8, xs8].astype(np.int32)
        ref_i = ref8[ys8, xs8].astype(np.int32)
        if qmap is not None:
            qp_cu = qmap[y0 >> ctb_l2, x0 >> ctb_l2].astype(np.int32)
        else:
            qp_cu = np.full(N, qp_slice, np.int32)
        # FIXED batch shape per size class (the whole grid): a varying N
        # would recompile the kernel every frame (tens of seconds each)
        # — padding to the worst case costs only redundant lanes,
        # compiling costs a frame.
        NB = max(256, ((w // n) * (h // n)))
        if N > NB:   # cannot happen (N is bounded by the grid), safety
            NB = -(-N // 256) * 256
        # lane axis shards over the mesh: keep it divisible by any
        # practical tile count
        NB = -(-NB // 32) * 32
        pad_n = NB - N

        def padn(a, fill=0):
            return np.concatenate(
                [a, np.full((pad_n,) + a.shape[1:], fill, a.dtype)]) \
                if pad_n else a

        if mesh is not None:
            import jax as _jax
            shl = lanes_sharding()

            def put(a):
                return _jax.device_put(np.asarray(a), shl)
        else:
            put = jnp.asarray
        # padding lanes carry an out-of-range xy sentinel: the device
        # plane-scatter drops them (mode='drop'); the mesh path slices
        # [:N] on the host so the fill never surfaces there either
        args = (put(padn(np.stack([x0, y0], 1), 1 << 20)),
                put(padn(mv)), put(padn(dirm, 1)),
                put(padn(ref_i)), put(padn(qp_cu, 26)))
        classes.append((n, N, x0, y0, ys8, xs8, r, args))
    if any_pre:
        ns = tuple(c[0] for c in classes)
        kk = None
        psy_fx = 0
        if rdoq_level > 0 and not p.lossless:
            # estBit RDOQ consts from the SLICE qp/type — identical to
            # the native and oracle derivations (hevc/rate_model.py)
            from x265_tpu.hevc.rate_model import slice_rate_consts
            kk = jnp.asarray(slice_rate_consts(slice_type, qp_slice))
            if rdoq_level >= 2:
                psy_fx = int(round(p.psy_rdoq * 256))
        # explicit inter RQT level (x265 tuQTMaxInterDepth >= 2,
        # search.cpp:2863): RD-choose TU==CU vs a 4-quad split for the
        # 16/32 classes; the estBit rate rows feed the choice even when
        # RDOQ itself is off
        rqt = bool(getattr(p, "tu_inter_depth", 1) >= 2
                   and not p.lossless and not p.tskip)
        rate_kk = None
        if rqt:
            from x265_tpu.hevc.rate_model import slice_rate_consts
            rate_kk = jnp.asarray(slice_rate_consts(slice_type, qp_slice))
        if mesh is None:
            # single-device: scatter to planes ON DEVICE; the wire
            # carries frame-sized tensors (~4x fewer bytes than the
            # padded per-lane batches), and the level planes come back
            # SPARSELY — only tiles under coded TBs (cbf set) download
            # (levels are zero everywhere else by construction)
            with enable_x64():
                pouts = _inter_multi_planes(
                    sy, scb, scr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                    tuple(c[7] for c in classes), wp_arr, ns, bd,
                    bool(sdh), rdoq_level > 0, bool(p.lossless), 80,
                    wld, wcd, int(p.cb_qp_offset), int(p.cr_qp_offset),
                    bool(p.scaling_lists), kk, psy_fx, rqt, rate_kk)
            (cbf8, has8, rec_y, rec_cb, rec_cr, tus8) = jax.device_get(
                pouts[3:])
            lvl_y, lvl_cb, lvl_cr = _sparse_planes_download(
                (pouts[0], pouts[1], pouts[2]),
                ((cbf8 & 1) > 0, (cbf8 & 2) > 0, (cbf8 & 4) > 0),
                (8, 4, 4))
            return {"lvl_y": lvl_y, "lvl_cb": lvl_cb, "lvl_cr": lvl_cr,
                    "cbf8": cbf8, "has8": has8,
                    "tusplit8": np.asarray(tus8, np.uint8),
                    "rec_y": rec_y.astype(np.int16),
                    "rec_cb": rec_cb.astype(np.int16),
                    "rec_cr": rec_cr.astype(np.int16)}
        with enable_x64():
            outs = _inter_multi(
                sy, scb, scr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                tuple(c[7] for c in classes), wp_arr, ns, bd,
                bool(sdh), rdoq_level > 0, bool(p.lossless), 80,
                wld, wcd, int(p.cb_qp_offset), int(p.cr_qp_offset),
                bool(p.scaling_lists), kk, psy_fx, rqt, rate_kk)
        outs = jax.device_get(outs)
        tusplit8 = np.zeros((h8, w8), np.uint8)
        for (n, N, x0, y0, ys8, xs8, r, _a), out in zip(classes, outs):
            ly, lcb, lcr, cbf, ry, rcb, rcr, tus = (np.asarray(o)[:N]
                                                    for o in out)
            ii = np.arange(n)
            yy = y0[:, None, None] + ii[None, :, None]
            xx = x0[:, None, None] + ii[None, None, :]
            lvl_y[yy, xx] = ly.astype(np.int16)
            rec_y[yy, xx] = ry.astype(np.int16)
            hh = ii[:n // 2]
            cyy = (y0 >> 1)[:, None, None] + hh[None, :, None]
            cxx = (x0 >> 1)[:, None, None] + hh[None, None, :]
            lvl_cb[cyy, cxx] = lcb.astype(np.int16)
            lvl_cr[cyy, cxx] = lcr.astype(np.int16)
            rec_cb[cyy, cxx] = rcb.astype(np.int16)
            rec_cr[cyy, cxx] = rcr.astype(np.int16)
            jj = np.arange(r)
            byy = ys8[:, None, None] + jj[None, :, None]
            bxx = xs8[:, None, None] + jj[None, None, :]
            if cbf.ndim == 2:
                bits = (cbf[:, 0].astype(np.uint8)
                        | (cbf[:, 1].astype(np.uint8) << 1)
                        | (cbf[:, 2].astype(np.uint8) << 2))
                cbf8[byy, bxx] = bits[:, None, None]
            else:
                # per-quadrant cbf bits land on each 32x32 quadrant's
                # 8x8-block range (the writer reads the quadrant's
                # top-left block); cbf is [N, 4, 3], z-order quadrants
                qbits = (cbf[:, :, 0].astype(np.uint8)
                         | (cbf[:, :, 1].astype(np.uint8) << 1)
                         | (cbf[:, :, 2].astype(np.uint8) << 2))  # [N,4]
                half = r // 2
                qmap = np.zeros((len(ys8), r, r), np.uint8)
                for q, (dx, dy) in enumerate(
                        ((0, 0), (1, 0), (0, 1), (1, 1))):
                    qmap[:, dy * half:(dy + 1) * half,
                         dx * half:(dx + 1) * half] = \
                        qbits[:, q][:, None, None]
                cbf8[byy, bxx] = qmap
            has8[byy, bxx] = 1
            tusplit8[byy, bxx] = tus[:, None, None].astype(np.uint8)
    if not any_pre:
        return None
    return {"lvl_y": lvl_y, "lvl_cb": lvl_cb, "lvl_cr": lvl_cr,
            "cbf8": cbf8, "has8": has8, "tusplit8": tusplit8,
            "rec_y": rec_y, "rec_cb": rec_cb, "rec_cr": rec_cr}
