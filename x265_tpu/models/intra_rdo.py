"""Recon-in-the-loop RD promotion of intra CUs to 32x32.

x265 analog: Analysis::compressIntraCU recurses depths 0..3 with full
per-depth RDO (analysis.cpp:514) via Search::estIntraPredQT
(search.cpp:1509): a 35-mode SATD scan builds a candidate list, each
candidate is fully coded (predict, transform, quantize, reconstruct)
and the cheapest tree level wins.  Our base analysis tops out at 16x16
(models/intra_frame.py); on flat/gradient content four 16-CU mode
signals + four small TBs are a pure syntax floor vs one 32 CU with one
32x32 TB (round-3 VERDICT item #1).

Batched re-imagining: every eligible 32-aligned group in the frame is
evaluated in ONE batched dispatch.  Predictions come from the linear
intra operator bank (ops/intra_matrix.py) with source-pixel neighbors —
the same decision-only approximation the 16x16 analysis uses (the CABAC
finalizer re-derives normative predictions from recon neighbors, so any
outcome is a legal bitstream and the SSE bias cancels between the two
configurations being compared).

Cost domain matches models/rdo.py: 32*SSE + RDOQ_LAM32[qp] *
(rate_bins + syntax-bit estimates) + sqrt(32*lam)*psy_rd*|energy diff|,
summed over all three planes (chroma rides DM mode).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from x265_tpu.hevc.tables import RDOQ_LAM32_FULL
from x265_tpu.models.residual import _tq_chain
from x265_tpu.models.rdo import (_chroma_qp_vec, _psy_cost,
                                 _tb_rate_bits_j)
from x265_tpu.ops.intra_matrix import intra_weight_matrices

# full float32 products: a GPU may otherwise run them in TF32, and the
# rounded costs then decide other modes than the CPU path pins down
_HIGHEST = jax.lax.Precision.HIGHEST

# static syntax estimates (bin-count scale, see models/rdo.py):
# per-CU overhead (skip/pred_mode/part/cbf bins) and the split flag
INTRA_CU_OH = 5.0
SPLIT_BIN = 1.0
# extra candidate slots beyond the four sub-CU modes: planar, DC, and
# the group's own 35-mode SATD winner at 32x32
K_CANDS = 7


def _mode_bits(m):
    """Approximate mode-signalling bins: planar/DC often hit the MPM
    list (x265 codes MPM idx in 1-2 EP bins), angular modes usually pay
    the 5-bin rem_intra_luma_pred_mode path."""
    m = np.asarray(m)
    return np.where(m == 0, 2.0, np.where(m == 1, 3.0, 7.0)) \
        .astype(np.float32)


def _refs_of(plane_p, x0, y0, s):
    """Reference vectors [N, 4s+1] for blocks at (x0, y0) of a padded
    plane (1 left/top, 2s right/bottom edge pad).  Layout matches
    ops.ref.intra / intra_weight_matrices: left bottom-up, corner, top."""
    def one(i):
        top = jax.lax.dynamic_slice(
            plane_p, (y0[i], x0[i] + 1), (1, 2 * s))[0]
        left = jax.lax.dynamic_slice(
            plane_p, (y0[i] + 1, x0[i]), (2 * s, 1))[:, 0]
        corner = jax.lax.dynamic_slice(
            plane_p, (y0[i], x0[i]), (1, 1))[0, 0]
        return jnp.concatenate([left[::-1], corner[None], top])
    return jax.vmap(one)(jnp.arange(x0.shape[0]))


def _blks(plane, xv, yv, s):
    def one(i):
        return jax.lax.dynamic_slice(plane, (yv[i], xv[i]), (s, s))
    return jax.vmap(one)(jnp.arange(xv.shape[0])).astype(jnp.int32)


def _satd8(resid):
    """SATD over 8x8 tiles of [..., S, S] float residuals."""
    from x265_tpu.models.intra_frame import _hadamard
    S = resid.shape[-1]
    h = jnp.asarray(_hadamard(8), jnp.float32)
    r = resid.reshape(resid.shape[:-2] + (S // 8, 8, S // 8, 8))
    r = jnp.swapaxes(r, -3, -2)
    t = jnp.einsum("ij,...jk,kl->...il", h, r, h,
                   preferred_element_type=jnp.float32,
                   precision=_HIGHEST)
    return jnp.abs(t).sum(axis=(-1, -2, -3, -4)) / 4.0


@partial(jax.jit, static_argnames=("bd", "sdh", "do_rdoq", "scaling",
                                   "cb_off", "cr_off", "psy"))
def _intra32_costs(y, cb, cr, xy, m4, mbits4, qp, rk,
                   bd, sdh, do_rdoq, scaling, cb_off, cr_off, psy=0.0):
    """RD costs of G candidate 32x32 intra regions:
    ONE 32-CU (best of K_CANDS modes) vs FOUR 16-CUs at their analysed
    modes.

    y/cb/cr: full int32 source planes; xy [G,2] (x0,y0) luma coords;
    m4 [G,4] z-order sub-block modes; mbits4 [G] summed sub-mode bins;
    qp [G].  Returns (cost_one [G], mode_one [G], cost_four [G])."""
    G = xy.shape[0]
    S = 32
    maxv = (1 << bd) - 1
    x0, y0 = xy[:, 0], xy[:, 1]

    yp = jnp.pad(y.astype(jnp.float32), ((1, 2 * S), (1, 2 * S)),
                 mode="edge")
    cbp = jnp.pad(cb.astype(jnp.float32), ((1, S), (1, S)), mode="edge")
    crp = jnp.pad(cr.astype(jnp.float32), ((1, S), (1, S)), mode="edge")

    qpy = qp + 6 * (bd - 8)
    # estBit rates are real bits -> full lambda2 (rate_model.py)
    lam = jnp.asarray(np.asarray(RDOQ_LAM32_FULL),
                      jnp.int64)[qpy].astype(jnp.float32)
    psylam = jnp.sqrt(32.0 * lam) * psy
    qpc_cb = _chroma_qp_vec(qp, bd, cb_off) + 6 * (bd - 8)
    qpc_cr = _chroma_qp_vec(qp, bd, cr_off) + 6 * (bd - 8)

    def tb_cost(src, pred, qvec, size, want_psy, krow):
        """(sse, rate_bits, psy) of TBs coded from float predictions."""
        predi = jnp.clip(jnp.round(pred), 0, maxv).astype(jnp.int32)
        resi = src - predi
        lvl, rres, cbf = _tq_chain(
            resi, qvec, jnp.zeros((resi.shape[0],), jnp.int32),
            size, False, True, bd, sdh, do_rdoq, False, scaling)
        e = (resi - rres).astype(jnp.float32)
        sse = (e * e).sum(axis=(1, 2))
        rate = jnp.where(cbf, _tb_rate_bits_j(lvl, krow), 0.0)
        if want_psy:
            pc = _psy_cost(src, jnp.clip(predi + rres, 0, maxv))
        else:
            pc = jnp.zeros_like(sse)
        return sse, rate.astype(jnp.float32), pc

    # ---- ONE 32-CU: all-35 prediction bank, SATD-shortlist K candidates,
    # full T/Q/recon cost on each, min wins -------------------------------
    W32 = jnp.asarray(intra_weight_matrices(S))           # [35,S*S,4S+1]
    refs32 = _refs_of(yp, x0, y0, S)                      # [G,129]
    preds35 = jnp.einsum("mpr,gr->gmp", W32, refs32,
                         preferred_element_type=jnp.float32,
                         precision=_HIGHEST)
    src32 = _blks(y, x0, y0, S)                           # [G,S,S]
    satd = _satd8(preds35.reshape(G, 35, S, S)
                  - src32.astype(jnp.float32)[:, None])   # [G,35]
    mb35 = jnp.asarray(_mode_bits(np.arange(35)))
    best35 = jnp.argmin(satd + lam[:, None] * mb35[None, :],
                        axis=1).astype(jnp.int32)
    cand = jnp.concatenate(
        [jnp.zeros((G, 1), jnp.int32),                    # planar
         jnp.ones((G, 1), jnp.int32),                     # DC
         m4.astype(jnp.int32),                            # the four subs'
         best35[:, None]], axis=1)                        # SATD winner
    K = cand.shape[1]
    pred1 = jnp.take_along_axis(preds35, cand[..., None], axis=1)
    pred1 = pred1.reshape(G * K, S, S)
    sse1, rate1, psy1 = tb_cost(
        jnp.repeat(src32, K, axis=0), pred1, jnp.repeat(qpy, K), S,
        psy > 0, rk[0])

    # chroma (DM = candidate luma mode): 16x16 TBs
    W16c = jnp.asarray(intra_weight_matrices(16, c_idx=1))
    xc, yc = x0 >> 1, y0 >> 1
    for (plane_p, plane, qv) in ((cbp, cb, qpc_cb), (crp, cr, qpc_cr)):
        refsc = _refs_of(plane_p, xc, yc, 16)
        cpred35 = jnp.einsum("mpr,gr->gmp", W16c, refsc,
                             preferred_element_type=jnp.float32,
                             precision=_HIGHEST)
        cpred = jnp.take_along_axis(cpred35, cand[..., None], axis=1)
        csrc = _blks(plane, xc, yc, 16)
        sc, rc, _pc = tb_cost(jnp.repeat(csrc, K, axis=0),
                              cpred.reshape(G * K, 16, 16),
                              jnp.repeat(qv, K), 16, False, rk[1])
        sse1 = sse1 + sc
        rate1 = rate1 + rc

    mbits1 = jnp.take(mb35, cand).reshape(G * K)
    cost1 = (32.0 * sse1
             + jnp.repeat(lam, K) * (rate1 + INTRA_CU_OH + mbits1)
             + jnp.repeat(psylam, K) * psy1).reshape(G, K)
    ksel = jnp.argmin(cost1, axis=1)
    cost_one = jnp.take_along_axis(cost1, ksel[:, None], 1)[:, 0]
    mode_one = jnp.take_along_axis(cand, ksel[:, None], 1)[:, 0]

    # ---- FOUR 16-CUs at their analysed modes ----------------------------
    qq = jnp.arange(4, dtype=jnp.int32)
    x4 = (x0[:, None] + (qq % 2)[None, :] * 16).reshape(-1)
    y4 = (y0[:, None] + (qq // 2)[None, :] * 16).reshape(-1)
    m4f = m4.reshape(-1).astype(jnp.int32)
    W16 = jnp.asarray(intra_weight_matrices(16))
    refs16 = _refs_of(yp, x4, y4, 16)                     # [4G,65]
    p35 = jnp.einsum("mpr,gr->gmp", W16, refs16,
                     preferred_element_type=jnp.float32,
                     precision=_HIGHEST)
    pred4 = jnp.take_along_axis(p35, m4f[:, None, None], 1)[:, 0]
    src16 = _blks(y, x4, y4, 16)
    sse4, rate4, psy4 = tb_cost(src16, pred4.reshape(-1, 16, 16),
                                jnp.repeat(qpy, 4), 16, psy > 0, rk[0])

    W8c = jnp.asarray(intra_weight_matrices(8, c_idx=1))
    for (plane_p, plane, qv) in ((cbp, cb, qpc_cb), (crp, cr, qpc_cr)):
        refsc = _refs_of(plane_p, x4 >> 1, y4 >> 1, 8)
        cp35 = jnp.einsum("mpr,gr->gmp", W8c, refsc,
                          preferred_element_type=jnp.float32,
                          precision=_HIGHEST)
        cpred = jnp.take_along_axis(cp35, m4f[:, None, None], 1)[:, 0]
        csrc = _blks(plane, x4 >> 1, y4 >> 1, 8)
        sc, rc, _pc = tb_cost(csrc, cpred.reshape(-1, 8, 8),
                              jnp.repeat(qv, 4), 8, False, rk[1])
        sse4 = sse4 + sc
        rate4 = rate4 + rc

    sse4 = sse4.reshape(G, 4).sum(axis=1)
    rate4 = rate4.reshape(G, 4).sum(axis=1)
    psy4 = psy4.reshape(G, 4).sum(axis=1)
    cost_four = (32.0 * sse4
                 + lam * (rate4 + 4 * INTRA_CU_OH + SPLIT_BIN + mbits4)
                 + psylam * psy4)
    return cost_one, mode_one.astype(jnp.int32), cost_four


def rd_intra_promote32(frame, dec, qp, p, min_groups=1, init_type=0):
    """Promote eligible 2x2 groups of 16x16 intra CUs to one 32x32 intra
    CU where the recon-in-loop RD cost wins (mutates dec in place;
    returns the number of promoted groups).

    Eligible: 32-aligned, fully inside the picture, all sixteen 8-cells
    at cu_log2_map == 4 and intra (inter8 None or False)."""
    import os
    if p.ctb_log2 < 5 or p.lossless:
        return 0
    if os.environ.get("X265TPU_INTRA32", "1") == "0":   # debug A/B gate
        return 0
    h8, w8 = dec.cu_log2_map.shape
    h32, w32 = h8 // 4, w8 // 4
    if h32 == 0 or w32 == 0:
        return 0

    def grp(m):
        t = m[:h32 * 4, :w32 * 4]
        t = t.reshape(h32, 4, w32, 4, *m.shape[2:])
        return np.moveaxis(t, 1, 2).reshape(h32, w32, 16, *m.shape[2:])

    elig = (grp(dec.cu_log2_map) == 4).all(axis=2)
    if dec.inter8 is not None:
        elig &= ~grp(dec.inter8.astype(bool)).any(axis=2)
    # fully inside (partial edge groups keep the finer tree)
    ys32 = np.arange(h32) * 32
    xs32 = np.arange(w32) * 32
    elig &= ((ys32[:, None] + 32) <= p.height) \
        & ((xs32[None, :] + 32) <= p.width)
    if not elig.any():
        return 0
    ys, xs = np.nonzero(elig)
    G = len(ys)
    # z-order sub modes from the 8-block corners of each 16 sub-CU
    modes = grp(dec.luma_mode8)
    sub = np.array([0, 2, 8, 10])
    m4 = modes[ys, xs][:, sub].astype(np.int32)           # [G,4]
    mbits4 = _mode_bits(m4).sum(axis=1).astype(np.float32)

    # FIXED batch shape (the full 32-grid) — a varying G would recompile
    # the fused graph every frame (models/rdo.py discipline)
    NB = max(32, -(-(h32 * w32) // 32) * 32)
    pad_n = NB - G

    def padn(a, fill=0):
        return np.concatenate(
            [a, np.full((pad_n,) + a.shape[1:], fill, a.dtype)]) \
            if pad_n else a

    xy = np.stack([xs * 32, ys * 32], 1).astype(np.int32)
    from jax import enable_x64
    from x265_tpu.hevc.rate_model import rdoq_rate_consts
    with enable_x64():
        from x265_tpu.utils import devcache
        c1, mode1, c4 = _intra32_costs(
            devcache.src_plane(np.asarray(frame[0]), p.bit_depth),
            devcache.src_plane(np.asarray(frame[1]), p.bit_depth),
            devcache.src_plane(np.asarray(frame[2]), p.bit_depth),
            jnp.asarray(padn(xy)),
            jnp.asarray(padn(m4, 1)),
            jnp.asarray(padn(mbits4, 1.0)),
            jnp.asarray(padn(np.full(G, int(qp), np.int32), 26)),
            jnp.asarray(rdoq_rate_consts(init_type, int(qp))),
            bd=p.bit_depth, sdh=bool(p.sign_hide),
            do_rdoq=p.rdoq_level > 0, scaling=bool(p.scaling_lists),
            cb_off=int(p.cb_qp_offset), cr_off=int(p.cr_qp_offset),
            psy=round(float(getattr(p, "psy_rd", 0.0)), 2))
    c1 = np.asarray(c1)[:G]
    c4 = np.asarray(c4)[:G]
    mode1 = np.asarray(mode1)[:G]
    promote = c1 <= c4
    n = int(promote.sum())
    if n < min_groups:
        return 0
    for gy, gx, m in zip(ys[promote], xs[promote], mode1[promote]):
        dec.cu_log2_map[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = 5
        dec.luma_mode8[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = int(m)
        if dec.chroma_mode8 is not None:
            dec.chroma_mode8[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = int(m)
        if getattr(dec, "nxn8", None) is not None:
            dec.nxn8[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = False
    return n
