"""Recon-in-the-loop RD evaluation for quadtree promotions.

x265 analog: Analysis::compressInterCU_rd0_4's bottom-up merge
(analysis.cpp:1146) — each candidate CU size is coded (predict,
transform, quantize, reconstruct), its distortion measured against the
source and its rate estimated, and the cheaper tree wins. Re-imagined
as batched work: every candidate 32x32 group in the frame is evaluated in ONE
batched dispatch.

Unlike a same-motion-only merge, the 32-CU candidate is coded at a
UNIFIED motion vector (the group's modal MV) while the four 16-CU
candidates keep their own refined MVs — the exact trade recursive RDO
makes on panning content, where per-block quarter-pel refinement leaves
a field of almost-equal MVs whose AMVP syntax costs more than the tiny
SATD it buys (x265 wins this via checkMerge2Nx2N at every depth).

Cost domain matches the RDOQ fixed-point model: 32*SSE +
RDOQ_LAM32[qp] * (rate_bins + per-CU header bits), so promotion
decisions are consistent with the quantizer's own RD arithmetic.

Costs cover all three planes: a luma-only model systematically
over-adopts unified motion wherever the chroma misprediction it cannot
see would generate chroma residual (measurably worse BD at high QP).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from x265_tpu.hevc.tables import (CHROMA_QP_TABLE, RDOQ_LAM32,
                                  RDOQ_LAM32_FULL)
from x265_tpu.models.residual import _tq_chain
from x265_tpu.models.inter_residual import (_mc_gather, _CHROMA_FILT,
                                            _LUMA_FILT)

# CU-level syntax estimates (static bin-count scale): a merge/skip CU
# header, and the extra AMVP cost of a sub-CU whose MV differs from the
# group's unified motion (ref idx + mvp idx + mvd exp-golomb)
CU_OH_BITS = 6
AMVP_EXTRA_BITS = 10


def _rate_bins_j(l: jnp.ndarray) -> jnp.ndarray:
    """The RDOQ static bin-count rate model (ops.ref.transform.rate_bins)
    in jnp, int32."""
    a = jnp.abs(l).astype(jnp.int32)
    r = jnp.where(a > 0, 3, 1)
    lg = jnp.zeros_like(a)
    for k in range(1, 16):
        lg = lg + (a >= (1 << k)).astype(jnp.int32)
    return r + jnp.where(a > 1, 2 + 2 * lg, 0)


def _tb_rate_bits_j(lvl: jnp.ndarray, kk: jnp.ndarray) -> jnp.ndarray:
    """TB rate in BITS under the estBit fractional-bit model
    (hevc/rate_model.py) with coded_sub_block_flag structure — the
    x265-entropy-shaped replacement for `sum(_rate_bins_j)`.

    The static bin model charges >=1 bin for EVERY position of a TB
    whose cbf is set, so a mostly-zero 32x32 TB pays ~1024 bins while
    four all-zero 16x16 TBs pay 0 — systematically blocking quadtree
    promotion to larger CUs/TBs (the real coder prices a zero 4x4 CG at
    one csbf bin and skips CGs past the last significant one entirely,
    entropy.cpp codeCoeffNxN).  Model per TB: significant CGs pay
    csbf(1) + 16 estBit coefficient costs; zero CGs before the last
    significant CG (raster approximation of the scan) pay csbf(0); CGs
    after it pay nothing; plus a last-position prefix estimate.

    lvl [N,S,S] int; kk [8] int32 consts row (rdoq_rate_consts).
    Returns [N] float32 bits (caller still gates on cbf)."""
    from x265_tpu.hevc.rate_model import CG0, CG1, rate_bits_j
    S = lvl.shape[-1]
    lastpos = 2.0 * (float(np.log2(S)) + 1.0)
    if S == 4:
        return rate_bits_j(lvl, kk).sum(axis=(1, 2)) + lastpos
    nc = S // 4
    cg = (lvl.reshape(-1, nc, 4, nc, 4).transpose(0, 1, 3, 2, 4)
          .reshape(-1, nc * nc, 16))
    per = rate_bits_j(cg, kk).sum(axis=2)                # [N, nCG]
    nz = (cg != 0).any(axis=2)
    idx = jnp.arange(nc * nc, dtype=jnp.int32)
    last = jnp.max(jnp.where(nz, idx[None, :], -1), axis=1)
    active = idx[None, :] <= last[:, None]
    csbf0 = kk[CG0].astype(jnp.float32) / 32768.0
    csbf1 = kk[CG1].astype(jnp.float32) / 32768.0
    r = jnp.where(nz, csbf1 + per,
                  jnp.where(active, csbf0, 0.0)).sum(axis=1)
    return r + lastpos


def _psy_energy8(blocks: jnp.ndarray) -> jnp.ndarray:
    """Per-8x8 AC energy of pixel blocks (x265 pixel.cpp:727 psyCost_pp):
    sa8d against zero (sum |H8 b H8^T| / 4) minus the DC term
    (sum(pixels) >> 2). blocks [N, S, S] int32 -> [N, S/8 * S/8] int32."""
    from x265_tpu.engine.me import _H8
    N, S, _ = blocks.shape
    b = blocks.reshape(N, S // 8, 8, S // 8, 8)
    b = b.transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8)
    h = jnp.asarray(_H8)
    t = jnp.einsum("ij,njk,lk->nil", h, b, h)
    sa8d = jnp.abs(t).sum(axis=(1, 2)) // 4
    dc = b.sum(axis=(1, 2)) >> 2
    return (sa8d - dc).reshape(N, -1)


def _psy_cost(src, recon):
    """Summed |AC-energy(src) - AC-energy(recon)| over the 8x8 tiling of
    [N, S, S] blocks (abs at 8x8 granularity, as in psyCost_pp)."""
    return jnp.abs(_psy_energy8(src) - _psy_energy8(recon)) \
        .sum(axis=1).astype(jnp.float32)


def _chroma_qp_vec(qp, bd, off):
    """Qp'C for a traced QP vector (8.6.1 via table + offset)."""
    bdo = 6 * (bd - 8)
    q = jnp.clip(qp + off, -bdo, 57)
    tab = jnp.asarray(np.asarray(CHROMA_QP_TABLE, np.int32))
    return jnp.where(q < 0, q + bdo, tab[jnp.maximum(q, 0)] + bdo)


@partial(jax.jit, static_argnames=("n", "bd", "sdh", "do_rdoq", "scaling",
                                   "pad", "cb_off", "cr_off", "psy"))
def _promo_costs(src_y, src_cb, src_cr, r0y, r0cb, r0cr,
                 r1y, r1cb, r1cr, xy, mv4, mv1, dirm, ref_i, qp,
                 oh_one, oh_four, rk,
                 n, bd, sdh, do_rdoq, scaling, pad, cb_off, cr_off,
                 psy=0.0):
    """RD costs of G candidate n x n regions:
    ONE n-CU at the unified motion mv1 vs FOUR (n/2)-CUs at their own
    motions mv4.

    src_y [H,W] int32; r0y/r1y [R,Hp,Wp] padded int16 ref stacks;
    xy [G,2] (x0,y0); mv4 [G,4,2,2] qpel per z-order sub-block;
    mv1 [G,2,2]; dirm [G] 1/2/3; ref_i [G] L0 idx; qp [G];
    oh_one/oh_four [G] header-bit estimates.
    Returns (cost_one [G], cost_four [G]) float32.
    """
    G = xy.shape[0]
    m = n // 2
    x0, y0 = xy[:, 0], xy[:, 1]
    maxv = (1 << bd) - 1
    lfilt = jnp.asarray(_LUMA_FILT)
    cfilt = jnp.asarray(_CHROMA_FILT)
    use0_g = (dirm & 1) > 0

    def pred_at(x, y, mv, size, pl, use0, dirv, refv):
        """Motion-compensated prediction for plane pl (0=Y, 1=Cb,
        2=Cr); chroma runs at half geometry with the 4-tap filters and
        eighth-pel phases (8.5.4.2.2)."""
        if pl == 0:
            planes0, planes1 = r0y, r1y
            filt, fb, taps, pd = lfilt, 2, 8, pad
        else:
            planes0 = r0cb if pl == 1 else r0cr
            planes1 = r1cb if pl == 1 else r1cr
            filt, fb, taps, pd = cfilt, 3, 4, pad >> 1
            x, y, size = x >> 1, y >> 1, size // 2
        p0 = _mc_gather(planes0, jnp.where(use0, refv, 0), x, y,
                        mv[:, 0, 0], mv[:, 0, 1], filt, fb, size, taps,
                        pd, bd)
        p1 = _mc_gather(planes1, jnp.zeros_like(refv), x, y,
                        mv[:, 1, 0], mv[:, 1, 1], filt, fb, size, taps,
                        pd, bd)
        sh_bi = 15 - bd
        bi = jnp.clip((p0 + p1 + (1 << (sh_bi - 1))) >> sh_bi, 0, maxv)
        p14 = jnp.where(use0[:, None, None], p0, p1)
        sh_u = 14 - bd
        uni = jnp.clip((p14 + (1 << (sh_u - 1))) >> sh_u, 0, maxv)
        return jnp.where((dirv == 3)[:, None, None], bi, uni)

    def blks(plane, xv, yv, size):
        from x265_tpu.models.inter_residual import gather_src_blocks
        return gather_src_blocks(plane, yv, xv, size)

    src = blks(src_y, x0, y0, n)
    qpy = qp + 6 * (bd - 8)
    # estBit rates are real bits -> full lambda2 (rate_model.py)
    lam = jnp.asarray(np.asarray(RDOQ_LAM32_FULL),
                      jnp.int64)[qpy].astype(jnp.float32)

    # psy-rd lambda: cost domain is 32*SSE, so the sqrt-lambda psy term
    # (rdcost.h calcPsyRdCost: dist + sqrt_lam*psyRd*energyDiff) scales
    # as 32*sqrt(lam/32) = sqrt(32*lam)
    psylam = jnp.sqrt(32.0 * lam) * psy

    def cfg_cost(r, pred, qvec, size, want_psy, krow):
        # TBs larger than 32 ride the implicit RQT split (7.3.8.8):
        # transform in 32x32 quads, aggregate the costs back per region
        if size > 32:
            gq = r.shape[0]
            h = size // 2

            def quads(a):
                return (a.reshape(gq, 2, h, 2, h).transpose(0, 1, 3, 2, 4)
                        .reshape(gq * 4, h, h))
            sse, rate, pc = cfg_cost(quads(r), quads(pred),
                                     jnp.repeat(qvec, 4), h, want_psy,
                                     krow)
            return (sse.reshape(gq, 4).sum(axis=1),
                    rate.reshape(gq, 4).sum(axis=1),
                    pc.reshape(gq, 4).sum(axis=1))
        lvl, rres, cbf = _tq_chain(
            r, qvec, jnp.zeros((r.shape[0],), jnp.int32),
            size, False, False, bd, sdh, do_rdoq, False, scaling)
        e = (r - rres).astype(jnp.float32)
        sse = (e * e).sum(axis=(1, 2))
        rate = jnp.where(cbf, _tb_rate_bits_j(lvl, krow), 0.0)
        if want_psy:
            maxv_ = (1 << bd) - 1
            pc = _psy_cost(pred + r, jnp.clip(pred + rres, 0, maxv_))
        else:
            pc = jnp.zeros_like(sse)
        return sse, rate.astype(jnp.float32), pc

    qpc_cb = _chroma_qp_vec(qp, bd, cb_off) + 6 * (bd - 8)
    qpc_cr = _chroma_qp_vec(qp, bd, cr_off) + 6 * (bd - 8)

    def plane_cost(pl, xv, yv, mv, size, use0, dirv, refv, qv):
        sp = (src_y, src_cb, src_cr)[pl]
        xs, ys, sz = ((xv, yv, size) if pl == 0
                      else (xv >> 1, yv >> 1, size // 2))
        srcp = blks(sp, xs, ys, sz)
        pred = pred_at(xv, yv, mv, size, pl, use0, dirv, refv)
        # psy energy is a luma-plane cost (pixel.cpp psyCost_pp usage)
        return cfg_cost(srcp - pred, pred, qv, sz, psy > 0 and pl == 0,
                        rk[min(pl, 1)])

    # --- one n-CU at the unified motion ---
    sse1, rate1, psy1 = plane_cost(0, x0, y0, mv1, n, use0_g, dirm,
                                   ref_i, qpy)
    for pl, qv in ((1, qpc_cb), (2, qpc_cr)):
        sc, rc, _pc = plane_cost(pl, x0, y0, mv1, n, use0_g, dirm, ref_i,
                                 qv)
        sse1 = sse1 + sc
        rate1 = rate1 + rc
    cost_one = 32.0 * sse1 + lam * (rate1 + oh_one) + psylam * psy1

    # --- four (n/2)-CUs at their own motions ---
    # z-order sub-block q: (dy, dx) = (q // 2, q % 2)
    qq = jnp.arange(4, dtype=jnp.int32)   # int32 under enable_x64 too
    x4 = (x0[:, None] + (qq % 2)[None, :] * m).reshape(-1)
    y4 = (y0[:, None] + (qq // 2)[None, :] * m).reshape(-1)
    mv4f = mv4.reshape(G * 4, 2, 2)
    # per-sub dir/ref follow the group (eligibility requires same dir/ref)
    use0_4 = jnp.repeat(use0_g, 4)
    dirm_4 = jnp.repeat(dirm, 4)
    ref_4 = jnp.repeat(ref_i, 4)
    sse4, rate4, psy4 = plane_cost(0, x4, y4, mv4f, m, use0_4, dirm_4,
                                   ref_4, jnp.repeat(qpy, 4))
    for pl, qv in ((1, qpc_cb), (2, qpc_cr)):
        sc, rc, _pc = plane_cost(pl, x4, y4, mv4f, m, use0_4, dirm_4,
                                 ref_4, jnp.repeat(qv, 4))
        sse4 = sse4 + sc
        rate4 = rate4 + rc
    sse4 = sse4.reshape(G, 4).sum(axis=1)
    rate4 = rate4.reshape(G, 4).sum(axis=1)
    psy4 = psy4.reshape(G, 4).sum(axis=1)
    cost_four = 32.0 * sse4 + lam * (rate4 + oh_four) + psylam * psy4
    return cost_one, cost_four


def _plane_stacks(src_yuv, refs0_padded, refs1_padded, p, pad):
    """Device stacks for the RD dispatches: (src_y, src_cb, src_cr) and
    [r, Hp, Wp] per-plane reference stacks for each list. refs*_padded:
    lists of (y, cb, cr) edge-padded planes (pad luma, pad/2 chroma)."""
    from x265_tpu.utils import devcache

    def stack(lst, pl):
        from x265_tpu.engine.planes import FramePlanes
        if not lst:
            sh_ = ((p.height + 2 * pad, p.width + 2 * pad) if pl == 0
                   else (p.height // 2 + pad, p.width // 2 + pad))
            return devcache.get_or(("rdz", pl, sh_), _plane_stacks,
                                   lambda: jnp.zeros((1,) + sh_,
                                                     jnp.int16))

        def dev_plane(r):
            if isinstance(r, FramePlanes):
                # device-resident anchor: padded on device, no wire
                return r.dev_padded(pad)[pl]
            return jnp.asarray(r[pl])

        # identity-keyed: anchors serve several frames and the three RD
        # dispatches per frame reuse one upload instead of three
        key = ("rdstack", pl) + tuple(id(r) for r in lst)
        return devcache.get_or(
            key, lst[0],
            lambda: jnp.stack([dev_plane(r) for r in lst]))

    # thin-wire cached source planes (the jitted bodies gather + upcast)
    srcs = tuple(devcache.src_plane(np.asarray(pl_arr), p.bit_depth)
                 for pl_arr in src_yuv)
    r0s = tuple(stack(refs0_padded, pl) for pl in range(3))
    r1s = tuple(stack(refs1_padded, pl) for pl in range(3))
    return srcs, r0s, r1s


def rd_promote(src_yuv, refs0_padded, refs1_padded, cand_yx, mv4, dirm,
               ref_i, qp, p, n=32, mesh=None, mv_bias=None,
               bias_dir=None):
    """Decide per candidate group whether one n x n CU at the group's
    modal motion beats four (n/2)-CUs at their own motions.

    cand_yx [G,2] (yn, xn) indices on the n-grid; mv4 [G,4,2,2]
    z-order sub-block motions; dirm/ref_i [G]. Returns (promote [G]
    bool, mv_uni [G,2,2]). Batches pad to the full n-grid so the
    jitted shape never varies frame-to-frame."""
    from jax import enable_x64
    hn = p.height // n
    wn = p.width // n
    G = len(cand_yx)
    NB = max(32, -(-(hn * wn) // 32) * 32)
    pad_n = NB - G

    # unified candidate: the modal MV among the 4 sub-blocks (the member
    # minimizing summed L1 distance to the others — ties break low)
    d = np.abs(mv4[:, :, None] - mv4[:, None, :]).sum(axis=(3, 4))
    modal = d.sum(axis=2).argmin(axis=1)
    mv_uni = mv4[np.arange(G), modal]
    if mv_bias is not None:
        # bias toward the FRAME-dominant motion when the group's modal
        # is within a pel of it: adjacent groups then unify to the SAME
        # exact MV and the writer's merge/skip chains span group
        # boundaries (independent per-group modals break the chains
        # and every promoted CU pays AMVP syntax)
        near = (np.abs(mv_uni - mv_bias[None]).max(axis=(1, 2)) <= 4)
        if bias_dir is not None:
            near &= dirm == bias_dir
        mv_uni = np.where(near[:, None, None], mv_bias[None], mv_uni)

    # header estimates: the unified CU merges with its uniform
    # neighborhood (~CU_OH_BITS); each sub-CU pays a header plus AMVP
    # syntax when its MV differs from the unified one
    differs = (mv4 != mv_uni[:, None]).any(axis=(2, 3))
    oh_one = np.full(G, CU_OH_BITS, np.float32)
    oh_four = (4 * CU_OH_BITS
               + AMVP_EXTRA_BITS * differs.sum(axis=1)).astype(np.float32)

    def padn(a, fill=0):
        return np.concatenate(
            [a, np.full((pad_n,) + a.shape[1:], fill, a.dtype)]) \
            if pad_n else a

    from x265_tpu.hevc.rate_model import rdoq_rate_consts
    xy = np.stack([cand_yx[:, 1] * n, cand_yx[:, 0] * n], 1)
    args = (jnp.asarray(padn(xy.astype(np.int32))),
            jnp.asarray(padn(mv4.astype(np.int32))),
            jnp.asarray(padn(mv_uni.astype(np.int32))),
            jnp.asarray(padn(dirm.astype(np.int32), 1)),
            jnp.asarray(padn(ref_i.astype(np.int32))),
            jnp.asarray(padn(np.full(G, qp, np.int32), 26)),
            jnp.asarray(padn(oh_one)),
            jnp.asarray(padn(oh_four, 1.0)),
            jnp.asarray(rdoq_rate_consts(2, int(qp))))

    pad = 80
    srcs, r0s, r1s = _plane_stacks(src_yuv, refs0_padded, refs1_padded,
                                   p, pad)
    with enable_x64():
        c1, c4 = _promo_costs(
            *srcs, *r0s, *r1s, *args,
            n=n, bd=p.bit_depth, sdh=bool(p.sign_hide),
            do_rdoq=p.rdoq_level > 0, scaling=bool(p.scaling_lists),
            pad=pad, cb_off=int(p.cb_qp_offset),
            cr_off=int(p.cr_qp_offset),
            psy=round(float(getattr(p, "psy_rd", 0.0)), 2))
    c1 = np.asarray(c1)[:G]
    c4 = np.asarray(c4)[:G]
    return c1 <= c4, mv_uni


def rd_promote32(*args, **kw):
    return rd_promote(*args, n=32, **kw)


@partial(jax.jit, static_argnames=("bd", "sdh", "do_rdoq", "scaling",
                                   "pad", "k", "cb_off", "cr_off", "psy"))
def _adopt_costs(src_y, src_cb, src_cr, r0y, r0cb, r0cr,
                 r1y, r1cb, r1cr, xy, mv_all, dir_all, ref_all, qp,
                 hdr_all, rk, k, bd, sdh, do_rdoq, scaling, pad,
                 cb_off, cr_off, psy=0.0):
    """RD cost of coding every 16x16 block under each of k motion
    configurations (config 0 = the block's own refined motion, 1..k-1 =
    frame-dominant candidate tuples): 32*SSE(recon) + lam*(rate + hdr),
    summed over all three planes.

    xy [N,2]; mv_all [k*N,2,2]; dir_all/ref_all [k*N]; qp [N];
    hdr_all [k] header-bit estimates per config. Returns cost [k, N].
    """
    N = xy.shape[0]
    x0 = jnp.tile(xy[:, 0], k)
    y0 = jnp.tile(xy[:, 1], k)
    maxv = (1 << bd) - 1
    lfilt = jnp.asarray(_LUMA_FILT)
    cfilt = jnp.asarray(_CHROMA_FILT)
    use0 = (dir_all & 1) > 0
    qpy = jnp.tile(qp + 6 * (bd - 8), k)
    qpc_cb = jnp.tile(_chroma_qp_vec(qp, bd, cb_off) + 6 * (bd - 8), k)
    qpc_cr = jnp.tile(_chroma_qp_vec(qp, bd, cr_off) + 6 * (bd - 8), k)

    def plane_cost(pl, qv):
        if pl == 0:
            planes0, planes1, sp = r0y, r1y, src_y
            filt, fb, taps, pd, sz = lfilt, 2, 8, pad, 16
            xs, ys = x0, y0
        else:
            planes0 = r0cb if pl == 1 else r0cr
            planes1 = r1cb if pl == 1 else r1cr
            sp = src_cb if pl == 1 else src_cr
            filt, fb, taps, pd, sz = cfilt, 3, 4, pad >> 1, 8
            xs, ys = x0 >> 1, y0 >> 1
        p0 = _mc_gather(planes0, jnp.where(use0, ref_all, 0), xs, ys,
                        mv_all[:, 0, 0], mv_all[:, 0, 1], filt, fb, sz,
                        taps, pd, bd)
        p1 = _mc_gather(planes1, jnp.zeros_like(ref_all), xs, ys,
                        mv_all[:, 1, 0], mv_all[:, 1, 1], filt, fb, sz,
                        taps, pd, bd)
        sh_bi = 15 - bd
        bi = jnp.clip((p0 + p1 + (1 << (sh_bi - 1))) >> sh_bi, 0, maxv)
        p14 = jnp.where(use0[:, None, None], p0, p1)
        sh_u = 14 - bd
        uni = jnp.clip((p14 + (1 << (sh_u - 1))) >> sh_u, 0, maxv)
        pred = jnp.where((dir_all == 3)[:, None, None], bi, uni)

        from x265_tpu.models.inter_residual import gather_src_blocks
        src = gather_src_blocks(sp, ys, xs, sz)
        resi = src - pred
        lvl, rres, cbf = _tq_chain(
            resi, qv, jnp.zeros((k * N,), jnp.int32),
            sz, False, False, bd, sdh, do_rdoq, False, scaling)
        e = (resi - rres).astype(jnp.float32)
        sse = (e * e).sum(axis=(1, 2))
        rate = jnp.where(cbf, _tb_rate_bits_j(lvl, rk[min(pl, 1)]), 0.0)
        if psy > 0 and pl == 0:
            pc = _psy_cost(src, jnp.clip(pred + rres, 0, maxv))
        else:
            pc = jnp.zeros_like(sse)
        return sse, rate.astype(jnp.float32), pc

    sse, rate, psyc = plane_cost(0, qpy)
    for pl, qv in ((1, qpc_cb), (2, qpc_cr)):
        sc, rc, _pc = plane_cost(pl, qv)
        sse = sse + sc
        rate = rate + rc
    # estBit rates are real bits -> full lambda2 (rate_model.py)
    lam = jnp.asarray(np.asarray(RDOQ_LAM32_FULL),
                      jnp.int64)[qpy].astype(jnp.float32)
    hdr = jnp.repeat(jnp.asarray(hdr_all, jnp.float32), N)
    cost = (32.0 * sse + lam * (rate + hdr)
            + jnp.sqrt(32.0 * lam) * psy * psyc)
    return cost.reshape(k, N)


# header-bit estimates for the adoption configs (static bin scale):
# a block keeping its own motion pays AMVP syntax (mvp idx + mvd +
# ref idx); a block adopting a frame-dominant tuple codes merge/skip
OWN_HDR_BITS = 14.0
CAND_HDR_BITS = 5.0


def rd_adopt16(src_yuv, refs0_padded, refs1_padded, inter_blk, mv_blk,
               dir_blk, ref_blk, cands, qp, p, mesh=None):
    """Recon-in-the-loop merge adoption (x265 checkMerge2Nx2N with real
    RD, analysis.cpp:1914): every inter 16x16 block is coded under its
    own motion AND each frame-dominant candidate tuple; the cheapest
    configuration wins. Zero-residual blocks whose refined MV matches
    no merge candidate stop paying AMVP headers for nothing.

    Returns updated (dir_blk, mv_blk, ref_blk, adopted_mask)."""
    from jax import enable_x64
    nby, nbx = dir_blk.shape
    N = nby * nbx
    K = 4                                  # fixed -> stable trace shape
    cands = list(cands)[:K]
    while len(cands) < K:
        cands.append(cands[-1])
    by, bx = np.meshgrid(np.arange(nby), np.arange(nbx), indexing="ij")
    xy = np.stack([bx.reshape(-1) * 16, by.reshape(-1) * 16],
                  1).astype(np.int32)
    mv_own = mv_blk.reshape(N, 2, 2).astype(np.int32)
    dir_own = dir_blk.reshape(N).astype(np.int32)
    ref_own = ref_blk.reshape(N).astype(np.int32)
    mv_all = [mv_own]
    dir_all = [dir_own]
    ref_all = [ref_own]
    for (dd, r0_, _r1, m0, m1) in cands:
        mvc = np.zeros((N, 2, 2), np.int32)
        mvc[:, 0] = m0
        mvc[:, 1] = m1
        mv_all.append(mvc)
        dir_all.append(np.full(N, dd, np.int32))
        ref_all.append(np.full(N, r0_, np.int32))
    hdr = np.array([OWN_HDR_BITS] + [CAND_HDR_BITS] * K, np.float32)

    from x265_tpu.hevc.rate_model import rdoq_rate_consts
    pad = 80
    srcs, r0s, r1s = _plane_stacks(src_yuv, refs0_padded, refs1_padded,
                                   p, pad)
    with enable_x64():
        cost = _adopt_costs(
            *srcs, *r0s, *r1s,
            jnp.asarray(xy),
            jnp.asarray(np.concatenate(mv_all)),
            jnp.asarray(np.concatenate(dir_all)),
            jnp.asarray(np.concatenate(ref_all)),
            jnp.asarray(np.full(N, qp, np.int32)),
            jnp.asarray(hdr),
            jnp.asarray(rdoq_rate_consts(2, int(qp))), k=K + 1,
            bd=p.bit_depth,
            sdh=bool(p.sign_hide), do_rdoq=p.rdoq_level > 0,
            scaling=bool(p.scaling_lists), pad=pad,
            cb_off=int(p.cb_qp_offset), cr_off=int(p.cr_qp_offset),
            psy=round(float(getattr(p, "psy_rd", 0.0)), 2))
    cost = np.asarray(cost)                        # [K+1, N]
    choice = cost.argmin(axis=0).reshape(nby, nbx)
    choice = np.where(inter_blk, choice, 0)
    adopted = choice > 0
    if not adopted.any():
        return dir_blk, mv_blk, ref_blk, adopted
    carr = np.array([[dd, r0_, m0[0], m0[1], m1[0], m1[1]]
                     for (dd, r0_, _r1, m0, m1) in cands], np.int32)
    ci = np.clip(choice - 1, 0, K - 1)
    sel = carr[ci]                                 # [nby,nbx,6]
    dir_out = np.where(adopted, sel[..., 0], dir_blk).astype(np.int32)
    ref_out = np.where(adopted, sel[..., 1], ref_blk).astype(np.int32)
    mv_out = mv_blk.copy()
    mv_out[adopted, 0, 0] = sel[adopted, 2]
    mv_out[adopted, 0, 1] = sel[adopted, 3]
    mv_out[adopted, 1, 0] = sel[adopted, 4]
    mv_out[adopted, 1, 1] = sel[adopted, 5]
    return dir_out, mv_out, ref_out, adopted
