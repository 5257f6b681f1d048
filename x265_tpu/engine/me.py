"""Batched device motion estimation — the re-imagining of x265's serial
MotionEstimate::motionEstimate loop (reference motion.cpp:739, subpel
refine motion.cpp:624 area; SURVEY §3.6) as dense frame-level computation:

- integer full search: every block's whole (2R+1)^2 window evaluated as a
  lax.scan over displacements of shifted-frame SAD reductions (the
  sad_x4/ads primitive family becomes one fused displacement sweep), with
  a lambda*mvbits penalty per displacement;
- subpel: 16 quarter-pel phase planes built once per frame by separable
  8-tap interpolation (the ipfilter family as convolutions), then
  half->quarter refinement rounds evaluate 8 neighbor candidates per block
  with batched SATD (Hadamard via matmuls) + mv cost.

MV cost model: quarter-pel exp-Golomb-ish bit estimate against a (0,0)
predictor (x265 uses the real MVP via its BitCost LUTs, bitcost.h).
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from x265_tpu.ops.ref.interp import LUMA_FILTERS

# 8x8 Hadamard matrix for SATD
_H8 = np.array([[1, 1, 1, 1, 1, 1, 1, 1],
                [1, -1, 1, -1, 1, -1, 1, -1],
                [1, 1, -1, -1, 1, 1, -1, -1],
                [1, -1, -1, 1, 1, -1, -1, 1],
                [1, 1, 1, 1, -1, -1, -1, -1],
                [1, -1, 1, -1, -1, 1, -1, 1],
                [1, 1, -1, -1, -1, -1, 1, 1],
                [1, -1, -1, 1, -1, 1, 1, -1]], dtype=np.int32)


def _mv_bits(v: np.ndarray) -> np.ndarray:
    """~exp-Golomb bit count of a quarter-pel mv component."""
    a = np.abs(v).astype(np.int64)
    return (2 * np.floor(np.log2(2 * a + 1)) + 1).astype(np.float32)


def satd8_batched(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """SATD over [N, S, S] blocks (S multiple of 8) -> [N] (sa8d-style:
    sum |H8 D H8^T| / 4 per 8x8 sub-block; x265 pixel.cpp sa8d)."""
    N, S, _ = a.shape
    d = (a - b).reshape(N, S // 8, 8, S // 8, 8)
    d = d.transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8).astype(jnp.int32)
    h = jnp.asarray(_H8)
    t = jnp.einsum("ij,njk,lk->nil", h, d, h)
    s = jnp.abs(t).sum(axis=(1, 2)) // 4
    return s.reshape(N, -1).sum(axis=1)


@partial(jax.jit, static_argnames=("S", "R"))
def _int_search(cur, ref_pad, mvcost, S, R):
    """Integer full search. cur [H,W], ref_pad [H+2R, W+2R], mvcost [D]
    -> (best_idx [nby,nbx], best_cost, best_sad)."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    n = 2 * R + 1
    cur = cur.astype(jnp.int32)          # narrow wire, upcast on device
    ref_pad = ref_pad.astype(jnp.int32)

    def body(carry, d):
        best_cost, best_idx, best_sad = carry
        dy = d // n
        dx = d % n
        sh = jax.lax.dynamic_slice(ref_pad, (dy, dx), (H, W))
        sad = jnp.abs(cur - sh).reshape(nby, S, nbx, S).sum(axis=(1, 3))
        cost = sad.astype(jnp.float32) + mvcost[d]
        upd = cost < best_cost
        return ((jnp.where(upd, cost, best_cost),
                 jnp.where(upd, d, best_idx),
                 jnp.where(upd, sad, best_sad)), None)

    init = (jnp.full((nby, nbx), jnp.inf, jnp.float32),
            jnp.zeros((nby, nbx), jnp.int32),
            jnp.zeros((nby, nbx), jnp.int32))
    (cost, idx, sad), _ = jax.lax.scan(body, init, jnp.arange(n * n))
    return idx, cost, sad


@jax.jit
def _downscale2(y: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean downscale (the frameInitLowres analog used by HME)."""
    H, W = y.shape
    y = y.astype(jnp.int32)
    return (y.reshape(H // 2, 2, W // 2, 2).sum(axis=(1, 3)) + 2) >> 2


@partial(jax.jit, static_argnames=("S", "W_r", "pad"))
def _local_search(cur_blocks, ref_pad, centers, bxy, lam, S, W_r, pad):
    """Per-block integer window search around given centers.

    cur_blocks [N,S,S]; ref_pad [H+2*pad, W+2*pad] edge-padded; centers
    [N,2] integer MVs with |center| <= pad - W_r; bxy [N,2] block (x,y)
    indices. Evaluates all (2W_r+1)^2 displacements around each center
    (the x265 refineMV/star-refine analog, motion.cpp:624)
    -> (mv [N,2], cost [N]).
    """
    N = cur_blocks.shape[0]
    cur_blocks = cur_blocks.astype(jnp.int32)
    ref_pad = ref_pad.astype(jnp.int32)
    side = S + 2 * W_r

    # top-left of every search patch in padded coords; fetched as one
    # batched tile gather
    from x265_tpu.models.inter_residual import gather_src_blocks
    y0s = bxy[:, 1] * S + centers[:, 1] + pad - W_r
    x0s = bxy[:, 0] * S + centers[:, 0] + pad - W_r
    patches = gather_src_blocks(ref_pad, y0s, x0s, side)  # [N, side, side]
    n = 2 * W_r + 1

    def body(carry, d):
        best_cost, best_d = carry
        dy = d // n
        dx = d % n
        cand = jax.lax.dynamic_slice(patches, (0, dy, dx), (N, S, S))
        sad = jnp.abs(cur_blocks - cand).sum(axis=(1, 2))
        mv = centers + jnp.stack([dx - W_r, dy - W_r])[None, :]
        bits = (2 * jnp.floor(jnp.log2(
            2 * jnp.abs(4 * mv).astype(jnp.float32) + 1)) + 1).sum(axis=1)
        cost = sad.astype(jnp.float32) + lam * bits
        upd = cost < best_cost
        return ((jnp.where(upd, cost, best_cost),
                 jnp.where(upd, d, best_d)), None)

    init = (jnp.full((N,), jnp.inf, jnp.float32), jnp.zeros((N,), jnp.int32))
    (cost, bd), _ = jax.lax.scan(body, init, jnp.arange(n * n))
    mv = centers + jnp.stack([bd % n - W_r, bd // n - W_r], axis=-1)
    return mv, cost


@partial(jax.jit, static_argnames=("maxv",))
def _phase_planes(ref_pad: jnp.ndarray, maxv: int = 255) -> jnp.ndarray:
    """[4,4,H+2m,W+2m] pixel-domain quarter-pel planes from a reference
    edge-padded by (m+3) left/top and (m+4) right/bottom, so that plane
    index i maps to integer position i-m (the 8-tap base sample is tap 3)."""
    f = jnp.asarray(LUMA_FILTERS)          # [4, 8]
    ref_pad = ref_pad.astype(jnp.int32)    # narrow wire, upcast on device
    Hp, Wp = ref_pad.shape

    # horizontal: out[p, y, x] = sum_t f[p,t] * ref[y, x+t-3], valid range
    W_out = Wp - 7
    cols = jnp.stack([ref_pad[:, t:t + W_out] for t in range(8)], axis=-1)
    hor = jnp.einsum("ywt,pt->pyw", cols, f)              # [4, Hp, W_out]
    # vertical on hor
    H_out = Hp - 7
    rows = jnp.stack([hor[:, t:t + H_out, :] for t in range(8)], axis=-1)
    out = jnp.einsum("pyxt,qt->qpyx", rows, f)            # [4(v),4(h),H,W]
    out = (out + 2048) >> 12                              # /64/64 rounded
    # int16 storage: values are clipped pixels; quarters the HBM traffic
    # the subpel gathers pay
    return jnp.clip(out, 0, maxv).astype(jnp.int16)


def _gather_phase_blocks(planes, fy, fx, iy, ix, S):
    """[N, S, S] i32 blocks from [4,4,Hm,Wm] phase planes at per-lane
    (phase, position) — dynamic_slice clamp semantics."""
    N = fy.shape[0]

    def one(i):
        blk = jax.lax.dynamic_slice(
            planes, (fy[i], fx[i], iy[i], ix[i]), (1, 1, S, S))
        return blk[0, 0]

    return jax.vmap(one)(jnp.arange(N)).astype(jnp.int32)


@partial(jax.jit, static_argnames=("S", "margin"))
def _refine(cur_blocks, planes, mv_q, offsets, lam, mvp_q, S, margin):
    """One subpel refinement round.

    cur_blocks [N,S,S]; planes [4,4,Hp,Wp] (padded by `margin` int pels);
    mv_q [N,2] current best quarter-pel MVs; offsets [K,2] quarter-pel
    deltas (0,0 included to keep the incumbent); mvp_q [N,2] the MV
    predictor the bit cost is measured against (x265 charges lambda *
    bitcost(mv - mvp), bitcost.h — a (0,0) predictor over-penalizes
    uniform motion by ~20 bits/block). Returns best mv [N,2].
    """
    N = cur_blocks.shape[0]
    nbx_arr = mv_q[:, 2]  # packed block x index
    nby_arr = mv_q[:, 3]
    base = mv_q[:, :2]
    K = offsets.shape[0]

    # all K offsets as ONE flattened lane batch (one fused gather
    # instead of K)
    cands = base[None, :, :] + offsets[:, None, :]          # [K,N,2]
    fx = cands[..., 0] & 3
    fy = cands[..., 1] & 3
    ix = (cands[..., 0] >> 2) + (nbx_arr * S + margin)[None, :]
    iy = (cands[..., 1] >> 2) + (nby_arr * S + margin)[None, :]
    pred = _gather_phase_blocks(planes, fy.reshape(-1), fx.reshape(-1),
                                iy.reshape(-1), ix.reshape(-1), S)
    cur_k = jnp.broadcast_to(cur_blocks[None], (K,) + cur_blocks.shape
                             ).reshape(K * N, S, S)
    satd = satd8_batched(cur_k, pred).astype(jnp.float32).reshape(K, N)
    mvd = jnp.abs(cands - mvp_q[None]).astype(jnp.float32)
    bits = (2 * jnp.floor(jnp.log2(2 * mvd + 1)) + 1).sum(axis=2)
    costs = satd + lam * bits                      # [K,N]
    k = jnp.argmin(costs, axis=0)                  # [N]
    best = jnp.take_along_axis(cands, k[None, :, None], axis=0)[0]
    cost = jnp.min(costs, axis=0)
    return best, cost


_HALF_OFFS = np.array([(0, 0), (-2, 0), (2, 0), (0, -2), (0, 2),
                       (-2, -2), (-2, 2), (2, -2), (2, 2)], dtype=np.int32)
_QUARTER_OFFS = np.array([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
                          (-1, -1), (-1, 1), (1, -1), (1, 1)], dtype=np.int32)


def subpel_rounds(subme: int):
    """Refinement schedule per --subme tier (x265 subme dial,
    motion.cpp subpelRefine iterations — re-imagined as batched
    8-neighbor rounds; each extra round is one more device dispatch):
        <=1: half only          2-3: half + quarter (default)
        4:   half + 2x quarter  >=5: 2x half + 2x quarter
    A second round of the same step lets the minimum drift beyond the
    +-1 neighborhood the single round can reach."""
    if subme <= 1:
        return [_HALF_OFFS]
    if subme <= 3:
        return [_HALF_OFFS, _QUARTER_OFFS]
    if subme == 4:
        return [_HALF_OFFS, _QUARTER_OFFS, _QUARTER_OFFS]
    return [_HALF_OFFS, _HALF_OFFS, _QUARTER_OFFS, _QUARTER_OFFS]


@partial(jax.jit, static_argnames=("S", "margin"))
def _bi_satd(cur_blocks, planes0, planes1, mv0, mv1, bxy, S, margin):
    """SATD of the averaged bi-prediction per block (x265 checkBidir2Nx2N
    analog, analysis.cpp:3145): pixel-domain avg of the two phase-plane
    preds."""
    N = cur_blocks.shape[0]

    def gather(planes, mv):
        fx = mv[:, 0] & 3
        fy = mv[:, 1] & 3
        ix = (mv[:, 0] >> 2) + bxy[:, 0] * S + margin
        iy = (mv[:, 1] >> 2) + bxy[:, 1] * S + margin
        return _gather_phase_blocks(planes, fy, fx, iy, ix, S)

    avg = (gather(planes0, mv0) + gather(planes1, mv1) + 1) >> 1
    return satd8_batched(cur_blocks, avg)


def motion_decide(cur_y: np.ndarray, ref_y: np.ndarray, width: int,
                  height: int, S: int = 16, R: int = 16, qp: int = 32,
                  subme: int = 2, return_aux: bool = False,
                  bit_depth: int = 8):
    """Full-search + subpel-refined ME vs one reference frame.

    Returns (mv [nby,nbx,2] quarter-pel, cost [nby,nbx] satd+lambda*bits).
    subme: 0 = integer only, 1 = +half, >=2 = +quarter (x265 --subme dial).
    With return_aux, additionally returns the phase planes + block geometry
    for bi-prediction cost evaluation (bi_cost).
    """
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    wire = np.int16 if bit_depth > 8 else np.uint8
    cur = np.pad(np.asarray(cur_y).astype(wire),
                 ((0, ph - height), (0, pw - width)), mode="edge")
    ref = np.pad(np.asarray(ref_y).astype(wire),
                 ((0, ph - height), (0, pw - width)), mode="edge")
    nby, nbx = ph // S, pw // S
    N = nby * nbx

    lam = np.float32(np.sqrt(0.85 * 2.0 ** ((qp - 12) / 3.0)))

    # --- integer search ---
    if R <= 24:
        n = 2 * R + 1
        dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
        mvcost = lam * (_mv_bits(4 * dxs.ravel()) + _mv_bits(4 * dys.ravel()))
        ref_pad_i = np.pad(ref, R, mode="edge")
        idx, cost, sad = _int_search(jnp.asarray(cur), jnp.asarray(ref_pad_i),
                                     jnp.asarray(mvcost), S, R)
        idx = np.asarray(idx)
        mv_int = np.stack([(idx % n) - R, (idx // n) - R], axis=-1)  # (dx,dy)
    else:
        # Hierarchical ME (the x265 --hme analog, lowres.h:203-205): a
        # dense sweep on a 2x-downscaled pair covers the full +-R range at
        # a quarter of the cost, then a per-block +-W_r full-resolution
        # window refine recovers full-pel accuracy. This honors ANY
        # merange (default 57) instead of silently clamping it.
        R2 = (R + 1) // 2
        S2 = S // 2
        cur_l = _downscale2(jnp.asarray(cur))
        ref_l = _downscale2(jnp.asarray(ref))
        n2 = 2 * R2 + 1
        dys, dxs = np.mgrid[-R2:R2 + 1, -R2:R2 + 1]
        mvcost2 = lam * (_mv_bits(8 * dxs.ravel())
                         + _mv_bits(8 * dys.ravel()))
        idx2, _, _ = _int_search(cur_l, jnp.pad(ref_l, R2, mode="edge"),
                                 jnp.asarray(mvcost2), S2, R2)
        idx2 = np.asarray(idx2)
        mv_half = np.stack([(idx2 % n2) - R2, (idx2 // n2) - R2], axis=-1)
        W_r = 7
        centers = np.clip(mv_half * 2, -(R - W_r), R - W_r).reshape(-1, 2)
        ref_pad_i = np.pad(ref, R, mode="edge")
        bxr, byr = np.meshgrid(np.arange(nbx), np.arange(nby))
        bxy_i = np.stack([bxr.reshape(-1), byr.reshape(-1)],
                         axis=1).astype(np.int32)
        cur_blocks_i = (cur.reshape(nby, S, nbx, S).transpose(0, 2, 1, 3)
                        .reshape(N, S, S))
        mv_loc, cost_loc = _local_search(
            jnp.asarray(cur_blocks_i), jnp.asarray(ref_pad_i),
            jnp.asarray(centers.astype(np.int32)), jnp.asarray(bxy_i),
            jnp.float32(lam), S, W_r, R)
        mv_int = np.asarray(mv_loc).reshape(nby, nbx, 2)
        cost = np.asarray(cost_loc).reshape(nby, nbx)

    if subme <= 0:
        mv = (mv_int * 4).astype(np.int32)
        if return_aux:
            raise ValueError("return_aux requires subme >= 1 (phase planes)")
        return mv, np.asarray(cost).astype(np.float32)

    # --- subpel refinement on quarter-pel phase planes ---
    margin = R + 2            # int-pel padding available in the planes
    ref_pad_s = np.pad(ref, ((margin + 3, margin + 4),
                             (margin + 3, margin + 4)), mode="edge")
    planes = _phase_planes(jnp.asarray(ref_pad_s), (1 << bit_depth) - 1)

    bx, by = np.meshgrid(np.arange(nbx), np.arange(nby))
    cur_blocks = jnp.asarray(
        cur.reshape(nby, S, nbx, S).transpose(0, 2, 1, 3)
        .reshape(N, S, S).astype(np.int32))
    state = np.concatenate([(mv_int * 4).reshape(N, 2),
                            bx.reshape(N, 1), by.reshape(N, 1)],
                           axis=1).astype(np.int32)
    mv_q = jnp.asarray(state)
    best2 = mv_q[:, :2]
    cost2 = None
    zero_mvp = jnp.zeros((N, 2), jnp.int32)
    rounds = subpel_rounds(subme)
    for offs in rounds:
        best2, cost2 = _refine(cur_blocks, planes,
                               jnp.concatenate([best2, mv_q[:, 2:]], axis=1),
                               jnp.asarray(offs), lam, zero_mvp,
                               S, margin)
    mv = np.asarray(best2).reshape(nby, nbx, 2)
    cost = np.asarray(cost2).reshape(nby, nbx)
    if return_aux:
        aux = dict(planes=planes, cur_blocks=cur_blocks,
                   bxy=np.stack([bx.reshape(-1), by.reshape(-1)], axis=1),
                   margin=margin, lam=lam)
        return mv.astype(np.int32), cost.astype(np.float32), aux
    return mv.astype(np.int32), cost.astype(np.float32)


@partial(jax.jit, static_argnames=("S", "margin"))
def _eval_fixed(cur_blocks, planes, mv, bxy, S, margin):
    """SATD of every block at its given quarter-pel MV (one gather)."""
    N = cur_blocks.shape[0]
    fx = mv[:, 0] & 3
    fy = mv[:, 1] & 3
    ix = (mv[:, 0] >> 2) + bxy[:, 0] * S + margin
    iy = (mv[:, 1] >> 2) + bxy[:, 1] * S + margin
    pred = _gather_phase_blocks(planes, fy, fx, iy, ix, S)
    return satd8_batched(cur_blocks, pred)


def mv_field_median3(mv: np.ndarray) -> np.ndarray:
    """Per-component 3x3 median of an MV field [nby,nbx,2] (edge-padded)
    — the decision-stage MV predictor (stands in for AMVP, which is only
    defined during the coding walk; x265 motion.cpp uses the real MVP)."""
    p = np.pad(mv, ((1, 1), (1, 1), (0, 0)), mode="edge")
    stack = np.stack([p[dy:dy + mv.shape[0], dx:dx + mv.shape[1]]
                      for dy in range(3) for dx in range(3)])
    return np.median(stack, axis=0).astype(np.int32)


def refine_with_mvp(aux, mv: np.ndarray, mvp: np.ndarray, subme: int = 2):
    """Re-run the subpel refinement + final costing with MVP-relative MV
    bits (two-phase ME: pass 1 finds the motion with a (0,0) prior,
    pass 2 re-costs against the neighborhood predictor so uniform motion
    fields are cheap, like x265's AMVP-based mvcost).

    Returns (mv [nby,nbx,2] qpel, cost [nby,nbx])."""
    nby, nbx = mv.shape[:2]
    N = nby * nbx
    S = aux["cur_blocks"].shape[1]
    bxy = aux["bxy"]
    state = np.concatenate([mv.reshape(N, 2), bxy], axis=1).astype(np.int32)
    mv_q = jnp.asarray(state)
    best2 = mv_q[:, :2]
    mvp_dev = jnp.asarray(mvp.reshape(N, 2).astype(np.int32))
    rounds = subpel_rounds(subme)
    if subme < 1:
        rounds = [np.array([(0, 0)], dtype=np.int32)]
    cost2 = None
    for offs in rounds:
        best2, cost2 = _refine(aux["cur_blocks"], aux["planes"],
                               jnp.concatenate([best2, mv_q[:, 2:]], axis=1),
                               jnp.asarray(offs), aux["lam"], mvp_dev,
                               S, aux["margin"])
    return (np.asarray(best2).reshape(nby, nbx, 2).astype(np.int32),
            np.asarray(cost2).reshape(nby, nbx).astype(np.float32))


def eval_mvs(aux, mv: np.ndarray) -> np.ndarray:
    """Per-block SATD at arbitrary MVs using a motion_decide aux bundle."""
    n = mv.reshape(-1, 2)
    satd = _eval_fixed(aux["cur_blocks"], aux["planes"],
                       jnp.asarray(n.astype(np.int32)),
                       jnp.asarray(aux["bxy"]), aux["cur_blocks"].shape[1],
                       aux["margin"])
    return np.asarray(satd)


def smooth_mv_field(mv, cost, aux, lam, group: int = 2,
                    slack_bits: float = 24.0):
    """Unify each group x group block neighborhood onto its modal MV when
    the SATD increase is cheaper than the syntax saved by a merged CU
    (the RD glue that lets the quadtree promote 16->32; x265 gets this
    for free from recursive RDO)."""
    nby, nbx = mv.shape[:2]
    gy, gx = nby // group, nbx // group
    if gy == 0 or gx == 0:
        return mv
    g = mv[:gy * group, :gx * group].reshape(gy, group, gx, group, 2)
    g = np.moveaxis(g, 3, 2).reshape(gy, gx, group * group, 2)
    # modal mv: the member minimizing summed L1 distance to the others
    d = np.abs(g[:, :, :, None, :] - g[:, :, None, :, :]).sum(axis=(3, 4))
    modal_idx = d.argmin(axis=2)
    modal = np.take_along_axis(
        g, modal_idx[..., None, None], axis=2)[:, :, 0]       # [gy,gx,2]
    cand = np.repeat(np.repeat(modal, group, 0), group, 1)    # [nby',nbx',2]
    full = mv.copy()
    full[:gy * group, :gx * group] = cand
    satd_mode = eval_mvs(aux, full).reshape(nby, nbx)
    satd_best = eval_mvs(aux, mv).reshape(nby, nbx)
    dsum = (satd_mode - satd_best)[:gy * group, :gx * group]
    dsum = dsum.reshape(gy, group, gx, group).sum(axis=(1, 3))
    accept = dsum <= lam * slack_bits
    acc_up = np.repeat(np.repeat(accept, group, 0), group, 1)
    out = mv.copy()
    sel = np.zeros(mv.shape[:2], dtype=bool)
    sel[:gy * group, :gx * group] = acc_up
    out[sel] = full[sel]
    return out


def bi_cost(mv0, aux0, mv1, aux1, S: int = 16, mvp0=None, mvp1=None):
    """Bi-prediction cost per block from two motion_decide aux bundles:
    SATD of the averaged prediction + lambda * mv bits of both MVs
    (MVP-relative when predictors are given)."""
    nby, nbx = mv0.shape[:2]
    bxy = jnp.asarray(aux0["bxy"])
    satd = _bi_satd(aux0["cur_blocks"], aux0["planes"], aux1["planes"],
                    jnp.asarray(mv0.reshape(-1, 2)),
                    jnp.asarray(mv1.reshape(-1, 2)),
                    bxy, S, aux0["margin"])
    d0 = mv0 - (mvp0 if mvp0 is not None else 0)
    d1 = mv1 - (mvp1 if mvp1 is not None else 0)
    bits = (_mv_bits(d0.reshape(-1, 2)).sum(1) +
            _mv_bits(d1.reshape(-1, 2)).sum(1))
    cost = np.asarray(satd).astype(np.float32) + aux0["lam"] * bits
    return cost.reshape(nby, nbx)


# ---------------------------------------------------------------------------
# Fused per-frame motion search: ONE device dispatch per frame covering all
# refs x (integer search -> quarter-pel phase planes -> half/quarter refine
# -> MVP re-cost -> 2x2 modal smoothing). A per-stage dispatch chain would
# pay ~12 host round trips per frame; this is the P2 re-imagining's
# throughput form.
# ---------------------------------------------------------------------------

def _median3x3_dev(mv):
    """[nby,nbx,2] int -> per-component 3x3 median (edge-padded), device."""
    p = jnp.pad(mv, ((1, 1), (1, 1), (0, 0)), mode="edge")
    nby, nbx = mv.shape[:2]
    stack = jnp.stack([p[dy:dy + nby, dx:dx + nbx]
                       for dy in range(3) for dx in range(3)])
    return jnp.sort(stack, axis=0)[4]


def _int_stage(cur, ref_R, mvcost_flat, S, R, chunk=8):
    """Dense integer search body (one ref). ref_R padded by R. The
    displacement sweep runs `chunk` candidates per scan step — a
    3481-step scalar scan pays ~30x its compute in sequencing overhead."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    n = 2 * R + 1
    total = n * n
    steps = -(-total // chunk)

    # int16 plane reads halve the sweep's bandwidth (the shifted-window
    # read dominates); |diff| <= maxpix fits i16, the first-stage row
    # sum accumulates in i32 — bit-identical to the i32 form
    cur16 = cur.astype(jnp.int16)
    ref16 = ref_R.astype(jnp.int16)

    def body(carry, k):
        best_cost, best_idx = carry
        for j in range(chunk):
            d = jnp.minimum(k * chunk + j, total - 1)
            dy = d // n
            dx = d % n
            sh = jax.lax.dynamic_slice(ref16, (dy, dx), (H, W))
            ad = jnp.abs(cur16 - sh)
            sad = ad.reshape(nby, S, nbx, S).sum(axis=(1, 3),
                                                 dtype=jnp.int32)
            cost = sad.astype(jnp.float32) + mvcost_flat[d]
            upd = cost < best_cost
            best_cost = jnp.where(upd, cost, best_cost)
            best_idx = jnp.where(upd, d, best_idx)
        return (best_cost, best_idx), None

    init = (jnp.full((nby, nbx), jnp.inf, jnp.float32),
            jnp.zeros((nby, nbx), jnp.int32))
    (cost, idx), _ = jax.lax.scan(body, init, jnp.arange(steps))
    mv = jnp.stack([idx % n - R, idx // n - R], axis=-1)
    return mv


@partial(jax.jit, static_argnames=("S", "R", "subme", "bd", "do_bi",
                                   "slack", "force_dense"))
def _motion_fused(cur, refs_big, lam, S, R, subme, bd, do_bi,
                  slack=24.0, force_dense=False):
    """cur [H,W] int32 (padded to S multiples); refs_big [nref, H+2P, W+2P]
    edge-padded by P = R+6. Returns (mv [nref,nby,nbx,2] qpel,
    cost [nref,nby,nbx] satd+lam*mvpbits, satd [nref,nby,nbx],
    bi_satd [nby,nbx] (zeros unless do_bi))."""
    nref = refs_big.shape[0]
    H, W = cur.shape
    nby, nbx = H // S, W // S
    N = nby * nbx
    P = R + 6
    margin = R + 2
    cur = cur.astype(jnp.int32)
    refs_big = refs_big.astype(jnp.int32)
    maxv = (1 << bd) - 1

    # --- stage 1: integer search (dense <=24, else 2-level HME;
    # --me full forces the dense sweep at any range) ---
    if R <= 24 or force_dense:
        dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
        mvcost = jnp.asarray(
            (_mv_bits(4 * dxs.ravel()) + _mv_bits(4 * dys.ravel()))
            .astype(np.float32))
        ref_R = refs_big[:, P - R:P + H + R, P - R:P + W + R]
        mv_int = jax.vmap(lambda r: _int_stage(cur, r, lam * mvcost, S, R)
                          )(ref_R)
    else:
        R2 = (R + 1) // 2
        S2 = S // 2
        dys, dxs = np.mgrid[-R2:R2 + 1, -R2:R2 + 1]
        mvcost2 = jnp.asarray(
            (_mv_bits(8 * dxs.ravel()) + _mv_bits(8 * dys.ravel()))
            .astype(np.float32))
        cur_l = _downscale2(cur)
        W_r = 7
        bxr, byr = np.meshgrid(np.arange(nbx), np.arange(nby))
        bxy_i = jnp.asarray(np.stack([bxr.reshape(-1), byr.reshape(-1)],
                                     axis=1).astype(np.int32))
        cur_blocks_i = (cur.reshape(nby, S, nbx, S).transpose(0, 2, 1, 3)
                        .reshape(N, S, S))

        def one_ref(rb):
            ref_l = _downscale2(rb[P:P + H, P:P + W])
            mvh = _int_stage(cur_l, jnp.pad(ref_l, R2, mode="edge"),
                             lam * mvcost2, S2, R2)
            centers = jnp.clip(mvh * 2, -(R - W_r), R - W_r).reshape(-1, 2)
            ref_R = rb[P - R:P + H + R, P - R:P + W + R]
            mv_loc, _ = _local_search(cur_blocks_i, ref_R, centers, bxy_i,
                                      lam, S, W_r, R)
            return mv_loc.reshape(nby, nbx, 2)

        mv_int = jax.vmap(one_ref)(refs_big)

    # --- stage 2: phase planes + subpel/MVP/smoothing per ref ---
    ref_S = refs_big[:, P - margin - 3:P + H + margin + 4,
                     P - margin - 3:P + W + margin + 4]
    planes = jax.vmap(lambda r: _phase_planes(r, maxv))(ref_S)
    bx, by = np.meshgrid(np.arange(nbx), np.arange(nby))
    bxy = jnp.asarray(np.concatenate(
        [bx.reshape(-1, 1), by.reshape(-1, 1)], axis=1).astype(np.int32))
    cur_blocks = (cur.reshape(nby, S, nbx, S).transpose(0, 2, 1, 3)
                  .reshape(N, S, S))
    state_xy = bxy

    rounds = [jnp.asarray(r) for r in subpel_rounds(subme)]

    def refine_ref(planes_r, mv0):
        # MVP from the integer-search field directly (skipping a zero-MVP
        # subpel phase: the int field is what the median predictor needs,
        # and each refine round costs ~100ms at 720p)
        best = mv0.reshape(N, 2) * 4
        mvp = _median3x3_dev(mv0 * 4).reshape(N, 2)
        cost = None
        for offs in rounds:
            best, cost = _refine(cur_blocks, planes_r,
                                 jnp.concatenate([best, state_xy], axis=1),
                                 offs, lam, mvp, S, margin)
        # snap-to-predictor: quarter-pel measurement noise leaves each
        # block an mvd of +-1 qpel, which breaks the writer's merge
        # detection and costs ~10 bits/CU of AMVP+MVD syntax; taking the
        # predictor exactly when its SATD is within the saved bits is the
        # RD-correct choice (the merge/skip candidate the writer will
        # find for a uniform field IS this predictor)
        satd_mvp = _eval_fixed(cur_blocks, planes_r, mvp, bxy, S, margin)
        satd_cur = _eval_fixed(cur_blocks, planes_r, best, bxy, S, margin)
        mvd_now = jnp.abs(best - mvp).astype(jnp.float32)
        bits_now = (2 * jnp.floor(jnp.log2(2 * mvd_now + 1)) + 1).sum(1)
        snap = (satd_mvp.astype(jnp.float32)
                <= satd_cur.astype(jnp.float32) + lam * (bits_now + 6.0))
        best = jnp.where(snap[:, None], mvp, best)
        # 2x2 modal smoothing (smooth_mv_field, device form)
        mvf = best.reshape(nby, nbx, 2)
        gy, gx = nby // 2, nbx // 2
        g = mvf[:gy * 2, :gx * 2].reshape(gy, 2, gx, 2, 2)
        g = jnp.moveaxis(g, 3, 2).reshape(gy, gx, 4, 2)
        d = jnp.abs(g[:, :, :, None, :] - g[:, :, None, :, :]).sum((3, 4))
        modal = jnp.take_along_axis(
            g, d.argmin(axis=2)[..., None, None], axis=2)[:, :, 0]
        cand = jnp.repeat(jnp.repeat(modal, 2, 0), 2, 1)
        full = mvf.at[:gy * 2, :gx * 2].set(cand)
        satd_mode = _eval_fixed(cur_blocks, planes_r,
                                full.reshape(N, 2), bxy, S, margin)
        satd_best = _eval_fixed(cur_blocks, planes_r,
                                mvf.reshape(N, 2), bxy, S, margin)
        dsum = (satd_mode - satd_best).reshape(nby, nbx)
        dsum = dsum[:gy * 2, :gx * 2].reshape(gy, 2, gx, 2).sum((1, 3))
        acc = (dsum <= lam * slack)
        accf = jnp.repeat(jnp.repeat(acc, 2, 0), 2, 1)
        sel = jnp.zeros((nby, nbx), bool).at[:gy * 2, :gx * 2].set(accf)
        mv_out = jnp.where(sel[..., None], full, mvf)
        satd_out = jnp.where(sel.reshape(-1), satd_mode, satd_best)
        mvd = jnp.abs(mv_out.reshape(N, 2) - mvp).astype(jnp.float32)
        bits = (2 * jnp.floor(jnp.log2(2 * mvd + 1)) + 1).sum(axis=1)
        cost_out = satd_out.astype(jnp.float32) + lam * bits
        return mv_out, cost_out.reshape(nby, nbx), satd_out.reshape(nby, nbx)

    mv, cost, satd = jax.vmap(refine_ref)(planes, mv_int)

    if do_bi:
        bi = _bi_satd(cur_blocks, planes[0], planes[1],
                      mv[0].reshape(N, 2), mv[1].reshape(N, 2), bxy, S,
                      margin)
        bi = bi.reshape(nby, nbx)
    else:
        bi = jnp.zeros((nby, nbx), jnp.int32)
    return mv, cost, satd, bi


def _mesh_put(a, mesh, rows_divisor=0):
    """device_put under a mesh: row-sharded over the 'tile' axis when
    axis 0 divides evenly by rows_divisor * n_tiles, else replicated.
    GSPMD partitions the SAME jitted search graph, so results are
    identical to the single-device path by construction (the Encoder's
    attach_mesh flows here; validated by dryrun_multichip)."""
    if mesh is None:
        return jnp.asarray(a)
    if not isinstance(a, jax.Array):
        a = np.asarray(a)       # straight from the host to every shard
    from jax.sharding import NamedSharding, PartitionSpec as PS
    n = mesh.devices.size
    if rows_divisor and a.shape[0] % (rows_divisor * n) == 0:
        spec = PS("tile", *([None] * (a.ndim - 1)))
    else:
        spec = PS(*([None] * a.ndim))
    return jax.device_put(a, NamedSharding(mesh, spec))


def motion_fused(cur_y, ref_ys, width, height, S=16, R=57, qp=32,
                 subme=2, bit_depth=8, do_bi=False, slack=24.0,
                 force_dense=False, mesh=None):
    """Host wrapper: one device dispatch for all refs' motion search.

    cur_y [H,W]; ref_ys: list of reference luma planes.
    Returns (mv [nref,nby,nbx,2], cost [nref,nby,nbx], satd [...], bi).
    """
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    wire = np.int16 if bit_depth > 8 else np.uint8
    P = R + 6
    refs = jnp.stack([_me_ref_upload(r, wire, P, ph, pw, height, width)
                      for r in ref_ys])
    if mesh is None:
        # shared source upload (devcache) + device-side padding: the
        # same plane feeds analysis/residual/SAO — one wire crossing
        from x265_tpu.engine.planes import pad_dev
        from x265_tpu.utils import devcache
        H, W = np.asarray(cur_y).shape
        cur = pad_dev(devcache.src_plane(np.asarray(cur_y), bit_depth),
                      (0, ph - H, 0, pw - W), wire)
    else:
        cur = _mesh_put(
            np.pad(np.asarray(cur_y).astype(wire),
                   ((0, ph - height), (0, pw - width)), mode="edge"),
            mesh, rows_divisor=S)
        refs = _mesh_put(np.asarray(refs), mesh)   # replicated refs
    lam = np.float32(np.sqrt(0.85 * 2.0 ** ((qp - 12) / 3.0)))
    mv, cost, satd, bi = _motion_fused(
        cur, refs, jnp.float32(lam),
        S, R, max(1, subme), bit_depth, do_bi, float(slack),
        bool(force_dense))
    return (np.asarray(mv), np.asarray(cost), np.asarray(satd),
            np.asarray(bi))


def _me_ref_upload(r, wire, P, ph, pw, height, width):
    """Search-layout reference: a device-resident handle pads ON DEVICE
    (FramePlanes/MELuma.dev_luma_me — zero wire bytes); a host plane pads
    on the host and uploads once per anchor (identity-keyed cache)."""
    if hasattr(r, "dev_luma_me"):
        return r.dev_luma_me(P, ph, pw)
    from x265_tpu.utils import devcache

    def build():
        rp = np.pad(np.pad(np.asarray(r).astype(wire),
                           ((0, ph - height), (0, pw - width)),
                           mode="edge"), P, mode="edge")
        return jnp.asarray(rp)
    return devcache.get_or(("me_ref", id(r), P, ph, pw), r, build)


@lru_cache(maxsize=16)
def _motion_fused_multi_fn(S, R, subme, bd, do_bi, slack, force_dense):
    def run(curs, refs_big, lams):
        return jax.vmap(
            lambda c, l: _motion_fused(c, refs_big, l, S, R, subme, bd,
                                       do_bi, slack, force_dense),
            in_axes=(0, 0))(curs, lams)
    return jax.jit(run)


def motion_fused_frames(cur_list, ref_ys, width, height, S=16, R=57,
                        qps=None, subme=2, bit_depth=8, do_bi=False,
                        slack=24.0, force_dense=False):
    """Motion search for SEVERAL frames against the same reference set in
    ONE device dispatch (the mini-GOP's leaf Bs all predict from the same
    two anchors — x265 runs CostEstimateGroup jobs per frame,
    slicetype.h:219; here the frame axis is just another batch dim).

    Returns per-frame tuples [(mv, cost, satd, bi)], numpy.
    """
    K = len(cur_list)
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    wire = np.int16 if bit_depth > 8 else np.uint8
    curs = np.stack([
        np.pad(np.asarray(c).astype(wire),
               ((0, ph - height), (0, pw - width)), mode="edge")
        for c in cur_list])
    P = R + 6
    refs = jnp.stack([_me_ref_upload(r, wire, P, ph, pw, height, width)
                      for r in ref_ys])
    if qps is None:
        qps = [32] * K
    lams = jnp.asarray(np.sqrt(
        0.85 * 2.0 ** ((np.asarray(qps, np.float32) - 12) / 3.0)
    ).astype(np.float32))
    fn = _motion_fused_multi_fn(S, R, max(1, subme), bit_depth, do_bi,
                                float(slack), bool(force_dense))
    mv, cost, satd, bi = fn(jnp.asarray(curs), refs, lams)
    mv = np.asarray(mv)
    cost = np.asarray(cost)
    satd = np.asarray(satd)
    bi = np.asarray(bi)
    return [(mv[k], cost[k], satd[k], bi[k]) for k in range(K)]


# ---------------------------------------------------------------------------
# Motion coherence pass (decision-stage merge/skip emulation).
#
# The per-block argmin leaves quarter-pel wobble and L0/L1/bi near-tie flips
# across a uniformly moving region, so the writer's exact-match merge
# detection fails and thousands of CUs pay AMVP syntax for identical motion
# (measured: 33% of a pan's B bits were zero-residual AMVP headers).  x265
# avoids this by RD-costing the real merge candidates per CU
# (analysis.cpp:1914 checkMerge2Nx2N); the batched equivalent evaluates a
# handful of frame-dominant motion tuples for EVERY block in one batched
# dispatch and adopts them where the AMVP->merge/skip rate saving wins.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("S", "P", "K", "bd"))
def _tuple_satd(cur, refs0_big, refs1_big, dirs, r0s, r1s, mv0s, mv1s,
                S, P, K, bd):
    """SATD of every SxS block under K fixed motion tuples.

    cur [H,W]; refs{0,1}_big [nref, H+2P, W+2P] edge-padded by P (the
    motion_fused upload layout, reused from the device cache); dirs [K]
    (1/2/3), r0s/r1s [K] list indices, mv0s/mv1s [K,2] quarter-pel.
    Returns [K, nby, nbx] int32.
    """
    H, W = cur.shape
    nby, nbx = H // S, W // S
    cur_blocks = (cur.astype(jnp.int32).reshape(nby, S, nbx, S)
                  .transpose(0, 2, 1, 3).reshape(-1, S, S))
    f = jnp.asarray(LUMA_FILTERS)          # [4, 8] (tap 3 = base sample)
    maxv = (1 << bd) - 1

    def plane_pred(refs_big, r, mvx, mvy):
        """Whole-frame 8-tap qpel prediction at one fixed MV."""
        ix = P + (mvx >> 2) - 3
        iy = P + (mvy >> 2) - 3
        win = jax.lax.dynamic_slice(
            refs_big, (r, iy, ix), (1, H + 7, W + 7))[0].astype(jnp.int32)
        fx = f[mvx & 3]
        fy = f[mvy & 3]
        cols = jnp.stack([win[:, t:t + W] for t in range(8)], axis=-1)
        hor = cols @ fx                               # [H+7, W]
        rows = jnp.stack([hor[t:t + H, :] for t in range(8)], axis=0)
        out = jnp.tensordot(fy, rows, axes=1)         # [H, W]
        return jnp.clip((out + 2048) >> 12, 0, maxv)

    outs = []
    for k in range(K):
        p0 = plane_pred(refs0_big, r0s[k], mv0s[k, 0], mv0s[k, 1])
        p1 = plane_pred(refs1_big, r1s[k], mv1s[k, 0], mv1s[k, 1])
        pred = jnp.where(dirs[k] == 3, (p0 + p1 + 1) >> 1,
                         jnp.where(dirs[k] == 1, p0, p1))
        blocks = (pred.reshape(nby, S, nbx, S).transpose(0, 2, 1, 3)
                  .reshape(-1, S, S))
        outs.append(satd8_batched(cur_blocks, blocks).reshape(nby, nbx))
    return jnp.stack(outs)


def tuple_satd(cur_y, ref0_ys, ref1_ys, cands, width, height, S=16,
               R=57, bit_depth=8, mesh=None):
    """Host wrapper for _tuple_satd: cands is a list of
    (dir, r0, r1, (mv0x, mv0y), (mv1x, mv1y)) tuples (any count; padded
    to a static K=4 so the graph never recompiles). Reference uploads hit
    the motion_fused device cache. Returns satd [len(cands), nby, nbx]."""
    K = 4
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    wire = np.int16 if bit_depth > 8 else np.uint8
    if mesh is None:
        from x265_tpu.engine.planes import pad_dev
        from x265_tpu.utils import devcache
        H, W = np.asarray(cur_y).shape
        cur = pad_dev(devcache.src_plane(np.asarray(cur_y), bit_depth),
                      (0, ph - H, 0, pw - W), wire)
    else:
        cur = np.pad(np.asarray(cur_y).astype(wire),
                     ((0, ph - height), (0, pw - width)), mode="edge")
    P = R + 6
    refs0 = jnp.stack([_me_ref_upload(r, wire, P, ph, pw, height, width)
                       for r in ref0_ys])
    refs1 = (jnp.stack([_me_ref_upload(r, wire, P, ph, pw, height, width)
                        for r in ref1_ys]) if ref1_ys
             else refs0[:1])
    if mesh is not None:
        refs0 = _mesh_put(np.asarray(refs0), mesh)
        refs1 = _mesh_put(np.asarray(refs1), mesh)
    padded = list(cands) + [cands[0]] * (K - len(cands))
    dirs = jnp.asarray([c[0] for c in padded], jnp.int32)
    r0s = jnp.asarray([c[1] for c in padded], jnp.int32)
    r1s = jnp.asarray([c[2] for c in padded], jnp.int32)
    mv0s = jnp.asarray([c[3] for c in padded], jnp.int32)
    mv1s = jnp.asarray([c[4] for c in padded], jnp.int32)
    out = _tuple_satd(_mesh_put(cur, mesh, rows_divisor=S), refs0, refs1,
                      dirs, r0s, r1s, mv0s, mv1s, S, P, K, bit_depth)
    return np.asarray(out)[:len(cands)]


def dominant_tuples(dir_blk, mv_blk, ref_blk, inter_blk, max_cands=4):
    """Frame-dominant motion tuples from per-block decisions: the
    most-frequent (dir, ref, mv0, mv1) combinations among inter blocks.
    Returns a list of (dir, r0, r1, (mv0x,mv0y), (mv1x,mv1y)), most
    frequent first (possibly empty)."""
    sel = inter_blk.astype(bool)
    if not sel.any():
        return []
    flat = np.concatenate(
        [dir_blk[sel][:, None], ref_blk[sel][:, None],
         mv_blk[sel].reshape(-1, 4)], axis=1)
    uniq, cnt = np.unique(flat, axis=0, return_counts=True)
    order = np.argsort(-cnt)
    out = []
    for i in order[:max_cands]:
        d, r, x0, y0, x1, y1 = (int(v) for v in uniq[i])
        out.append((d, r, 0, (x0, y0), (x1, y1)))
    return out
