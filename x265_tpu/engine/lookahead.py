"""Lookahead-lite: lowres frame complexity estimation for rate control
(x265 analog: Lookahead/slicetype.cpp estimateFrameCost:3056 +
Lowres::init lowres.cpp:259 + the frameInitLowres primitive).

Round-1 scope: half-res downscale + per-8x8 min(intra, inter) SATD/SAD
cost, fully batched/jitted — the complexity signal that drives
CRF/ABR/VBV (ratecontrol.cpp rateEstimateQscale's m_currentSatd). The
full slicetype machinery (B-adapt Viterbi, scenecut, cuTree propagation)
layers on top of these same lowres tensors in a later round.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from x265_tpu.engine.me import satd8_batched


@jax.jit
def lowres_downscale(y: jnp.ndarray) -> jnp.ndarray:
    """Half-res by 2x2 mean (frameInitLowres analog)."""
    H, W = y.shape
    y = y.astype(jnp.int32)          # upcast on device (narrow wire)
    return (y.reshape(H // 2, 2, W // 2, 2).sum((1, 3)) + 2) >> 2


@partial(jax.jit, static_argnames=("R", "lh", "lw"))
def _downscale_and_costs(y: jnp.ndarray, prev: jnp.ndarray, lh: int,
                         lw: int, R: int = 4):
    """Fused downscale + lowres costs: ONE device dispatch per frame
    (one host round trip instead of the two-step path's two). Returns
    (low, icost, mcost, mv)."""
    low = lowres_downscale(y)
    ph = lh - low.shape[0]
    pw = lw - low.shape[1]
    low = jnp.pad(low, ((0, ph), (0, pw)), mode="edge")
    icost, mcost, mv = _lowres_costs_body(low, prev, R)
    return low, icost, mcost, mv


def _lowres_costs_body(low, prev, R):
    H, W = low.shape
    nby, nbx = H // 8, W // 8
    blocks = low.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
    dc = blocks.mean(axis=(2, 3), keepdims=True).astype(jnp.int32)
    flat = (blocks - dc).reshape(-1, 8, 8)
    icost = satd8_batched(flat, jnp.zeros_like(flat)).reshape(nby, nbx)

    prev_pad = jnp.pad(prev, R, mode="edge")
    n = 2 * R + 1

    # scan over dy only; the dx row is evaluated as one fused stack —
    # 17 big well-utilized steps instead of 289 tiny serial ones (the
    # d-order first-minimum tie-break is preserved: argmin picks the
    # first dx within a row, strict < keeps earlier rows)
    def body(carry, dy):
        best, bidx = carry
        rows = jax.lax.dynamic_slice(prev_pad, (dy, 0), (H, W + 2 * R))
        sads = jnp.stack([
            (jnp.abs(low - jax.lax.slice(rows, (0, dx), (H, dx + W)))
             .reshape(nby, 8, nbx, 8).sum(axis=(1, 3)))
            for dx in range(n)])                       # [n, nby, nbx]
        k = jnp.argmin(sads, axis=0)
        smin = jnp.min(sads, axis=0)
        didx = dy * n + k
        upd = smin < best
        return (jnp.where(upd, smin, best),
                jnp.where(upd, didx, bidx)), None

    init = (jnp.full((nby, nbx), 1 << 30, jnp.int32),
            jnp.zeros((nby, nbx), jnp.int32))
    (mcost, midx), _ = jax.lax.scan(body, init, jnp.arange(n))
    mvx = (midx % n) - R
    mvy = (midx // n) - R
    return (icost.astype(jnp.int32), mcost.astype(jnp.int32),
            jnp.stack([mvx, mvy], axis=-1).astype(jnp.int32))


@partial(jax.jit, static_argnames=("R",))
def _lowres_costs(low: jnp.ndarray, prev: jnp.ndarray, R: int = 4):
    """Per-8x8-block (intra_cost, inter_cost, best_mv) on the lowres plane.

    intra: SA8D energy after DC removal (lowresIntraEstimate proxy);
    inter: min over the (2R+1)^2 integer window of block SAD vs prev
    (estimateCUCost's hex search collapsed to a dense sweep); best_mv is
    the winning displacement (cuTree propagation needs it).
    """
    return _lowres_costs_body(low, prev, R)


class Lookahead:
    """Per-frame complexity costs in display order."""

    def __init__(self, width: int, height: int, bit_depth: int = 8):
        # pad lowres to multiples of 8
        self.lw = (width // 2 + 7) // 8 * 8
        self.lh = (height // 2 + 7) // 8 * 8
        self.bd = bit_depth
        self.prev_low = None

    def frame_cost(self, y: np.ndarray, is_intra: bool) -> float:
        """SATD-domain complexity of one frame (x265 m_currentSatd)."""
        return self.frame_costs(y, is_intra)[0]

    def _src_dev(self, y):
        """Shared-upload device source plane (one wire crossing per frame
        across lookahead/analysis/ME/residual)."""
        from x265_tpu.utils import devcache
        yw = np.asarray(y)
        if yw.dtype not in (np.uint8, np.int16, np.uint16):
            yw = yw.astype(np.int16)
        return devcache.src_plane(yw, self.bd)

    def frame_costs(self, y: np.ndarray, is_intra: bool):
        """(cost, intra_cost, inter_cost) of one display-order frame; the
        inter cost is vs the previous frame (the slicetype/scenecut
        signal, slicetype.cpp:2186). Per-block tensors are kept in
        self.last_blocks for cuTree propagation. Lowres planes stay ON
        DEVICE (slicetype pair costs consume them there; a 1080p lowres
        would be 2 MB/frame of pointless readback)."""
        ydev = self._src_dev(y)
        first = self.prev_low is None
        if first:
            low0 = lowres_downscale(ydev)
            lh0, lw0 = low0.shape
            from x265_tpu.engine.planes import pad_dev
            self._prev_dev = pad_dev(low0, (0, self.lh - lh0,
                                            0, self.lw - lw0))
        low_dev, icost, mcost, mv = _downscale_and_costs(
            ydev, self._prev_dev, self.lh, self.lw)
        self._prev_dev = low_dev
        icost = np.asarray(icost)
        mcost2 = np.asarray(mcost) * 2
        self.last_blocks = {"icost": icost, "mcost": mcost2,
                            "mv": np.asarray(mv)}
        self.last_low = low_dev      # device; slicetype pair costs
        icost_sum = float(icost.sum())
        pcost_sum = float(np.minimum(icost, mcost2).sum())
        self.prev_low = low_dev
        if first or is_intra:
            cost = icost_sum
        else:
            cost = pcost_sum
        return (max(1.0, cost), max(1.0, icost_sum),
                icost_sum if first else max(1.0, pcost_sum))


def cutree_propagate(records, ctb_log2: int, qcompress: float = 0.6,
                     max_off: int = 4) -> np.ndarray:
    """cuTree (x265 analog: Lookahead::cuTree/estimateCUPropagate +
    the propagateCost primitive, slicetype.cpp:2479).

    records: per-frame dicts {icost, mcost, mv} in DISPLAY order; each
    frame's lowres inter costs/MVs reference the PREVIOUS frame. Costs of
    well-predicted blocks are propagated backward to the blocks they
    reference; the first frame (the upcoming anchor's reference chain
    root) receives the accumulated propagation and yields per-CTB QP
    offsets: -strength * log2(1 + propagate/intra).
    """
    if not records:
        return None
    shape = records[0]["icost"].shape
    propagate = np.zeros(shape, dtype=np.float64)
    for rec in reversed(records[1:]):
        icost = rec["icost"].astype(np.float64) + 1.0
        mcost = np.minimum(rec["mcost"], rec["icost"]).astype(np.float64)
        fraction = np.clip(1.0 - mcost / icost, 0.0, 1.0)
        amount = (icost + propagate) * fraction
        # splat to the referenced block (integer lowres-block MV splat;
        # x265 does bilinear over 4 neighbors — 8x8 blocks, MV in pels)
        nby, nbx = shape
        by, bx = np.mgrid[0:nby, 0:nbx]
        ty = np.clip(by + np.round(rec["mv"][..., 1] / 8.0).astype(int),
                     0, nby - 1)
        tx = np.clip(bx + np.round(rec["mv"][..., 0] / 8.0).astype(int),
                     0, nbx - 1)
        nxt = np.zeros(shape, dtype=np.float64)
        np.add.at(nxt, (ty.ravel(), tx.ravel()), amount.ravel())
        propagate = nxt
    root = records[0]
    icost = root["icost"].astype(np.float64) + 1.0
    strength = 5.0 * (1.0 - qcompress)
    off = -strength * np.log2(1.0 + propagate / icost)
    # lowres 8x8 blocks -> CTB grid (ctb/2 lowres pels per CTB)
    blocks_per_ctb = max(1, (1 << ctb_log2) // 16)
    nby, nbx = shape
    cy = -(-nby // blocks_per_ctb)
    cx = -(-nbx // blocks_per_ctb)
    pad_y = cy * blocks_per_ctb - nby
    pad_x = cx * blocks_per_ctb - nbx
    offp = np.pad(off, ((0, pad_y), (0, pad_x)), mode="edge")
    ctb_off = offp.reshape(cy, blocks_per_ctb, cx,
                           blocks_per_ctb).mean(axis=(1, 3))
    # FLOAT offsets: the encoder sums AQ + cuTree + ROI as doubles and
    # rounds once (x265 qpCuTreeOffset stays double, slicetype.cpp:712)
    return np.clip(ctb_off, -float(max_off), 0.0)


from functools import lru_cache


@lru_cache(maxsize=8)
def _batched_pair_fn(n_pairs: int):
    """jit(vmap) over (cur, ref) lowres pairs -> per-pair summed
    min(icost, 2*mcost) and icost (one dispatch for a whole slicetype
    window; the bonded-group analog of slicetype.cpp estimateFrameCost
    fan-out)."""
    def one(cur, ref):
        # wider window than the per-frame sweep: anchors sit up to
        # bframes frames away, so accumulated motion exceeds R=4
        ic, mc, _ = _lowres_costs(cur, ref, R=8)
        return jnp.minimum(ic, mc * 2).astype(jnp.int32)
    return jax.jit(jax.vmap(one))


from collections import OrderedDict

# pair-cost memo across slicetype_split calls: the b-adapt window
# SLIDES one mini-GOP at a time, so ~3/4 of each window's (cur, ref)
# pairs were already costed last call. Keyed by plane identity with the
# arrays pinned (a recycled id cannot alias a dead frame).
_PAIR_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_BCOST_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PAIR_CACHE_MAX = 512


def batched_pair_costs(pairs):
    """pairs: list of (cur_low, ref_low) numpy planes (same shape).
    Returns the per-pair min(icost, 2*mcost) block maps. Only pairs not
    in the sliding-window memo dispatch; the batch pads to a power-of-2
    bucket so XLA compiles a handful of shapes, not one per window."""
    if not pairs:
        return []
    out = [None] * len(pairs)
    todo = []
    for i, (cur, ref) in enumerate(pairs):
        key = (id(cur), id(ref))
        ent = _PAIR_CACHE.get(key)
        if ent is not None and ent[0] is cur and ent[1] is ref:
            _PAIR_CACHE.move_to_end(key)
            out[i] = ent[2]
        else:
            todo.append(i)
    if todo:
        n = len(todo)
        bucket = 16
        while bucket < n:
            bucket <<= 1
        pad = bucket - n
        # planes may be device-resident (Lookahead keeps lows on device);
        # jnp.stack keeps the batch assembly on device in that case
        curs = jnp.stack([jnp.asarray(pairs[i][0]) for i in todo]
                         + [jnp.asarray(pairs[todo[0]][0])] * pad)
        refs = jnp.stack([jnp.asarray(pairs[i][1]) for i in todo]
                         + [jnp.asarray(pairs[todo[0]][1])] * pad)
        blk = np.asarray(_batched_pair_fn(bucket)(curs, refs))
        for k, i in enumerate(todo):
            out[i] = blk[k]
            cur, ref = pairs[i]
            _PAIR_CACHE[(id(cur), id(ref))] = (cur, ref, blk[k])
        while len(_PAIR_CACHE) > _PAIR_CACHE_MAX:
            _PAIR_CACHE.popitem(last=False)
    return out


def slicetype_split(anchor_low, queue_lows, max_bs=4,
                    b_discount=0.9):
    """Windowed slice-type decision (x264/x265 b-adapt 2 slicetypePath
    analog, slicetype.cpp): dynamic program over anchor placements in the
    lookahead window. Every path covers the same frames, so raw lowres
    SATD sums compare directly; B frames get a small discount for the
    bi-average prediction gain the single-ref lowres sweep cannot see.
    Returns the queue index of the FIRST anchor on the best path (the
    window re-optimises as it slides, like the reference)."""
    n = len(queue_lows)
    if n <= 1:
        return 0
    lows = [anchor_low] + list(queue_lows)   # lows[i+1] == queue[i]
    maxlen = max_bs + 1                      # frames per mini-GOP
    pairs = []
    idx = {}

    def want(cur, ref):
        key = (cur, ref)
        if key not in idx:
            idx[key] = len(pairs)
            pairs.append((lows[cur], lows[ref]))

    for a in range(0, n):                    # a = previous anchor position
        for m in range(a + 1, min(a + maxlen, n) + 1):
            want(m, a)                       # fwd: frame m from anchor a
    for j in range(2, n + 1):                # j = next anchor position
        for m in range(max(1, j - max_bs), j):
            want(m, j)                       # bwd: frame m from anchor j
    costs = batched_pair_costs(pairs)

    def blk(cur, ref):
        return costs[idx[(cur, ref)]]

    sums = {}

    def psum(cur, ref):
        key = (cur, ref)
        if key not in sums:
            sums[key] = float(blk(cur, ref).sum())
        return sums[key]

    def bcost(m, a, j):
        """Per-block B estimate: best of fwd, bwd and the bi average
        (averaging two decent predictions beats either — the
        0.72 factor is the noise-variance gain of the mean)."""
        f = blk(m, a)
        b = blk(m, j)
        key = (id(f), id(b))
        ent = _BCOST_CACHE.get(key)
        if ent is not None and ent[0] is f and ent[1] is b:
            _BCOST_CACHE.move_to_end(key)
            return ent[2]
        ff = f.astype(np.float64)
        bb = b.astype(np.float64)
        v = float(np.minimum(np.minimum(ff, bb), 0.36 * (ff + bb)).sum())
        _BCOST_CACHE[key] = (f, b, v)
        while len(_BCOST_CACHE) > _PAIR_CACHE_MAX:
            _BCOST_CACHE.popitem(last=False)
        return v

    INF = float("inf")
    dp = [INF] * (n + 1)
    dp[0] = 0.0
    prev = [0] * (n + 1)
    for j in range(1, n + 1):
        for a in range(max(0, j - maxlen), j):
            if dp[a] == INF:
                continue
            total = dp[a] + psum(j, a)               # the anchor's P cost
            for m in range(a + 1, j):                # its B frames
                total += b_discount * bcost(m, a, j)
            if total < dp[j]:
                dp[j] = total
                prev[j] = a
    j = n
    while prev[j] != 0:
        j = prev[j]
    return j - 1
