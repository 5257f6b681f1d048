"""Batched whole-frame intra mode analysis — the device compute graph.

This is the re-imagining of x265's Analysis::compressIntraCU +
Search::estIntraPredQT serial RDO loop (SURVEY.md §3.6) as dense device
computation: for lossless intra, reconstruction equals the source, so
prediction neighbors are source pixels and EVERY block's 35-mode search is
independent — the whole frame becomes two matrix contractions:

    preds[nB, 35, S²] = einsum('mpr,br->bmp', W, refs)      (prediction bank)
    satd  = |H8 · resid · H8ᵀ|                              (cost transform)

followed by an argmin over the mode axis. No wavefront needed. The serial
CABAC finalizer re-derives normative integer predictions, so these
decisions only steer RD — any outcome is a legal bitstream.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from x265_tpu.ops.intra_matrix import intra_weight_matrices

# full float32 products: a GPU may otherwise run them in TF32, and the
# rounded costs then decide other modes than the CPU path pins down
_HIGHEST = jax.lax.Precision.HIGHEST


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def extract_block_refs(y: jnp.ndarray, S: int) -> jnp.ndarray:
    """Reference vectors [nB, 4S+1] for every SxS block of a padded frame.

    Edge-replication stands in for the spec's unavailable-sample
    substitution (decision-only approximation; the finalizer is exact).
    Layout matches ops.ref.intra: left bottom-up, corner, top.
    """
    H, W = y.shape
    yp = jnp.pad(y, ((1, 2 * S), (1, 2 * S)), mode="edge")
    nby, nbx = H // S, W // S
    by = jnp.arange(nby) * S
    bx = jnp.arange(nbx) * S

    # top rows: yp[by, bx+1 : bx+1+2S]  (row above each block, 2S wide)
    offs = jnp.arange(2 * S)
    top = yp[by[:, None, None], (bx[None, :, None] + 1 + offs[None, None, :])]
    # left cols: yp[by+1 : by+1+2S, bx]
    left = yp[(by[:, None, None] + 1 + offs[None, None, :]), bx[None, :, None]]
    corner = yp[by[:, None], bx[None, :]]

    left_rev = left[:, :, ::-1]                    # bottom-up
    refs = jnp.concatenate(
        [left_rev, corner[:, :, None], top], axis=-1)   # [nby, nbx, 4S+1]
    return refs.reshape(nby * nbx, 4 * S + 1)


# --fast-intra (x265 param.bEnableFastIntra): coarse angular scan —
# planar/DC + every 4th angle (intrapred "allangs" subset idea)
_FAST_MODES = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34], np.int32)


@partial(jax.jit, static_argnames=("S", "lambda_bits", "fast", "psy"))
def frame_intra_analysis(y: jnp.ndarray, S: int = 16,
                         lambda_bits: float = 2.0,
                         fast: bool = False,
                         psy: float = 0.0) -> jnp.ndarray:
    """y: [H, W] (multiples of S) uint8/int32 -> best mode per block [nB].

    psy > 0 adds the psychovisual energy term to every candidate: the
    AC-energy difference |E(source) - E(prediction)| weighted by psy-rd
    (x265 applies calcPsyRdCost in every intra mode comparison,
    rdcost.h:48 / search.cpp:2112; energy model = pixel.cpp:727
    psyCost_pp sa8d-minus-DC, shared with models/rdo._psy_energy8)."""
    H, W = y.shape
    yf = y.astype(jnp.float32)
    refs = extract_block_refs(yf, S)                         # [nB, R]
    Wm = jnp.asarray(intra_weight_matrices(S))               # [35, S², R]
    if fast:
        Wm = Wm[jnp.asarray(_FAST_MODES)]

    # prediction bank: one big contraction
    preds = jnp.einsum("mpr,br->bmp", Wm, refs,
                       preferred_element_type=jnp.float32,   # [nB, 35, S²]
                       precision=_HIGHEST)

    # source blocks [nB, S²]
    nby, nbx = H // S, W // S
    blocks = yf.reshape(nby, S, nbx, S).transpose(0, 2, 1, 3).reshape(-1, S * S)

    resid = preds - blocks[:, None, :]                       # [nB, nm, S²]
    # SATD over 8x8 tiles via Hadamard matmuls
    k = 8 if S >= 8 else 4
    h = jnp.asarray(_hadamard(k), dtype=jnp.float32)
    nm = Wm.shape[0]

    def had(x, lead):
        r = x.reshape((-1,) + lead + (S // k, k, S // k, k))
        r = jnp.moveaxis(r, -3, -2)                          # [..., k, k]
        return jnp.einsum("ij,...jk,kl->...il", h, r, h,
                          preferred_element_type=jnp.float32,
                          precision=_HIGHEST)

    t = had(resid, (nm,))
    norm = 4.0 if k == 8 else 2.0
    satd = jnp.sum(jnp.abs(t), axis=(-1, -2, -3, -4)) / norm

    # rough mode-bit bias: non-MPM modes cost ~4 extra bins
    bias = jnp.full((nm,), 4.0 * lambda_bits, dtype=jnp.float32)
    bias = bias.at[0].set(0.0).at[1].set(2.0 * lambda_bits)
    cost = satd + bias[None, :]
    if psy > 0:
        def ac_energy(x, lead):
            tt = had(x, lead)
            dc = jnp.abs(tt[..., 0, 0]).sum(axis=(-1, -2))
            return (jnp.abs(tt).sum(axis=(-1, -2, -3, -4)) - dc) / norm
        e_src = ac_energy(blocks, ())                        # [nB]
        e_pred = ac_energy(preds, (nm,))                     # [nB, nm]
        cost = cost + psy * jnp.abs(e_src[:, None] - e_pred)
    best = jnp.argmin(cost, axis=1).astype(jnp.int32)        # [nB]
    if fast:
        best = jnp.asarray(_FAST_MODES)[best]
    return best, jnp.min(cost, axis=1)


from functools import lru_cache


@lru_cache(maxsize=8)
def _batched_analysis(S: int, fast: bool = False, psy: float = 0.0):
    return jax.jit(jax.vmap(
        lambda y: frame_intra_analysis(y, S=S, fast=fast, psy=psy)))


def submit_intra_analysis_batch(srcs, width: int, height: int,
                                cu_log2: int = 4, fast: bool = False,
                                psy: float = 0.0):
    """One dispatch for a whole batch of frames (vmapped analysis): N
    frames per host round trip beats N round trips (the frame-pipeline
    P2 batching form)."""
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    wire = np.uint8 if max(int(np.asarray(s).max(initial=0))
                           for s in srcs) < 256 else np.int16
    yp = np.stack([np.pad(np.asarray(s, dtype=wire),
                          ((0, ph - height), (0, pw - width)), mode="edge")
                   for s in srcs])
    modes_dev, cost_dev = _batched_analysis(S, fast, float(psy))(
        jnp.asarray(yp))
    return [(modes_dev[i], cost_dev[i], cu_log2, width, height)
            for i in range(len(srcs))]


def submit_intra_analysis(src_y: np.ndarray, width: int, height: int,
                          cu_log2: int = 4, fast: bool = False,
                          psy: float = 0.0):
    """Dispatch the batched analysis; returns an opaque handle whose device
    buffers materialize asynchronously (frame-pipeline building block: the
    device computes frame N+1 while the CPU finalizer writes frame N — the
    x265 frame-parallelism analog, SURVEY.md §2.4 P2)."""
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    # narrow wire + shared upload: the source plane is consumed by the
    # lookahead, the motion search and the residual pipeline too — the
    # identity-keyed device cache uploads it ONCE per frame, and the
    # S-padding happens on device (the host->device link is the
    # bottleneck on this box)
    from x265_tpu.engine.planes import pad_dev
    from x265_tpu.utils import devcache
    arr = np.asarray(src_y)
    bd = 8 if arr.dtype == np.uint8 else 10
    ydev = devcache.src_plane(arr, bd)
    yp = pad_dev(ydev, (0, ph - height, 0, pw - width))
    modes_dev, cost_dev = _batched_analysis(S, fast, float(psy))(yp[None])
    modes_dev, cost_dev = modes_dev[0], cost_dev[0]
    return (modes_dev, cost_dev, cu_log2, width, height)


def finish_intra_analysis(handle) -> "FrameDecisions":
    """Materialize a submit_intra_analysis result into decision maps."""
    modes_dev, _cost, cu_log2, width, height = handle
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    modes = np.asarray(modes_dev)
    return _build_decisions(modes, cu_log2, width, height, ph, pw)


def decide_intra_frame_device(src_y: np.ndarray, width: int, height: int,
                           cu_log2: int = 4,
                           fast: bool = False,
                           psy: float = 0.0) -> "FrameDecisions":
    """Drop-in replacement for engine.mode_decision.decide_intra_frame:
    batched device analysis at S=2^cu_log2 with 8x8 boundary fallback."""
    return finish_intra_analysis(
        submit_intra_analysis(src_y, width, height, cu_log2, fast, psy))


def decide_intra_frame_device_with_cost(src_y: np.ndarray, width: int,
                                     height: int, cu_log2: int = 4,
                                     fast: bool = False, psy: float = 0.0):
    """Like decide_intra_frame_device but also returns the per-block intra
    cost grid [ph/S, pw/S] — one dispatch serves both the mode decisions
    and the inter/intra comparator (the analysis already computed it)."""
    h = submit_intra_analysis(src_y, width, height, cu_log2, fast,
                              psy)
    dec = finish_intra_analysis(h)
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    icost = np.asarray(h[1]).reshape(ph // S, pw // S)
    return dec, icost


def _build_decisions(modes, cu_log2, width, height, ph, pw):
    from x265_tpu.engine.ctu_writer import FrameDecisions

    S = 1 << cu_log2
    nby, nbx = ph // S, pw // S
    h8, w8 = height >> 3, width >> 3
    rep = S >> 3
    luma_mode8 = np.repeat(np.repeat(modes.reshape(nby, nbx), rep, axis=0),
                           rep, axis=1)[:h8, :w8].astype(np.int32)
    # boundary: fall back to 8x8 CUs where an S-block crosses the pic edge
    cu_log2_map = np.full((h8, w8), cu_log2, dtype=np.int32)
    bx8 = np.arange(w8)
    by8 = np.arange(h8)
    x0 = (bx8 >> (cu_log2 - 3)) << cu_log2
    y0 = (by8 >> (cu_log2 - 3)) << cu_log2
    cross = (y0[:, None] + S > height) | (x0[None, :] + S > width)
    cu_log2_map[cross] = 3
    return FrameDecisions(cu_log2_map=cu_log2_map, luma_mode8=luma_mode8)
