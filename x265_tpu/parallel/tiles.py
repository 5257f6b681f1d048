"""Tile-parallel frame analysis over a device mesh — the batched
re-imagining of x265's intra-frame parallelism (SURVEY.md §2.4):

  P1 (WPP rows)      -> CTU-row bands sharded over the `tile` mesh axis;
                        the wavefront disappears because analysis is
                        neighbor-free batched math, and the serial CABAC
                        finalizer runs per band (per-tile substreams).
  P2 (frame threads) -> reference-row halos: each band's motion search
                        needs R rows of the reference band above/below,
                        exchanged with jax.lax.ppermute over NVLink (the
                        m_reconRowFlag wait, frameencoder.cpp:860,
                        becomes a collective).
  RC state           -> per-band SATD complexity psum'd to a global
                        frame cost (the rateControlStart input).

Bands are horizontal CTU-row stripes: contiguous rows shard with
PartitionSpec("tile", None) with zero data movement.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from x265_tpu.models.intra_frame import frame_intra_analysis


def make_tile_mesh(n_devices: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:n_devices]
    return Mesh(np.array(devices), axis_names=("tile",))


def _band_step(y_band, ref_band, S, R, n_tiles):
    """Per-device work: intra analysis of the band + integer ME of the
    band's blocks against the reference band extended by halo rows."""
    perm_down = [(i, (i + 1) % n_tiles) for i in range(n_tiles)]
    perm_up = [((i + 1) % n_tiles, i) for i in range(n_tiles)]

    # --- halo exchange (P2): R reference rows from both neighbors ---
    halo_from_above = jax.lax.ppermute(ref_band[-R:, :], "tile", perm_down)
    halo_from_below = jax.lax.ppermute(ref_band[:R, :], "tile", perm_up)
    # frame edges: the ring wraps band 0's "rows above" to the bottom
    # band — overwrite with edge-replicated rows (extendPicBorder
    # semantics, reference picyuv.cpp/frameencoder.cpp:860)
    tid = jax.lax.axis_index("tile")
    top_rep = jnp.broadcast_to(ref_band[:1, :], halo_from_above.shape)
    bot_rep = jnp.broadcast_to(ref_band[-1:, :], halo_from_below.shape)
    halo_from_above = jnp.where(tid == 0, top_rep, halo_from_above)
    halo_from_below = jnp.where(tid == n_tiles - 1, bot_rep,
                                halo_from_below)
    ref_ext = jnp.concatenate([halo_from_above, ref_band, halo_from_below],
                              axis=0)                      # [band+2R, W]

    # --- intra analysis: batched 35-mode search on the band ---
    modes, icost = frame_intra_analysis(y_band, S=S)

    # --- inter: dense displacement sweep against the extended ref ---
    H, W = y_band.shape
    nby, nbx = H // S, W // S
    ref_pad = jnp.pad(ref_ext, ((0, 0), (R, R)), mode="edge")
    n = 2 * R + 1

    def body(best, d):
        dy = d // n
        dx = d % n
        sh = jax.lax.dynamic_slice(ref_pad, (dy, dx), (H, W))
        sad = jnp.abs(y_band - sh).reshape(nby, S, nbx, S).sum(axis=(1, 3))
        return jnp.minimum(best, sad), None

    # carry must be device-varying inside shard_map (see jax shard_map
    # scan-vma docs); tie it to the band data
    init = jnp.full((nby, nbx), 1 << 30, jnp.int32) + 0 * y_band[0, 0]
    mcost, _ = jax.lax.scan(body, init, jnp.arange(n * n))

    # --- rate-control state: global frame complexity via psum ---
    band_cost = jnp.minimum(icost.reshape(nby, nbx),
                            mcost.astype(jnp.float32) * 2).sum()
    frame_cost = jax.lax.psum(band_cost, "tile")
    return modes, icost, mcost, frame_cost


def sharded_frame_analysis(mesh: Mesh, y: np.ndarray, ref: np.ndarray,
                           S: int = 16, R: int = 8):
    """Analyze one frame with CTU-row bands sharded over `mesh`.

    y, ref: [H, W] int32 with H a multiple of S * n_tiles.
    Returns (modes [nB], icost [nB], mcost [nby, nbx], frame_cost scalar).
    """
    n_tiles = mesh.devices.size
    H, W = y.shape
    assert H % (S * n_tiles) == 0, (H, S, n_tiles)

    from jax.experimental.shard_map import shard_map
    step = jax.jit(shard_map(
        partial(_band_step, S=S, R=R, n_tiles=n_tiles),
        mesh=mesh,
        in_specs=(P("tile", None), P("tile", None)),
        out_specs=(P("tile"), P("tile"), P("tile", None), P()),
    ))
    sharding = NamedSharding(mesh, P("tile", None))
    y_dev = jax.device_put(np.asarray(y, dtype=np.int32), sharding)
    ref_dev = jax.device_put(np.asarray(ref, dtype=np.int32), sharding)
    return step(y_dev, ref_dev)


def mesh_intra_decisions(mesh: Mesh, y: np.ndarray, width: int, height: int,
                         cu_log2: int = 4, fast: bool = False,
                         psy: float = 0.0):
    """Whole-frame intra analysis with the input sharded in CTU-row bands
    over the mesh — XLA GSPMD partitions the SAME jitted graph the
    single-chip path runs, so the decisions are identical by construction
    (blocks are neighbor-free; SURVEY §7.1 "batch over CTUs").

    Returns (FrameDecisions, icost grid) like
    models.intra_frame.decide_intra_frame_device_with_cost. `psy`/`fast` must
    match the single-device call exactly — a mesh must never change the
    stream (dryrun_multichip byte-equality gate).
    """
    from x265_tpu.models.intra_frame import (
        _build_decisions, frame_intra_analysis)
    S = 1 << cu_log2
    n = mesh.devices.size
    ph = -(-height // (S * n)) * (S * n)   # band-divisible padding
    pw = -(-width // S) * S
    yp = np.pad(np.asarray(y, dtype=np.int32),
                ((0, ph - height), (0, pw - width)), mode="edge")
    sharding = NamedSharding(mesh, P("tile", None))
    y_dev = jax.device_put(yp, sharding)
    modes, cost = frame_intra_analysis(y_dev, S=S, fast=fast,
                                       psy=float(psy))
    modes = np.asarray(modes)
    dec = _build_decisions(modes, cu_log2, width, height, ph, pw)
    # crop to the single-device grid shape (band padding may add rows)
    ph1 = -(-height // S) * S
    icost = np.asarray(cost).reshape(ph // S, pw // S)[:ph1 // S]
    return dec, icost
