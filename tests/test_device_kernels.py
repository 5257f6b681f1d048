"""CPU tests of the device kernels the encoder runs through XLA: the MC
gather + interpolation, the block gathers, SATD and the integer search
against numpy references; the precision pinned on every float32 matrix
product; where the compile cache lives.
"""
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
from jax.extend import core as jex_core
import numpy as np
import pytest

from x265_tpu.engine.me import _gather_phase_blocks, _int_search, satd8_batched
from x265_tpu.engine.mode_decision import satd
from x265_tpu.models.inter_residual import (_CHROMA_FILT, _LUMA_FILT,
                                            _mc_gather, gather_src_blocks)
from x265_tpu.ops.ref import gather as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mc_case(n, taps, bd, N=48, seed=0):
    rng = np.random.default_rng(seed + n + bd)
    pad = 24 if n <= 16 else 80
    H, W = 2 * n + 16, 3 * n + 16
    planes = rng.integers(0, 1 << bd, (2, H + 2 * pad, W + 2 * pad))
    fb = 2 if taps == 8 else 3
    lim = (pad - 8) << fb                 # windows stay inside the pad
    ridx = rng.integers(0, 2, N)
    x0 = rng.integers(0, W - n + 1, N)
    y0 = rng.integers(0, H - n + 1, N)
    mvx = rng.integers(-lim, lim, N)
    mvy = rng.integers(-lim, lim, N)
    filt = _LUMA_FILT if taps == 8 else _CHROMA_FILT
    return (planes.astype(np.int16), ridx, x0, y0, mvx, mvy, filt, fb, pad)


@pytest.mark.parametrize("n,taps,bd", [(16, 8, 8), (8, 4, 8), (32, 8, 10),
                                       (64, 8, 8)])
def test_mc_gather_matches_reference(n, taps, bd):
    planes, ridx, x0, y0, mvx, mvy, filt, fb, pad = _mc_case(n, taps, bd)
    j = [jnp.asarray(a, jnp.int32) for a in (ridx, x0, y0, mvx, mvy)]
    got = _mc_gather(jnp.asarray(planes), *j, jnp.asarray(filt), fb, n,
                     taps, pad, bd)
    want = ref.mc_lanes(planes, ridx, x0, y0, mvx, mvy, n, taps, pad, bd)
    assert np.array_equal(np.asarray(got), want)


def test_gather_src_blocks_clamp_and_sentinel_lanes():
    rng = np.random.default_rng(3)
    H, W, S = 48, 80, 16
    src = rng.integers(0, 1024, (H, W)).astype(np.int16)
    yy = rng.integers(0, H - S + 1, 40)
    xx = rng.integers(0, W - S + 1, 40)
    yy[:4] = 1 << 20                       # padding-lane sentinel
    xx[4:8] = -5                           # counts from the end
    yy[8:12] = H - 3                       # clamped back inside
    xx[12:16] = W
    got = np.asarray(gather_src_blocks(jnp.asarray(src), jnp.asarray(yy),
                                       jnp.asarray(xx), S))
    assert got.dtype == np.int32
    assert np.array_equal(got, ref.src_blocks(src, yy, xx, S))


def test_gather_phase_blocks_clamp_and_sentinel_lanes():
    rng = np.random.default_rng(4)
    S, Hm, Wm, N = 8, 30, 44, 40
    planes = rng.integers(0, 256, (4, 4, Hm, Wm)).astype(np.int16)
    fy = rng.integers(0, 4, N)
    fx = rng.integers(0, 4, N)
    iy = rng.integers(-3, Hm, N)
    ix = rng.integers(-3, Wm, N)
    fy[:3] = 9                             # out-of-range phase
    fx[3:6] = -1
    iy[6:9] = 1 << 20
    got = np.asarray(_gather_phase_blocks(
        jnp.asarray(planes), *(jnp.asarray(a, jnp.int32)
                               for a in (fy, fx, iy, ix)), S))
    assert np.array_equal(got, ref.phase_blocks(planes, fy, fx, iy, ix, S))


@pytest.mark.parametrize("bd", [8, 10])
def test_satd8_batched_matches_numpy_hadamard(bd):
    rng = np.random.default_rng(bd)
    a = rng.integers(0, 1 << bd, (37, 16, 16))
    b = rng.integers(0, 1 << bd, (37, 16, 16))
    got = np.asarray(satd8_batched(jnp.asarray(a, jnp.int32),
                                   jnp.asarray(b, jnp.int32)))
    # engine.mode_decision.satd rounds the whole block's sum once; the
    # batched form floors each 8x8 tile, so compare per 8x8 tile
    want = [sum(satd((a[i] - b[i])[y:y + 8, x:x + 8])
                for y in (0, 8) for x in (0, 8)) for i in range(len(a))]
    assert got.tolist() == want


def test_int_search_matches_dense_reference():
    rng = np.random.default_rng(4)
    H, W, R, S = 32, 48, 3, 16
    cur = rng.integers(0, 256, (H, W)).astype(np.int32)
    refp = rng.integers(0, 256, (H + 2 * R, W + 2 * R)).astype(np.int32)
    n = 2 * R + 1
    mvcost = np.zeros(n * n, np.float32)
    idx, cost, sad = (np.asarray(a) for a in _int_search(
        jnp.asarray(cur), jnp.asarray(refp), jnp.asarray(mvcost), S, R))
    sads = np.stack([
        np.abs(cur - refp[d // n:d // n + H, d % n:d % n + W])
        .reshape(H // S, S, W // S, S).sum((1, 3)) for d in range(n * n)])
    assert np.array_equal(sad, sads.min(axis=0))
    assert np.array_equal(idx, sads.argmin(axis=0))   # first minimum wins


def _float_dot_precisions(jaxpr):
    """precision of every dot_general with float operands, nested jaxprs
    included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and jnp.issubdtype(
                eqn.invars[0].aval.dtype, jnp.floating):
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                if isinstance(sub, jex_core.ClosedJaxpr):
                    out += _float_dot_precisions(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    out += _float_dot_precisions(sub)
    return out


def _intra_frame_jaxpr():
    from x265_tpu.models.intra_frame import frame_intra_analysis
    return jax.make_jaxpr(partial(frame_intra_analysis, S=8))(
        jnp.zeros((32, 48), jnp.int32))


def _intra32_jaxpr():
    from x265_tpu.hevc.rate_model import rdoq_rate_consts
    from x265_tpu.models.intra_rdo import _intra32_costs
    G = 2
    with jax.enable_x64():
        return jax.make_jaxpr(partial(
            _intra32_costs, bd=8, sdh=True, do_rdoq=True, scaling=False,
            cb_off=0, cr_off=0, psy=1.0))(
            jnp.zeros((64, 64), jnp.int32), jnp.zeros((32, 32), jnp.int32),
            jnp.zeros((32, 32), jnp.int32), jnp.zeros((G, 2), jnp.int32),
            jnp.ones((G, 4), jnp.int32), jnp.ones((G,), jnp.float32),
            jnp.full((G,), 30, jnp.int32),
            jnp.asarray(rdoq_rate_consts(0, 30)))


def _scaler_jaxpr():
    from x265_tpu.io.scaler import _poly_apply
    return jax.make_jaxpr(_poly_apply)(
        jnp.zeros((12, 20), jnp.uint8), jnp.zeros((9, 12), jnp.float32),
        jnp.zeros((15, 20), jnp.float32))


@pytest.mark.parametrize("make", [_intra_frame_jaxpr, _intra32_jaxpr,
                                  _scaler_jaxpr],
                         ids=["intra_frame", "intra_rdo", "scaler"])
def test_float_matmuls_pin_highest_precision(make):
    """float32 products that decide modes or pixels ask for full float32
    (a GPU would otherwise run them in TF32)."""
    precs = _float_dot_precisions(make().jaxpr)
    hi = jax.lax.Precision.HIGHEST
    assert precs, "no float matmul traced"
    assert all(p == (hi, hi) for p in precs), precs


def _cache_dir_of_fresh_process(env_cache):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "JAX_ENABLE_COMPILATION_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, x265_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_cache", [None, "elsewhere"])
def test_compile_cache_placement(env_cache, tmp_path):
    if env_cache is None:
        assert (_cache_dir_of_fresh_process(None)
                == os.path.join(REPO, ".jax_cache"))
    else:
        d = str(tmp_path / env_cache)
        assert _cache_dir_of_fresh_process(d) == d
