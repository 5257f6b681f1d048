"""Per-kernel speed-report harness (the TestBench analog, reference
test/TestBench.cpp:98-271: every primitive is timed against its C
reference and reported as a table).

Times each registered kernel on the GPU (median wall of --iters runs
after warm-up, each ending in block_until_ready) and prints one JSON
line per kernel: {kernel, shape, ms, items_per_s, device}. Cases that
declare the bytes they must move also report GB/s and the share of the
card's published memory bandwidth. A large plain copy gives the
bandwidth yardstick that XLA reaches on the card.

Usage (GPU only; exits non-zero elsewhere):
    python tools/kernel_bench.py [--quick] [--iters 9] [--only NAME]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# Published peak memory bandwidth by JAX device_kind (NVIDIA H100 data
# sheet). Every case here is bound by memory, not arithmetic. A device
# that is not listed is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0},     # H100 SXM
    "NVIDIA H100 PCIe": {"hbm_gbps": 2000.0},
}


def device_peaks():
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"kernel_bench needs a GPU; JAX found {d.platform}")
    if d.device_kind not in PEAKS:
        sys.exit(f"no published peaks for device_kind {d.device_kind!r}")
    return d.device_kind, PEAKS[d.device_kind]


def card_name_and_power_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip()


def _time(fn, iters):
    import jax
    for _ in range(2):                       # warm-up / compile
        jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def mc_case_inputs(rng, n, taps, bd, quick):
    """MC lanes at the 1080p shapes: planes [2, H+2*pad, W+2*pad] int16
    (chroma planes at half size), 40 800 lanes, MVs inside the padding."""
    import jax.numpy as jnp
    from x265_tpu.models.inter_residual import _CHROMA_FILT, _LUMA_FILT
    luma = taps == 8
    Hm, Wm = (288, 352) if quick else (1088, 1920)
    pad = 80
    if not luma:
        Hm, Wm, pad = Hm // 2, Wm // 2, pad // 2
    NL = 4096 if quick else 40800
    fb = 2 if luma else 3
    lim = (pad - 8) << fb
    planes = jnp.asarray(rng.integers(
        0, 1 << bd, (2, Hm + 2 * pad, Wm + 2 * pad)).astype(np.int16))
    ridx = jnp.asarray(rng.integers(0, 2, NL).astype(np.int32))
    x0 = jnp.asarray((rng.integers(0, (Wm - n) // n + 1, NL) * n)
                     .astype(np.int32))
    y0 = jnp.asarray((rng.integers(0, (Hm - n) // n + 1, NL) * n)
                     .astype(np.int32))
    mvx = jnp.asarray(rng.integers(-lim, lim, NL).astype(np.int32))
    mvy = jnp.asarray(rng.integers(-lim, lim, NL).astype(np.int32))
    filt = jnp.asarray(_LUMA_FILT if luma else _CHROMA_FILT)
    return dict(planes=planes, ridx=ridx, x0=x0, y0=y0, mvx=mvx, mvy=mvy,
                filt=filt, fb=fb, n=n, taps=taps, pad=pad, bd=bd)


def build_cases(quick: bool):
    import jax
    import jax.numpy as jnp
    from x265_tpu.engine.me import satd8_batched, _int_search
    from x265_tpu.models.inter_residual import _mc_gather
    from x265_tpu.models.residual import (fwd_transform_b, quantize_b,
                                          dequantize_b, inv_transform_b)

    rng = np.random.default_rng(7)
    N = 1024 if quick else 8192
    a = jnp.asarray(rng.integers(0, 256, (N, 16, 16)).astype(np.int32))
    b = jnp.asarray(rng.integers(0, 256, (N, 16, 16)).astype(np.int32))

    H, W = (288, 352) if quick else (720, 1280)
    R = 8 if quick else 16
    cur = jnp.asarray(rng.integers(0, 256, (H, W)).astype(np.int32))
    refp = jnp.asarray(rng.integers(0, 256,
                                    (H + 2 * R, W + 2 * R)).astype(np.int32))
    mvcost = jnp.zeros(((2 * R + 1) ** 2,), jnp.float32)

    cases = [
        ("satd_16x16/xla", f"[{N},16,16]", N,
         lambda: satd8_batched(a, b), None),
        ("sad_sweep/xla", f"{W}x{H} R{R}", (2 * R + 1) ** 2,
         lambda: _int_search(cur, refp, mvcost, 16, R), None),
    ]
    # the s32 transform einsums at the shapes the smoke checks
    for n, M in ((16, 2048 if quick else 16384), (32, 512 if quick else 4096)):
        resi = jnp.asarray(rng.integers(-255, 256, (M, n, n))
                           .astype(np.int32))
        qp = jnp.full((M,), 30, jnp.int32)
        coef = fwd_transform_b(resi, n, False, 8)
        lvl = quantize_b(coef, qp, n, False, 8)
        nbytes = M * n * n * 8              # read + write int32
        cases += [
            (f"dct{n}/xla", f"[{M},{n},{n}]", M,
             lambda r=resi, n=n: fwd_transform_b(r, n, False, 8), nbytes),
            (f"idct{n}/xla", f"[{M},{n},{n}]", M,
             lambda c=coef, n=n: inv_transform_b(c, n, False, 8), nbytes),
            (f"quant{n}/xla", f"[{M},{n},{n}]", M,
             lambda c=coef, q=qp, n=n: quantize_b(c, q, n, False, 8),
             nbytes),
            (f"dequant{n}/xla", f"[{M},{n},{n}]", M,
             lambda l=lvl, q=qp, n=n: dequantize_b(l, q, n, 8), nbytes),
        ]
    # the block gathers the encoder runs through XLA (1080p lanes)
    from x265_tpu.engine.me import _gather_phase_blocks
    from x265_tpu.models.inter_residual import gather_src_blocks
    S = 16
    nb = (1088 // S) * (1920 // S)
    src = jnp.asarray(rng.integers(0, 256, (1088, 1920)).astype(np.int16))
    yy = jnp.asarray(rng.integers(0, 1088 - S, nb).astype(np.int32))
    xx = jnp.asarray(rng.integers(0, 1920 - S, nb).astype(np.int32))
    phases = jnp.asarray(rng.integers(0, 256, (4, 4, 292, 500))
                         .astype(np.int16))
    f4 = jnp.asarray(rng.integers(0, 4, nb).astype(np.int32))
    f4r, yq, xq = f4[::-1], yy // 4, xx // 4
    gsrc = jax.jit(lambda s, y, x: gather_src_blocks(s, y, x, S))
    gph = jax.jit(lambda p, a, b, y, x: _gather_phase_blocks(
        p, a, b, y, x, S))
    gbytes = nb * S * S * (2 + 4)
    cases += [
        ("gather_src_blocks16/xla", f"[{nb}] 16x16 of 1088x1920", nb,
         lambda: gsrc(src, yy, xx), gbytes),
        ("gather_phase_blocks16/xla", f"[{nb}] 16x16 of 4x4x292x500", nb,
         lambda: gph(phases, f4, f4r, yq, xq), gbytes),
    ]
    # MC gather + interpolation at the 1080p lane count
    for (n, taps, bd) in ((16, 8, 8), (16, 8, 10), (8, 4, 8), (8, 4, 10)):
        k = mc_case_inputs(rng, n, taps, bd, quick)
        side = n + taps - 1
        NL = k["x0"].shape[0]
        # useful bytes: each lane reads a side x side int16 window and
        # writes an n x n int32 block
        nbytes = NL * (side * side * 2 + n * n * 4)
        args = (k["planes"], k["ridx"], k["x0"], k["y0"], k["mvx"],
                k["mvy"], k["filt"])
        xla = jax.jit(lambda *a, k=k: _mc_gather(
            *a, fb=k["fb"], n=k["n"], taps=k["taps"], pad=k["pad"],
            bd=k["bd"]))
        tag = f"mc_gather{n}x{taps}tap_{bd}bit"
        cases.append((f"{tag}/xla", f"[{NL}] {side}x{side}", NL,
                      lambda f=xla, a=args: f(*a), nbytes))
    # what a large plain copy reaches on this card (bandwidth yardstick)
    big = jnp.ones((256 * 1024 * 1024,), jnp.int32)
    cases.append(("copy_1GiB/xla", "[2^28] int32", big.size,
                   lambda: big + 1, big.size * 8))
    return cases


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--only", default="",
                    help="run only the cases whose name contains this")
    args = ap.parse_args()

    kind, peaks = device_peaks()
    card = card_name_and_power_limit()
    print(json.dumps({"device_kind": kind, "nvidia_smi": card}))
    for name, shape, items, fn, nbytes in build_cases(args.quick):
        if args.only and args.only not in name:
            continue
        print(f"[kernel_bench] {name} ...", file=sys.stderr, flush=True)
        ms = _time(fn, args.iters) * 1000.0
        rec = {"kernel": name, "shape": shape, "ms": ms,
               "items_per_s": items / (ms / 1000.0), "device": kind}
        if nbytes:
            gbps = nbytes / (ms / 1000.0) / 1e9
            rec["useful_gbps"] = gbps
            rec["pct_peak_hbm"] = 100.0 * gbps / peaks["hbm_gbps"]
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
