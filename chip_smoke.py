"""GPU smoke test: the encoder's main path on one NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py            # phases 1-5 on one GPU
    python chip_smoke.py --four     # phase 6 only: 4-GPU mesh vs 1 GPU

Phases, in order; the first failure ends the run with a non-zero exit
code and no result line:

1. device: nvidia-smi name and power limit, JAX version and devices;
   fails unless JAX's default device is a GPU.
2. native finalizer: builds the C++ slice writer from the committed
   sources on this host and loads it.
3. kernels against their plain references on the GPU at 1080p widths:
   MC gather + interpolation (ops/ref/interp.py), source and phase-plane
   block gathers (numpy, out-of-range lanes included), transforms and
   quant (ops/ref/transform.py), whole-frame intra analysis (the same
   call on the CPU device of this process).
4. main path: the CLI encodes a 1080p clip (medium, 4000 kb/s, 16
   frames + flush) twice and a 720p clip (ultrafast, lossless, all
   intra, 8 frames); the in-repo decoder decodes every stream
   bit-exactly to its recon, the lossless one also to its source, and
   the two 1080p encodes are identical byte for byte.
5. ``pytest -m gpu`` in this process.
6. (--four only) the 1080p clip with 4 slices through
   ``Encoder.attach_mesh`` on 4 GPUs and on one GPU: identical bytes.

Everything runs in this one process: a JAX process reserves most of
the card's memory, so a second one could not use it. The last line of
standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")       # clips, streams, recons
N1080, N720 = 16, 8                       # frames of the two encodes


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """Card name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# ---------------------------------------------------------------- phase 1
def phase_device():
    import jax
    devs = jax.devices()
    log(f"jax {jax.__version__}; devices {devs}")
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(f"JAX's default device is {d.platform}, not gpu")
    log(f"device_kind: {d.device_kind}")
    log(f"card: {card()}")
    sys.path.insert(0, REPO)
    import x265_tpu  # noqa: F401  (fails outside the repository)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------- phase 2
def phase_native():
    from x265_tpu import native
    t0 = time.perf_counter()
    lib = native.get_lib()
    assert lib is not None
    log(f"native: {os.path.basename(native.lib_path())} loaded in "
        f"{time.perf_counter() - t0:.2f}s")


# ---------------------------------------------------------------- phase 3
def check_mc(n, taps, bd):
    """XLA's MC gather + interpolation vs ops/ref/interp.py."""
    import jax
    from tools.kernel_bench import mc_case_inputs
    from x265_tpu.models.inter_residual import _mc_gather
    from x265_tpu.ops.ref.gather import mc_lanes
    k = mc_case_inputs(np.random.default_rng(1000 + n + bd), n, taps, bd,
                       False)
    args = (k["planes"], k["ridx"], k["x0"], k["y0"], k["mvx"], k["mvy"],
            k["filt"])
    got = np.asarray(jax.jit(lambda *a: _mc_gather(
        *a, fb=k["fb"], n=n, taps=taps, pad=k["pad"], bd=bd))(*args))
    planes = np.asarray(k["planes"])
    ridx, x0, y0, mvx, mvy = (np.asarray(k[a]) for a in
                              ("ridx", "x0", "y0", "mvx", "mvy"))
    want = mc_lanes(planes, ridx, x0, y0, mvx, mvy, n, taps, k["pad"], bd)
    bad = int((got != want).any(axis=(1, 2)).sum())
    log(f"  mc {n}x{n} {taps}-tap {bd}-bit: planes {list(planes.shape)} "
        f"lanes {len(x0)}; bit-exact (int32), {bad} lanes differ")
    if bad:
        raise AssertionError(f"mc {n}/{taps}/{bd}: {bad} lanes")


def check_gathers():
    """gather_src_blocks / _gather_phase_blocks vs ops/ref/gather.py,
    with lanes whose origins fall outside the plane (padding
    sentinels)."""
    import jax.numpy as jnp
    from x265_tpu.engine.me import _gather_phase_blocks
    from x265_tpu.models.inter_residual import gather_src_blocks
    from x265_tpu.ops.ref.gather import phase_blocks, src_blocks
    H, W, S = 1088, 1920, 16
    rng = np.random.default_rng(5)
    src = rng.integers(0, 1024, (H, W)).astype(np.int16)
    N = (H // S) * (W // S)
    yy = rng.integers(0, H - S + 1, N).astype(np.int32)
    xx = rng.integers(0, W - S + 1, N).astype(np.int32)
    yy[:64] = 1 << 20                     # the padding-lane sentinel
    xx[64:128] = -5
    yy[128:192] = H - 3
    got = np.asarray(gather_src_blocks(jnp.asarray(src), jnp.asarray(yy),
                                       jnp.asarray(xx), S))
    want = src_blocks(src, yy, xx, S)
    bad = int((got != want).any(axis=(1, 2)).sum())
    log(f"  gather_src_blocks [{H},{W}] {N} lanes of {S}x{S}: bit-exact "
        f"(int32), {bad} lanes differ")
    if bad:
        raise AssertionError(f"gather_src_blocks: {bad} lanes")
    m = 10
    Hm, Wm = H // 4 + 2 * m, W // 4 + 2 * m
    planes = rng.integers(0, 256, (4, 4, Hm, Wm)).astype(np.int16)
    fy = rng.integers(0, 4, N).astype(np.int32)
    fx = rng.integers(0, 4, N).astype(np.int32)
    iy = rng.integers(-4, Hm, N).astype(np.int32)
    ix = rng.integers(-4, Wm, N).astype(np.int32)
    fy[:16] = 7                          # out-of-range phase
    got = np.asarray(_gather_phase_blocks(
        jnp.asarray(planes), jnp.asarray(fy), jnp.asarray(fx),
        jnp.asarray(iy), jnp.asarray(ix), S))
    want = phase_blocks(planes, fy, fx, iy, ix, S)
    bad = int((got != want).any(axis=(1, 2)).sum())
    log(f"  _gather_phase_blocks [4,4,{Hm},{Wm}] {N} lanes: bit-exact "
        f"(int32), {bad} lanes differ")
    if bad:
        raise AssertionError(f"_gather_phase_blocks: {bad} lanes")


def check_transforms():
    """Batched s32 transforms + quant vs ops/ref/transform.py."""
    import jax.numpy as jnp
    from x265_tpu.models.residual import (dequantize_b, fwd_transform_b,
                                          inv_transform_b, quantize_b)
    from x265_tpu.ops.ref import transform as ref
    rng = np.random.default_rng(9)
    for M, n in ((16384, 16), (4096, 32)):
        log2 = n.bit_length() - 1
        resi = rng.integers(-255, 256, (M, n, n)).astype(np.int32)
        qp = rng.integers(0, 52, M).astype(np.int32)
        coef = np.asarray(fwd_transform_b(jnp.asarray(resi), n, False, 8))
        lvl = np.asarray(quantize_b(jnp.asarray(coef), jnp.asarray(qp), n,
                                    False, 8))
        deq = np.asarray(dequantize_b(jnp.asarray(lvl), jnp.asarray(qp), n,
                                      8))
        rec = np.asarray(inv_transform_b(jnp.asarray(deq), n, False, 8))
        checks = (
            ("forward", coef, lambda i: ref.forward_transform(resi[i])),
            ("quant", lvl, lambda i: ref.quantize(coef[i], int(qp[i]), log2,
                                                  False)),
            ("dequant", deq, lambda i: np.clip(ref.dequantize(
                lvl[i], int(qp[i]), log2), -32768, 32767)),
            ("inverse", rec, lambda i: ref.inverse_transform(deq[i])),
        )
        for name, got, want_i in checks:
            want = np.stack([want_i(i) for i in range(M)])
            bad = int((got != want).any(axis=(1, 2)).sum())
            log(f"  {name} [{M},{n},{n}]: bit-exact (int32), {bad} blocks "
                f"differ")
            if bad:
                raise AssertionError(f"{name} {n}: {bad} blocks")


def check_intra():
    """frame_intra_analysis on the GPU vs the same call on the CPU
    device of this process (float32 products at HIGHEST precision)."""
    import jax
    import jax.numpy as jnp
    from x265_tpu.models.intra_frame import frame_intra_analysis
    from tools.make_clips import clip_crowd1080
    H, W = 1088, 1920
    y = next(clip_crowd1080(W=W, H=H, n=1))[0].astype(np.int32)
    for S in (16, 8):
        modes_d, cost_d = frame_intra_analysis(jnp.asarray(y), S=S)
        with jax.default_device(jax.devices("cpu")[0]):
            modes_c, cost_c = frame_intra_analysis(jnp.asarray(y), S=S)
        modes_d, cost_d, modes_c, cost_c = (
            np.asarray(a) for a in (modes_d, cost_d, modes_c, cost_c))
        nm = int((modes_d != modes_c).sum())
        nc = int((cost_d != cost_c).sum())
        log(f"  frame_intra_analysis {H}x{W} S={S}: {len(modes_d)} blocks; "
            f"tolerance exact, precision HIGHEST (float32); {nm} modes and "
            f"{nc} costs differ from the CPU device")
        if nm or nc:
            raise AssertionError(f"intra S={S}: {nm} modes, {nc} costs")


def phase_kernels():
    for (n, taps, bd) in ((16, 8, 8), (16, 8, 10), (8, 4, 8), (8, 4, 10)):
        check_mc(n, taps, bd)
    check_gathers()
    check_transforms()
    check_intra()


# ---------------------------------------------------------------- phase 4
def write_clip(name, nframes, path):
    """First frames of a tools/make_clips clip as Y4M."""
    from itertools import islice
    from tools.make_clips import CLIPS
    from x265_tpu.io.y4m import VideoInfo, write_y4m
    gen, W, H, _ = CLIPS[name]
    frames = [tuple(np.asarray(p) for p in f)
              for f in islice(gen(W=W, H=H, n=nframes), nframes)]
    write_y4m(path, frames, VideoInfo(W, H, 25, 1))
    return frames


def cli_encode(y4m, out, recon, opts):
    from x265_tpu import cli
    t0 = time.perf_counter()
    rc = cli.main(["--input", y4m, "--output", out, "--recon", recon]
                  + opts)
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    return time.perf_counter() - t0


def check_stream(hevc, recon_y4m, src):
    """Decode with the in-repo decoder; every picture must equal the
    recon bit-for-bit. Returns (pictures in display order, global luma
    PSNR of the recon against the source)."""
    from x265_tpu.decoder.decoder import HEVCDecoder
    from x265_tpu.io.y4m import open_input
    with open(hevc, "rb") as f:
        pics = sorted(HEVCDecoder().decode(f.read()), key=lambda q: q.poc)
    reader = open_input(recon_y4m)
    recon = [tuple(np.asarray(p, np.int32) for p in r)
             for r in reader.frames()]
    reader.close()
    if len(pics) != len(recon) or len(pics) != len(src):
        raise AssertionError(f"{hevc}: {len(pics)} pictures, "
                             f"{len(recon)} recon, {len(src)} source frames")
    for i, (pic, rec) in enumerate(zip(pics, recon)):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            if not np.array_equal(a, b):
                raise AssertionError(f"{hevc}: picture {i} != recon")
    se = sum(float(((r[0].astype(np.int64) - s[0]) ** 2).sum())
             for r, s in zip(recon, src))
    mse = se / (len(src) * src[0][0].size)
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    return pics, psnr


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def phase_main_path(crd):
    import jax
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    crowd = write_clip("crowd1080", N1080, os.path.join(WORK, "crowd.y4m"))
    pan = write_clip("pan720", N720, os.path.join(WORK, "pan.y4m"))
    log(f"  clips written in {time.perf_counter() - t0:.1f}s")

    def p(name):
        return os.path.join(WORK, name)

    medium = ["--preset", "medium", "--bitrate", "4000"]
    walls = [cli_encode(p("crowd.y4m"), p(f"crowd{run}.hevc"),
                        p(f"crowd{run}_rec.y4m"), medium) for run in (1, 2)]
    # the second encode must repeat the first byte for byte, recon too
    if _read(p("crowd1.hevc")) != _read(p("crowd2.hevc")):
        raise AssertionError("two 1080p encodes in one process differ")
    if _read(p("crowd1_rec.y4m")) != _read(p("crowd2_rec.y4m")):
        raise AssertionError("two 1080p recons in one process differ")
    t0 = time.perf_counter()
    pics, psnr = check_stream(p("crowd1.hevc"), p("crowd1_rec.y4m"), crowd)
    log(f"  1080p medium ABR: {len(pics)} frames, decode == recon "
        f"(in-repo decoder, {time.perf_counter() - t0:.1f}s), PSNR-Y "
        f"{psnr:.3f} dB, 2 encodes identical "
        f"({os.path.getsize(p('crowd1.hevc'))} bytes)")
    log(f"  1080p medium ABR: wall {walls[0]:.2f}s cold, {walls[1]:.2f}s "
        f"warm; fps after warm-up {N1080 / walls[1]:.3f}; warm-up "
        f"(compile) {walls[0] - walls[1]:.1f}s [{crd}]")

    ll = ["--preset", "ultrafast", "--lossless", "--keyint", "1"]
    wall = cli_encode(p("pan.y4m"), p("pan.hevc"), p("pan_rec.y4m"), ll)
    pics, psnr = check_stream(p("pan.hevc"), p("pan_rec.y4m"), pan)
    for pic, s in zip(pics, pan):
        for a, b in zip((pic.y, pic.cb, pic.cr), s):
            if not np.array_equal(a, b):
                raise AssertionError("lossless picture != source")
    log(f"  720p lossless all-intra: {len(pics)} frames, wall {wall:.2f}s "
        f"(compile included), {len(pics) / wall:.3f} fps, decode == recon "
        f"== source [{crd}]")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')} [{crd}]")


# ---------------------------------------------------------------- phase 5
def phase_gpu_tests():
    import pytest
    os.chdir(REPO)
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--durations=5", os.path.join(REPO, "tests")])
    if rc != 0:
        raise RuntimeError(f"pytest -m gpu exited {int(rc)}")


# ---------------------------------------------------------------- phase 6
def encode_slices(frames, mesh):
    from x265_tpu.api.encoder import Encoder
    from x265_tpu.api.params import param_default_preset, param_parse
    prm = param_default_preset("medium")
    prm.width, prm.height = frames[0][0].shape[1], frames[0][0].shape[0]
    param_parse(prm, "bitrate", "4000")
    prm.slices = 4
    enc = Encoder(prm)
    if mesh is not None:
        enc.attach_mesh(mesh)
    t0 = time.perf_counter()
    stream = enc.encode(frames)
    return stream, time.perf_counter() - t0


def phase_four(crd):
    import jax
    from x265_tpu.parallel.tiles import make_tile_mesh
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {jax.devices()}")
    os.makedirs(WORK, exist_ok=True)
    frames = write_clip("crowd1080", N1080, os.path.join(WORK, "crowd.y4m"))
    mesh = make_tile_mesh(4)
    res = {}
    for name, m in (("4 GPUs", mesh), ("1 GPU", None), ("4 GPUs", mesh),
                    ("1 GPU", None)):
        stream, wall = encode_slices(frames, m)
        res.setdefault(name, []).append((stream, wall))
        log(f"  1080p medium slices=4 on {name}: {N1080} frames, wall "
            f"{wall:.2f}s, {N1080 / wall:.3f} fps [{crd}]")
    streams = {s for runs in res.values() for s, _ in runs}
    if len(streams) != 1:
        raise AssertionError("4-GPU and 1-GPU streams differ")
    log(f"  4-GPU and 1-GPU streams identical "
        f"({len(next(iter(streams)))} bytes); fps after warm-up: 4 GPUs "
        f"{N1080 / res['4 GPUs'][1][1]:.3f}, 1 GPU "
        f"{N1080 / res['1 GPU'][1][1]:.3f} [{crd}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh phase")
    args = ap.parse_args(argv)

    t_all = time.perf_counter()
    phases = []
    dev = {}

    def run(name, fn, *a):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"== phase {name} ok in {time.perf_counter() - t0:.1f}s")
        phases.append(name)
        return out

    try:
        dev = run("1 device", phase_device)
        crd = card()
        run("2 native finalizer", phase_native)
        if args.four:
            run("6 four GPUs", phase_four, crd)
        else:
            run("3 kernels vs references", phase_kernels)
            run("4 main path", phase_main_path, crd)
            run("5 pytest -m gpu", phase_gpu_tests)
    except Exception as e:  # noqa: BLE001 — any failure ends the run
        import traceback
        traceback.print_exc()
        log(f"FAILED after phases {phases}: {type(e).__name__}: {e}")
        return 1
    import shutil
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s; card "
        f"{crd}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
