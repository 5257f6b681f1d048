"""Benchmark suite: fps on the ladder configs + BD-rate vs x265.

Prints ONE JSON line (the driver contract):
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N,
   "extras": {...}}

It needs a GPU: with no GPU it exits non-zero and prints no result.
The device (platform, device_kind, count) and the card's name and power
limit as nvidia-smi reports them go into extras.

Robustness: a daemon watchdog thread prints the JSON and hard-exits if
the main thread stays inside a C call past the budget; the primary
metric is recorded after every measured frame, so a SIGTERM/SIGALRM or
watchdog flush still ships the frames measured so far; per-frame
deadline checks inside the encode loop bound each stage's wall-clock.

Rules:
 - the primary metric (1080p medium ABR fps, BASELINE.json config #3)
   runs FIRST; every later stage checks a global deadline and is
   skipped cleanly when the budget is spent;
 - every stage is exception-guarded; the JSON line is ALWAYS printed,
   carrying whatever completed plus per-stage errors;
 - BD-rate points compare against x265-binary points measured on the
   IDENTICAL short prefixes (bench_refpoints_short.json, generated by
   tools/run_ref_points_short.py);
 - BENCH_FULL=1 restores full 50/32-frame clips + the stored full-clip
   refpoints (bench_refpoints.json) with a 10h budget.

vs_baseline: null ("not measured") until x265 is timed in the same run
on the same machine. extras carry 720p lossless (vs the published 3.02
fps, doc/reST/lossless.rst:25-27), 720p CQP IPPP fps, BD-rate
(PSNR-YUV; the x265 kb/s + PSNR refpoints are deterministic) and a
device-wait estimate.

Progress goes to stderr; stdout carries only the JSON line.
"""
import json
import os
import signal
import sys
import threading
import time

import numpy as np

T0 = time.time()
FULL = bool(os.environ.get("BENCH_FULL"))
BUDGET = float(os.environ.get("BENCH_BUDGET", 36000 if FULL else 900))

# The one JSON line is also flushed from a signal handler: if the driver
# (or our own alarm backstop) kills a stage mid-encode, whatever has been
# measured so far still ships instead of rc=124/no output.
_OUT = {"metric": "1080p medium ABR encode fps (1 GPU, e2e)",
        "value": None, "unit": "fps", "vs_baseline": None,
        "extras": {"errors": {}}}
_PRINT_LOCK = threading.Lock()
_PRINTED = False


def _emit(reason=None):
    """Print the JSON line exactly once (lock: the watchdog thread and
    the main-thread signal handler race on this)."""
    global _PRINTED
    with _PRINT_LOCK:
        if _PRINTED:
            return False
        _PRINTED = True
    if reason:
        _OUT["extras"]["errors"].setdefault("interrupted", reason)
    if not _OUT["extras"]["errors"]:
        del _OUT["extras"]["errors"]
    print(json.dumps(_OUT), flush=True)
    sys.stdout.flush()
    return True


def _flush_json(*_args):
    _emit(f"flushed at {time.time()-T0:.0f}s")
    os._exit(0)


signal.signal(signal.SIGTERM, _flush_json)
signal.signal(signal.SIGALRM, _flush_json)
signal.alarm(int(BUDGET) + 120)     # backstop inside the driver timeout

# Signal handlers only run on the MAIN thread between bytecodes; a main
# thread wedged inside a C call never services SIGALRM/SIGTERM. A daemon
# watchdog THREAD prints the partial JSON itself and hard-exits.


def _watchdog():
    def run():
        time.sleep(BUDGET + 180)
        if _emit(f"watchdog flush at {time.time()-T0:.0f}s "
                 "(main thread wedged)"):
            os._exit(0)

    threading.Thread(target=run, daemon=True).start()


_watchdog()


def log(msg):
    print(f"[{time.time()-T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def left():
    return BUDGET - (time.time() - T0)


def encode_fps(frames, p, warm, deadline=None, record=None,
               warm_record=None):
    """Timed single run after a compile-warming run on `warm` frames
    (enough to reach steady-state mini-GOP/ref-count shapes).

    deadline: absolute time.time() after which the loop bails cleanly
    (partial fps over the frames actually coded is still returned).
    record(fps, nframes, done): called after EVERY measured frame so the
    caller can stash an incremental value into the flush-on-signal JSON.
    warm_record(fps, nframes): same for the compile-inclusive warm run
    (a last-resort value if the timed run never starts).

    All-intra (keyint==1) uses Encoder.encode() — the pipelined fast
    path — timed total-wall (per-frame hooks would measure the
    unpipelined path; ADVICE r3).
    """
    from x265_tpu.api.encoder import Encoder
    from x265_tpu.utils import profiling

    if p.keyint == 1:
        enc = Encoder(p.copy())
        try:
            enc.encode(frames[:min(warm, len(frames))])
        finally:
            enc.close()
        profiling.reset()
        enc = Encoder(p.copy())
        t0 = time.time()
        try:
            stream = enc.encode(frames)
        finally:
            enc.close()
        dt = time.time() - t0
        return len(frames) / dt, stream, dt, profiling.report(), {}

    # Progress = pictures fully CODED (delivered AUs), not pictures
    # submitted: with b-adapt the queue holds rc-lookahead frames, so
    # submissions are nearly free and the work lands in mini-GOP
    # closes + the flush drain. Counting delivered keeps the
    # incremental fps honest when a signal kills the run mid-flush.
    def delivered(enc):
        return enc.frame_count - len(enc.pending)

    # --- warm (compile) run: per-frame deadline checks + fallback fps
    enc = Encoder(p.copy())
    tw0 = time.time()
    nwarm = 0
    try:
        enc.headers()
        for (y, cb, cr) in frames[:min(warm, len(frames))]:
            enc.encode_frame(y, cb, cr)
            nwarm = delivered(enc)
            if warm_record and nwarm:
                warm_record(nwarm / (time.time() - tw0), nwarm)
            if deadline and time.time() >= deadline:
                break
        while enc.pending and not (deadline and time.time() >= deadline):
            enc.flush_step()
            nwarm = delivered(enc)
            if warm_record and nwarm:
                warm_record(nwarm / (time.time() - tw0), nwarm)
    finally:
        enc.close()

    # --- timed run
    profiling.reset()
    enc = Encoder(p.copy())
    times = []
    stream = bytearray()
    flush_s = 0.0
    t0 = time.time()
    ncoded = 0
    try:
        stream += enc.headers()
        for (y, cb, cr) in frames:
            tf = time.time()
            stream += enc.encode_frame(y, cb, cr)
            times.append(time.time() - tf)
            ncoded = delivered(enc)
            if record and ncoded:
                record(ncoded / (time.time() - t0), ncoded, False)
            if deadline and time.time() >= deadline:
                log(f"  deadline: stopping after {len(times)} submits")
                break
        tf = time.time()
        while enc.pending:
            stream += enc.flush_step()
            ncoded = delivered(enc)
            if record and ncoded:
                record(ncoded / (time.time() - t0), ncoded, False)
            if deadline and time.time() >= deadline and enc.pending:
                log(f"  deadline: stopping flush at {ncoded} coded")
                break
        flush_s = time.time() - tf
    finally:
        enc.close()
    dt = time.time() - t0
    fps = ncoded / dt
    if record and ncoded:
        record(fps, ncoded, True)
    med = float(np.median(times)) if times else 0.0
    stall_mask = [t >= 5 * med and t > 2.0 for t in times]
    diag = {
        "median_frame_s": round(med, 3),
        "fps_median_frame": round(1.0 / max(med, 1e-9), 2),
        "stall_frames": int(sum(stall_mask)),
        "stall_seconds": round(sum(t for t, s in zip(times, stall_mask)
                                   if s), 1),
        "frames_coded": ncoded,
        "frames_submitted": len(times),
        "flush_s": round(flush_s, 2),
        "warm_frames": nwarm,
        "warm_s": round(time.time() - tw0 - dt, 1),
    }
    return fps, bytes(stream), dt, profiling.report(), diag


def device_info():
    """The device this run measures; exits non-zero without a GPU (a
    number from another backend is never reported as a GPU number)."""
    import subprocess
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {devs[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "nvidia_smi": smi.stdout.strip().splitlines()}


def main():
    from x265_tpu.api.params import param_default_preset, param_parse
    from tools.make_clips import frames_of
    from tools.quality import bd_rate, measure_stream

    here = os.path.dirname(os.path.abspath(__file__))
    out = _OUT
    extras = out["extras"]

    extras.update(device_info())
    log(f"device: {extras['device_kind']} x{extras['device_count']} "
        f"{extras['nvidia_smi']}")
    log("loading clips...")
    crowd = [tuple(np.asarray(x) for x in f) for f in frames_of("crowd1080")]
    pan = [tuple(np.asarray(x) for x in f) for f in frames_of("pan720")]
    log(f"clips ready ({len(crowd)}+{len(pan)} frames)")

    def guard(name, fn):
        if left() <= 0:
            extras["errors"][name] = "skipped: budget spent"
            log(f"SKIP {name} (budget spent)")
            return
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — partial JSON still ships
            extras["errors"][name] = f"{type(e).__name__}: {e}"
            log(f"FAIL {name}: {e}")

    if FULL:
        refpoints = json.load(open(os.path.join(here,
                                                "bench_refpoints.json")))
        n1080, npan, nbd = len(crowd), 24, None  # full BD clips
    else:
        refpoints = json.load(open(os.path.join(here,
                                                "bench_refpoints_short.json")))
        npan, nbd = 12, refpoints["bd_prefix"]["pan720"]
        # a 1-frame fps is noise: measure the whole 32-frame clip
        n1080 = len(crowd)
    warm1080, warm720 = 8, 6
    extras["vs_baseline_note"] = ("not measured: x265 is not timed in "
                                  "this run")

    # --- BD-rate proxy FIRST on a reserved budget slice (VERDICT r4
    # next #4: no round ships quality-blind again) ---
    bd_deadline = T0 + min(330.0, BUDGET * 0.35)

    # --- config 3 (north star): 1080p medium ABR ---
    def primary():
        p = param_default_preset("medium")
        p.width, p.height = 1920, 1080
        param_parse(p, "bitrate", "4000")
        p.fps_num, p.fps_den = 25, 1

        def warm_rec(fps, n):
            # compile-inclusive last-resort number: real, but labeled
            if out["value"] is None or extras.get("primary_source") == \
                    "warm(compile-inclusive)":
                out["value"] = round(fps, 3)
                extras["primary_source"] = "warm(compile-inclusive)"
                extras["primary_frames"] = n
            log(f"  warm frame {n}: {fps:.3f} fps (compile-inclusive)")

        def rec(fps, n, done):
            out["value"] = round(fps, 3)
            extras["primary_source"] = "timed"
            extras["primary_frames"] = n
            if not done:
                log(f"  frame {n}: {fps:.3f} fps so far")

        # leave ~20% of the budget for the quality stages
        deadline = T0 + BUDGET * 0.8
        fps, _, dt, prof, diag = encode_fps(
            crowd[:n1080], p, warm=warm1080, deadline=deadline,
            record=rec, warm_record=warm_rec)
        extras["primary_stall_diag"] = diag
        # device-utilization estimate: share of wall spent blocked on
        # device dispatches vs host entropy/filter work
        dev = sum(prof.get(s, {}).get("seconds", 0.0)
                  for s in ("analysis", "motion", "lookahead"))
        host = sum(prof.get(s, {}).get("seconds", 0.0)
                   for s in ("finalize", "loopfilter", "sao_analyze",
                             "bitstream_write"))
        extras["primary_stage_seconds"] = {
            k: round(v["seconds"], 2) for k, v in prof.items()}
        extras["device_wait_frac"] = round(dev / max(dt, 1e-9), 3)
        extras["host_work_frac"] = round(host / max(dt, 1e-9), 3)
        log(f"1080p medium ABR: {fps:.2f} fps (device-wait {dev:.1f}s "
            f"host {host:.1f}s of {dt:.1f}s wall)")

    # --- config 1 continuity: 720p all-intra lossless (published 3.02) ---
    def lossless():
        p = param_default_preset("ultrafast")
        p.width, p.height = 1280, 720
        param_parse(p, "lossless")
        param_parse(p, "keyint", "1")
        fps, _, _, _, _ = encode_fps(pan[:npan], p, warm=warm720)
        extras["720p_allintra_lossless_fps"] = round(fps, 2)
        extras["720p_allintra_lossless_vs_published_3.02"] = round(
            fps / 3.02, 2)
        log(f"720p all-intra lossless: {fps:.2f} fps "
            f"({fps/3.02:.2f}x published)")

    # --- config 2: 720p CQP IPPP ultrafast ---
    def cqp():
        p = param_default_preset("ultrafast")
        p.width, p.height = 1280, 720
        param_parse(p, "qp", "30")
        p.bframes = 0
        p.ref = 1
        fps, _, _, _, _ = encode_fps(pan[:npan], p, warm=warm720,
                                     deadline=T0 + BUDGET * 0.92)
        extras["720p_cqp_ippp_fps"] = round(fps, 2)
        log(f"720p CQP IPPP: {fps:.2f} fps")

    # --- BD-rate vs x265 (medium, PSNR-YUV) on identical frames ---
    def bd():
        from x265_tpu.api.encoder import Encoder
        crfs = refpoints["crfs"]
        bd_clips = (["pan720", "cutfade720", "zoom720"] if FULL
                    else ["pan720"])
        bds = {}
        for clip in bd_clips:
            src = [tuple(np.asarray(x) for x in f) for f in frames_of(clip)]
            if not FULL:
                src = src[:nbd]
            key = clip if FULL else f"{clip}_p{nbd}"
            pts = []
            for crf in crfs:
                if left() <= 0:
                    log(f"SKIP {clip} crf{crf} (budget spent)")
                    break
                p = param_default_preset("medium")
                p.width, p.height = 1280, 720
                param_parse(p, "crf", str(crf))
                p.fps_num, p.fps_den = 25, 1
                stream = Encoder(p).encode(src)
                m = measure_stream(stream, src, 25.0)
                pts.append((m["kbps"], m["psnr_yuv"]))
                log(f"  {clip} crf{crf}: {m['kbps']:.0f} kbps "
                    f"{m['psnr_yuv']:.2f} dB")
            refpts = [(refpoints["points"][f"{key}/medium/crf{c}"]["kbps"],
                       refpoints["points"][f"{key}/medium/crf{c}"][
                           "psnr_yuv"]) for c in crfs[:len(pts)]]
            try:
                bds[clip] = (round(bd_rate(refpts, pts), 1)
                             if len(pts) >= 4 else None)
            except ValueError:
                bds[clip] = None
            log(f"BD-rate {clip} medium: {bds[clip]}%")
        extras["bd_rate_medium_vs_x265_pct"] = bds

    def bd_proxy():
        """CPU-feasible BD-rate: a 384x224 crop of the pan clip, 16
        frames, 3 CRF points, the x265 binary measured on the SAME crop
        (fresh refpoints, ~3 s). Small-clip numbers run a little
        pessimistic vs the full 720p sweep (one IDR amortizes over
        fewer pixels) but track the same quality work."""
        import subprocess
        import tempfile
        from x265_tpu.api.encoder import Encoder
        from x265_tpu.io.y4m import write_y4m, VideoInfo
        from x265_tpu.decoder import de265
        from tools.quality import global_psnr
        W, H, N = 384, 224, 16
        full_clip = frames_of("pan720")[:N]
        yy, xx = 248, 448
        src = [(f[0][yy:yy + H, xx:xx + W],
                f[1][yy // 2:(yy + H) // 2, xx // 2:(xx + W) // 2],
                f[2][yy // 2:(yy + H) // 2, xx // 2:(xx + W) // 2])
               for f in full_clip]
        y4m = tempfile.mktemp(suffix=".y4m")
        write_y4m(y4m, src, VideoInfo(W, H, 25, 1))
        x265_bin = os.path.join(here, ".refbuild8", "x265")
        crfs = (28, 31, 34)
        refpts, pts = [], []
        for crf in crfs:
            ref_out = tempfile.mktemp(suffix=".hevc")
            subprocess.run([x265_bin, "--input", y4m, "--output", ref_out,
                            "--preset", "medium", "--crf", str(crf),
                            "--log-level", "error"], check=True)
            bits = os.path.getsize(ref_out) * 8
            dec = de265.decode_file(ref_out)
            dec = [(d if isinstance(d, tuple) else (d.y, d.cb, d.cr))
                   for d in dec]
            refpts.append((bits / N / 1000 * 25,
                           global_psnr(src, dec)[3]))
            os.unlink(ref_out)
        for crf in crfs:
            if time.time() >= bd_deadline:
                log(f"SKIP bd_proxy crf{crf} (reserved slice spent)")
                break
            p = param_default_preset("medium")
            p.width, p.height = W, H
            param_parse(p, "crf", str(crf))
            stream = Encoder(p).encode(src)
            m = measure_stream(stream, src, 25.0)
            pts.append((m["kbps"], m["psnr_yuv"]))
            log(f"  bd_proxy crf{crf}: {m['kbps']:.0f} kbps "
                f"{m['psnr_yuv']:.2f} dB (ref {refpts[len(pts)-1][0]:.0f}"
                f"/{refpts[len(pts)-1][1]:.2f})")
        os.unlink(y4m)
        if len(pts) >= 2:
            v = round(bd_rate(refpts[:len(pts)], pts), 1)
            extras["bd_rate_proxy_pan_crop_pct"] = v
            log(f"BD-rate proxy (pan crop, {len(pts)} pts): {v}%")

    # quality FIRST (reserved slice), then speed
    guard("bd_rate_proxy", bd_proxy)
    guard("primary_1080p_medium", primary)
    guard("720p_lossless", lossless)
    guard("720p_cqp_ippp", cqp)
    if FULL:
        guard("bd_rate", bd)

    _emit()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
