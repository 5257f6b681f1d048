"""CLI front-end end-to-end (x265cli analog): y4m in -> Annex-B out,
recon dump, CSV log, long-option passthrough."""
import os
import subprocess
import sys

import numpy as np

from x265_tpu.decoder.decoder import HEVCDecoder
from x265_tpu.io.y4m import VideoInfo, write_y4m


def _make_clip(path, n=3, w=64, h=48, seed=8):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.int32)
    frames = [(np.clip(base + rng.integers(-5, 5, (h, w)), 0, 255)
               .astype(np.uint8),
               np.full((h // 2, w // 2), 120, np.uint8),
               np.full((h // 2, w // 2), 130, np.uint8)) for _ in range(n)]
    write_y4m(str(path), frames, VideoInfo(width=w, height=h))
    return frames


def _run_cli(args):
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.run(
        [sys.executable, "-m", "x265_tpu.cli"] + args,
        capture_output=True, text=True, env=env, timeout=420,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_cli_lossless_roundtrip(tmp_path):
    clip = tmp_path / "in.y4m"
    out = tmp_path / "out.hevc"
    csv = tmp_path / "log.csv"
    frames = _make_clip(clip)
    # --host-analysis: numpy analysis path — skips JAX compiles in the fresh
    # subprocess so the suite stays fast; the device path is covered by the
    # in-process tests
    r = _run_cli(["--input", str(clip), "--output", str(out),
                  "--preset", "ultrafast", "--lossless", "--keyint", "1",
                  "--host-analysis", "--csv", str(csv)])
    assert r.returncode == 0, r.stderr[-800:]
    assert "encoded 3 frames" in r.stderr + r.stdout
    bs = out.read_bytes()
    decoded = HEVCDecoder().decode(bs)
    assert len(decoded) == 3
    for d, f in zip(decoded, frames):
        assert np.array_equal(d.y, f[0].astype(np.int32))
    lines = csv.read_text().strip().splitlines()
    assert len(lines) == 1 + 3          # header + one row per frame


def test_cli_passthrough_rejects_unknown(tmp_path):
    clip = tmp_path / "in.y4m"
    _make_clip(clip)
    r = _run_cli(["--input", str(clip), "--output",
                  str(tmp_path / "o.hevc"), "--no-such-option"])
    assert r.returncode != 0
    assert "no-such-option" in (r.stderr + r.stdout)


def test_decoder_cli(tmp_path):
    """python -m x265_tpu.decoder: decode + y4m recon dump."""
    clip = tmp_path / "in.y4m"
    out = tmp_path / "out.hevc"
    frames = _make_clip(clip)
    r = _run_cli(["--input", str(clip), "--output", str(out),
                  "--preset", "ultrafast", "--lossless", "--keyint", "1",
                  "--host-analysis"])
    assert r.returncode == 0, r.stderr[-500:]
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    recon = tmp_path / "rec.y4m"
    r2 = subprocess.run(
        [sys.executable, "-m", "x265_tpu.decoder", str(out),
         "--recon", str(recon)],
        capture_output=True, text=True, env=env, timeout=420,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r2.returncode == 0, r2.stderr[-500:]
    assert "decoded 3 pictures" in r2.stdout
    from x265_tpu.io.y4m import open_input
    rec = list(open_input(str(recon)).frames())
    for f, (ry, _, _) in zip(frames, rec):
        assert np.array_equal(f[0], ry)      # lossless => exact
