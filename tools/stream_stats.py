"""Bit-composition analysis of an HEVC stream via the in-repo decoder.

The analog of x265's csv-log-level-2 frame analysis
(x265.h x265_frame_stats: cuStats/percent* fields, csvfile.cpp): decode a
stream with per-CU statistics collection and report, per frame and in
aggregate, how the bits split across CU kinds (skip / merge / AMVP /
intra), CU sizes, and header-vs-residual bytes.

Usage: python -m tools.stream_stats stream.hevc [--frames N]
"""
import argparse
import sys
from collections import defaultdict


def analyze(path: str, max_frames: int = 0) -> None:
    from x265_tpu.decoder.decoder import HEVCDecoder
    with open(path, "rb") as f:
        stream = f.read()
    dec = HEVCDecoder(collect_stats=True)
    dec.decode(stream)

    stype_name = {0: "B", 1: "P", 2: "I"}
    agg = defaultdict(lambda: [0, 0, 0])   # (stype,kind,size) -> [n, bytes, res]
    print(f"{'poc':>4} {'ty':>2} {'kB':>7}  "
          f"{'skip':>5} {'merge':>5} {'amvp':>5} {'intra':>5}   "
          f"{'cu64':>4} {'cu32':>4} {'cu16':>4} {'cu8':>4}  "
          f"{'res%':>5} {'cbf%':>5}")
    for i, (poc, stype, events) in enumerate(dec.pic_stats):
        if max_frames and i >= max_frames:
            break
        n_kind = defaultdict(int)
        n_size = defaultdict(int)
        by_kind_bytes = defaultdict(int)
        tot = res = ncbf = 0
        for (st, size, kind, nbytes, nres, cbf) in events:
            n_kind[kind] += 1
            n_size[size] += 1
            by_kind_bytes[kind] += nbytes
            tot += nbytes
            res += nres
            ncbf += bool(cbf)
            agg[(st, kind, size)][0] += 1
            agg[(st, kind, size)][1] += nbytes
            agg[(st, kind, size)][2] += nres
        ncu = max(1, len(events))
        print(f"{poc:>4} {stype_name[stype]:>2} {tot/1000:7.1f}  "
              f"{n_kind['skip']:>5} {n_kind['merge']:>5} "
              f"{n_kind['amvp']:>5} {n_kind['intra']:>5}   "
              f"{n_size.get(64,0):>4} {n_size.get(32,0):>4} "
              f"{n_size.get(16,0):>4} {n_size.get(8,0):>4}  "
              f"{100*res/max(1,tot):5.1f} {100*ncbf/ncu:5.1f}")

    print("\naggregate bytes by (slice, kind, size):")
    total_bytes = sum(v[1] for v in agg.values()) or 1
    for (st, kind, size), (n, nb, nr) in sorted(
            agg.items(), key=lambda kv: -kv[1][1]):
        print(f"  {stype_name[st]} {kind:>5} {size:>3}: n={n:6d} "
              f"bytes={nb:8d} ({100*nb/total_bytes:5.1f}%) "
              f"res={nr:8d} hdr={nb-nr:8d} "
              f"avg={nb/max(1,n):7.1f} B/cu")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("stream")
    ap.add_argument("--frames", type=int, default=0)
    args = ap.parse_args(argv)
    analyze(args.stream, args.frames)


if __name__ == "__main__":
    sys.exit(main())
