"""Multi-host ABR ladder worker (one x265 abrEncApp process analog).

Each host/process runs this same script with its --proc-id; the static
rendition shard (`renditions_for_process`) decides which renditions it
owns, `jax.distributed.initialize` wires the process group (SURVEY §2.4
P6; reference: abrEncApp.cpp:497-846 AbrEncoder spawning one PassEncoder
per rendition). The source clip is read/synthesised locally on every
host (the Reader thread analog) so the network never carries pixels.

Usage (normally spawned by tests/test_ladder_multihost.py):
  python tools/ladder_worker.py --coordinator 127.0.0.1:PORT \
      --procs 2 --proc-id 0 --out /tmp/ladder --frames 3
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()

    # The ladder needs process identity + the shard map, not
    # cross-process collectives (renditions are independent). JAX picks
    # the platform (JAX_PLATFORMS is honoured); on a GPU host each
    # process takes the card whose index is its process id.
    import jax
    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.procs,
                               process_id=args.proc_id,
                               local_device_ids=[args.proc_id])
    assert jax.process_count() == args.procs
    assert jax.process_index() == args.proc_id

    import numpy as np
    from x265_tpu.api.ladder import AbrLadder, Rendition

    rends = [Rendition(96, 64, 120, preset="ultrafast"),
             Rendition(64, 48, 60, preset="ultrafast")]
    ladder = AbrLadder(96, 64, rends, fps=(25, 1),
                       process_index=jax.process_index(),
                       process_count=jax.process_count())

    rng = np.random.default_rng(11)  # same seed on every host
    base = rng.integers(16, 235, (64, 96), np.uint8)
    for t in range(args.frames):
        y = np.roll(base, (2 * t, 3 * t), axis=(0, 1))
        cb = np.full((32, 48), 120, np.uint8)
        cr = np.full((32, 48), 124, np.uint8)
        ladder.push((y, cb, cr))
    out = ladder.finish()

    os.makedirs(args.out, exist_ok=True)
    for i, stream in out.items():
        with open(os.path.join(args.out, f"r{i}.hevc"), "wb") as f:
            f.write(stream)
    print(f"proc {args.proc_id}: wrote renditions {sorted(out)}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
