"""Benchmark suite: forward and fwd+bwd throughput (the port of the
``fwd``/``fwd_bwd`` parts of ``benchmarks/suite.py``).

    python -m sdf3d_tpu_torch.benchmarks.suite            # 1080p, on the card
    python -m sdf3d_tpu_torch.benchmarks.suite --quick    # 256x192

Reports JSONL (one ``bench.run_benchmark`` payload per cell) to stdout and
optionally appends it to a file.  ``--scaling`` (a mesh-size sweep, ROADMAP
item 15b: one card here) and ``--scene-cost`` (a ``random_blobs`` sweep,
item 13b) are not ported and raise.  Runs on the card (``--device``; ``cpu``
runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from sdf3d_tpu_torch.bench import run_benchmark

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.suite", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="256x192")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--scene-cost", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append JSONL here")
    args = ap.parse_args(argv)
    if args.scaling:
        raise NotImplementedError("the mesh-size sweep needs several cards (ROADMAP item 15b)")
    if args.scene_cost:
        raise NotImplementedError("the scene-cost sweep needs random_blobs, which is not ported yet (ROADMAP item 13b)")
    w, h = (256, 192) if args.quick else (1920, 1080)
    results = [run_benchmark(w, h, mode=mode, iters=5, device=args.device) for mode in ("fwd", "fwd_bwd")]
    lines = [json.dumps(r) for r in results]
    print("\n".join(lines))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("".join(ln + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
