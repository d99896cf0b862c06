"""Benchmark suite: forward and fwd+bwd throughput, and throughput against
scene cost (the port of the ``fwd``/``fwd_bwd`` and ``--scene-cost`` parts
of ``benchmarks/suite.py``).

    python -m sdf3d_tpu_torch.benchmarks.suite               # 1080p, on the card
    python -m sdf3d_tpu_torch.benchmarks.suite --quick       # 256x192
    python -m sdf3d_tpu_torch.benchmarks.suite --scene-cost  # random_blobs(n), n = 2, 4, 8, 16

Reports JSONL (one ``bench.run_benchmark`` payload per cell; with
``--scene-cost`` one ``scene_cost_rays_per_second`` line per n, JAX's
fields) to stdout and optionally appends it to a file.  ``--scaling`` (a
mesh-size sweep, ROADMAP item 15b: one card here) is not ported and raises.
Runs on the card (``--device``; ``cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys


def bench_scene_cost(width: int = 256, height: int = 192, iters: int = 5, device="cuda",
                     sizes=(2, 4, 8, 16)) -> list:
    """Throughput against scene complexity: ``random_blobs(n)`` (seed 0) for
    each n of ``sizes``, rendered with ``render_batch(engine="kernel")`` (K1
    on the card, its plain version on the CPU) at ``width`` x ``height``
    under the reference settings and camera, ``iters`` frames after one of
    warm-up (the build included there).  One dict a size: ``metric``
    ``"scene_cost_rays_per_second"``, ``n_primitives`` (n + 1, the plane
    counted), ``value`` (rays/s) and ``unit``, as the JAX suite reports."""
    import dataclasses

    import torch

    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.utils.profiling import benchmark_fn

    dev = torch.device(device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=width, height=height)
    cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
    out = []
    for n in sizes:
        scene = tt.random_blobs(n=n).to(dev)
        sec = benchmark_fn(lambda: tt.render_batch(scene, [cam], light, mat, cfg, engine="kernel", device=dev),
                           warmup=1, iters=iters)
        out.append({"metric": "scene_cost_rays_per_second", "n_primitives": n + 1, "value": width * height / sec,
                    "unit": "rays/s"})
    return out


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
        results = bench_scene_cost(device=args.device)
    else:
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
