"""Benchmark suite: forward and fwd+bwd throughput, throughput against
scene cost, and scaling over processes (the port of ``benchmarks/suite.py``).

    python -m sdf3d_tpu_torch.benchmarks.suite               # 1080p, on the card
    python -m sdf3d_tpu_torch.benchmarks.suite --quick       # 256x192
    python -m sdf3d_tpu_torch.benchmarks.suite --scene-cost  # random_blobs(n), n = 2, 4, 8, 16
    python -m sdf3d_tpu_torch.benchmarks.suite --scaling [--world-sizes 1 2 4 8]

Reports JSONL (one ``bench.run_benchmark`` payload per cell; with
``--scene-cost`` one ``scene_cost_rays_per_second`` line per n; with
``--scaling`` one ``scaling_rays_per_second`` line per world size, JAX's
fields) to stdout and optionally appends it to a file.  ``--scaling`` times
``parallel.render_sharded`` (the function JAX's sweep times) in n
``torch.distributed`` processes (:func:`bench_scaling`).  Runs on the card
(``--device``; ``cpu`` runs the plain versions).
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


def scaling_rank(address: str, world: int, rank: int, width: int, height: int, iters: int, device) -> dict:
    """One rank of :func:`bench_scaling`: join the group (``address`` None:
    world size 1, no group), then time ``render_sharded`` of the reference
    scene at the reference camera (``benchmark_fn``: one call of warm-up,
    then ``iters``; every rank makes the same calls, so the ranks' gathers
    keep them in step)."""
    import dataclasses

    import torch

    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.parallel import launch, make_mesh, render_sharded
    from sdf3d_tpu_torch.utils.profiling import benchmark_fn

    if address is not None:
        launch.initialize(address, world_size=world, rank=rank, device=device)
    mesh = make_mesh(device)
    dev = mesh.device
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=width, height=height)
    scene = tt.reference_scene().to(dev)
    cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
    with torch.no_grad():
        sec = benchmark_fn(lambda: render_sharded(scene, cam, light, mat, cfg, mesh), warmup=1, iters=iters)
    backend = torch.distributed.get_backend() if address is not None else None
    launch.shutdown()
    return {"rank": rank, "n_devices": mesh.size, "seconds": sec, "backend": backend, "device": dev.type}


def bench_scaling(width: int, height: int, world_sizes=(1, 2, 4, 8), iters: int = 5, device="cuda") -> list:
    """Rays/s of ``parallel.render_sharded`` (the torch engine's sharded
    render) over world sizes of ``torch.distributed`` processes; sizes that
    do not divide the height are skipped, as JAX's sweep skips them.  World
    size 1 runs in this process; n > 1 in n processes on this host
    (``_ranks.run_ranks``), rank 0's time the record's.  ``efficiency`` is
    ``rays/s(n) / (n · rays/s(1))`` against the first size run.  Ranks on
    the card take NCCL when there are as many cards, else share them over
    gloo: each record's ``shared_card`` says whether its ranks shared a
    device (CPU ranks share the host), and then the sweep checks the
    plumbing, not the speed, as JAX's sweep on its CPU fakes."""
    import torch

    from sdf3d_tpu_torch.benchmarks._ranks import run_ranks

    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    out, base = [], None
    for n in world_sizes:
        if height % n:
            continue
        if n == 1:
            res = scaling_rank(None, 1, 0, width, height, iters, device)
        else:
            res = run_ranks("sdf3d_tpu_torch.benchmarks.suite", n,
                            ["--scaling", "--width", width, "--height", height, "--iters", iters, "--device",
                             device.type])[0]
        rays_s = width * height / res["seconds"]
        base = rays_s if base is None else base
        out.append({"metric": "scaling_rays_per_second", "n_devices": n, "value": rays_s, "unit": "rays/s",
                    "efficiency": rays_s / (n * base), "shared_card": n > 1 and n > cards,
                    "device": device.type, "backend": res["backend"]})
    return out


def main(argv=None) -> int:
    from sdf3d_tpu_torch.bench import run_benchmark

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.suite", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="256x192")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--scene-cost", action="store_true")
    ap.add_argument("--world-sizes", type=int, nargs="+", default=[1, 2, 4, 8], help="with --scaling")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append JSONL here")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    w, h = (256, 192) if args.quick else (1920, 1080)
    w, h = args.width or w, args.height or h
    if args.rank is not None:  # one rank of --scaling
        print(json.dumps(scaling_rank(args.address, args.world, args.rank, w, h, args.iters, args.device)), flush=True)
        return 0
    if args.scaling:
        results = bench_scaling(w, h, tuple(args.world_sizes), args.iters, args.device)
    elif args.scene_cost:
        results = bench_scene_cost(device=args.device)
    else:
        results = [run_benchmark(w, h, mode=mode, iters=args.iters, device=args.device) for mode in ("fwd", "fwd_bwd")]
    lines = [json.dumps(r) for r in results]
    print("\n".join(lines))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("".join(ln + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
