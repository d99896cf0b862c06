"""Row-slab and tile-queue sharded renders over processes (the port of
``examples/sharded_render.py``, which runs on 8 virtual CPU devices).

    python -m sdf3d_tpu_torch.examples.sharded_render [--world 2]
        [--width 256 --height 192] [--out DIR] [--device cuda|cpu]

Starts ``--world`` processes on this host, one a rank, joined by
``parallel.launch.initialize`` on a free local port (NCCL with a card a
rank, gloo for CPU ranks and for ranks sharing a card); ``--world 1`` runs
in this process without a process group.  Each rank renders the flagship at
256×192:

- ``render_sharded`` (the torch engine, a contiguous row slab a rank,
  gathered) against ``render`` on one device: bitwise equal;
- the load-balanced tile queue, ``render_sharded_kernel(layout="tiles")``
  over (8, 128) tiles (one launch of the tile-queue kernel K2 a rank on its
  work-list), against the single-device kernel render (one launch of the
  render kernel K1): no pixel off by more than 1e-3, the mean error below
  1e-5.

A rank that fails fails the run; the others are stopped.  ``--device cpu``
runs the kernels' plain PyTorch versions.  Rank 0 writes the three images
(``images.npz``: ``single``, ``sharded``, ``tiles``) to ``--out`` (default
``build/sharded_render`` under the repository).  The last line is a JSON
object with each rank's comparisons, kernel launches and seconds since its
start (``start``: the process group joined).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch


def run_rank(args) -> dict:
    """One rank's renders and comparisons; its printed lines and numbers."""
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward, render_kernel_tiles_forward
    from sdf3d_tpu_torch.parallel import launch, make_mesh, render_sharded, render_sharded_kernel

    t0 = time.perf_counter()
    if args.world > 1:
        if torch.device(args.device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))  # the ranks share the host's cores
        launch.initialize(args.address, world_size=args.world, rank=args.rank, device=args.device)
    counters = (render_kernel_forward, render_kernel_tiles_forward)
    for fn in counters:
        fn.launches = 0
    try:
        mesh = make_mesh(args.device)
        dev = mesh.device
        cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=args.width, height=args.height)
        cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(dev), tt.reference_material(dev)
        scene = tt.flagship_scene().to(dev)
        lines, seconds = [], {"start": time.perf_counter() - t0}

        def say(text):
            lines.append(text)
            print(text, flush=True)

        with torch.no_grad():
            single = tt.render(scene, cam, light, mat, cfg)
            seconds["render"] = time.perf_counter() - t0
            sharded = render_sharded(scene, cam, light, mat, cfg, mesh)
            seconds["render_sharded"] = time.perf_counter() - t0
        equal = bool(torch.equal(single, sharded))
        say(f"mesh: {mesh.shape}")
        say(f"sharded == single-device: {equal}")
        say(f"output shape: {tuple(sharded.shape)}")
        assert equal, "sharded render must be bitwise identical on the same device"

        # The load-balanced 2-D tile queue (the >=16-chip production layout):
        # each rank renders an equal-count static work-list of (8, 128) tiles.
        kernel_single = tt.render_batch(scene, [cam], light, mat, cfg, engine="kernel", device=dev)[0]
        tiles_img = render_sharded_kernel(scene, cam, light, mat, cfg, mesh, kc=KernelConfig(tile_h=8, tile_w=128),
                                          layout="tiles")
        seconds["tiles"] = time.perf_counter() - t0
        err = (tiles_img - kernel_single).abs().amax(-1)
        over = int((err > 1e-3).sum())
        say(f"tile-queue sharded vs single-device: max |err| {float(err.max()):.2e}, pixels > 1e-3: {over}")
        assert over == 0 and float(err.mean()) < 1e-5
        if mesh.rank == 0 and args.out:
            out = pathlib.Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            np.savez(out / "images.npz", single=single.cpu().numpy(), sharded=sharded.cpu().numpy(),
                     tiles=tiles_img.cpu().numpy(), kernel_single=kernel_single.cpu().numpy())
        return {"rank": mesh.rank, "world": mesh.size, "device": str(dev),
                "backend": torch.distributed.get_backend() if args.world > 1 else None, "lines": lines,
                "sharded_equal": equal, "tiles_max_abs_err": float(err.max()), "tiles_over_1e-3": over,
                "tiles_mean_abs_err": float(err.mean()), "tiles_equal_kernel": bool(torch.equal(tiles_img,
                                                                                                  kernel_single)),
                "launches": {fn.__name__: fn.launches for fn in counters}, "seconds": seconds}
    finally:
        if args.world > 1:
            launch.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.sharded_render", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=2, help="processes, one a rank")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parents[2] / "build" / "sharded_render"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("sharded_render: no CUDA device; pass --device cpu to run the kernels' plain versions")

    if args.rank is not None or args.world == 1:
        if args.rank is None:
            args.rank = 0
        result = run_rank(args)
        print(json.dumps(result), flush=True)
        return 0

    from sdf3d_tpu_torch.benchmarks._ranks import run_ranks

    ranks = run_ranks("sdf3d_tpu_torch.examples.sharded_render", args.world,
                      ["--width", args.width, "--height", args.height, "--out", args.out, "--device", args.device])
    for line in ranks[0]["lines"]:
        print(line)
    print(json.dumps({"ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
