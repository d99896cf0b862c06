"""Thread-block autotuner for the forward render kernel (the port of
``benchmarks/autotune.py``, which swept the Pallas kernel's tiles).

    python -m sdf3d_tpu_torch.benchmarks.autotune --width 1920 --height 1080

On the card the launch knob is the thread block, ``KernelConfig.block_w ×
block_h`` (one pixel a thread; a block holds whole warps).  Every shape's
library is built first, all at once; then each shape's rays/s
(``utils.profiling.benchmark_fn`` over ``--iters`` frames) is printed as one
JSON line, and the best last.  Runs on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

#: (block_w, block_h) candidates: 64 to 512 threads, warps along rows.
SHAPES = ((32, 2), (32, 4), (32, 8), (32, 16), (64, 2), (64, 4), (64, 8), (128, 1), (128, 2), (128, 4),
          (16, 4), (16, 8), (16, 16), (8, 8), (8, 16))


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job, render_kernel_forward
    from sdf3d_tpu_torch.utils.profiling import benchmark_fn

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.autotune", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--scene", choices=["reference", "sphere"], default="reference")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the autotuner times the CUDA kernel and no CUDA device is visible")

    dev = torch.device("cuda")
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=args.width, height=args.height)
    cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
    scene = {"reference": tt.reference_scene, "sphere": tt.sphere_scene}[args.scene]().to(dev)
    configs = [KernelConfig(block_w=w, block_h=h) for w, h in SHAPES]
    _build.LIBRARIES.load_many([library_job(scene, cfg, kc) for kc in configs])

    best = None
    for kc in configs:
        sec = benchmark_fn(lambda sc, kc=kc: render_kernel_forward(sc, cam, light, mat, cfg, kc, device=dev)[0],
                           scene, warmup=3, iters=args.iters)
        rec = {"block": [kc.block_w, kc.block_h], "rays_per_second": args.width * args.height / sec, "seconds": sec}
        print(json.dumps(rec), flush=True)
        if best is None or rec["rays_per_second"] > best["rays_per_second"]:
            best = rec
    print(json.dumps({"best": best, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
