"""Neural-engine crossover sweep (the port of ``benchmarks/neural_crossover.py``):
the neural render kernel (K6, ``render_neural_forward``) against the banded
plain path (``render_banded``) across MLP widths and resolutions.

    python -m sdf3d_tpu_torch.benchmarks.neural_crossover

``ground_plane() | neural_sdf(hidden, depth=3)`` at hidden 64, 128 and 256,
720p and 1080p, a 64-step march and a 32-step shadow; each time the best of
two windows (``utils.profiling.benchmark_fn``: one warm-up frame, three
timed).  Runs on the card (``--device``; ``cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, render_neural_forward
    from sdf3d_tpu_torch.utils.profiling import benchmark_fn

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.neural_crossover", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--sizes", nargs="+", default=["1280x720", "1920x1080"], help="WxH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (--device cpu runs the plain versions)")

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    cam = tt.Camera.reference(device=dev)
    ref = tt.REFERENCE_CONFIG
    march = dataclasses.replace(ref.march, max_steps=64)
    shadow = dataclasses.replace(ref.shadow, max_steps=32)
    nc = NeuralRenderConfig()

    print(f"{'hidden':>6} {'res':>10} {'kernel ms':>10} {'banded ms':>10}  winner")
    for hidden in args.hidden:
        scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.neural_sdf(0, hidden=hidden, depth=3, radius=0.3)).to(dev)
        for size in args.sizes:
            w, h = (int(x) for x in size.split("x"))
            cfg = dataclasses.replace(ref, width=w, height=h, march=march, shadow=shadow)

            def kernel(sc, cfg=cfg):
                return render_neural_forward(sc, cam, light, mat, cfg, nc, device=dev)[0].mean()

            def banded(sc, cfg=cfg):
                return tt.render_banded(sc, cam, light, mat, cfg).mean()

            tk = min(benchmark_fn(kernel, scene, warmup=1, iters=3) for _ in range(2))
            tb = min(benchmark_fn(banded, scene, warmup=1, iters=3) for _ in range(2))
            win = "kernel" if tk < tb else "banded"
            print(f"{hidden:>6} {w}x{h:<6} {tk * 1e3:>10.1f} {tb * 1e3:>10.1f}  {win}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
