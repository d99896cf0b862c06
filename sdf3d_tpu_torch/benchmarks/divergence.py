"""How much of a warp's march is idle lanes?

The analytic kernels (K1–K5) run one pixel a thread in 32×8 blocks, so a warp
is 32 neighbouring pixels of one row, and a loop runs until the warp's
slowest ray ends.  This lab counts, on the fit demo's start scene
(``union(ground_plane(), sphere((0.05, 0.45, 0), 0.25))``, the reference
camera and constants), each pixel's steps in the two marches (the plain
render's counters: the kernels' loops) and the warp efficiency of each loop,
the sum of the steps over 32 × each warp's most, for warps of 32×1 pixels
(the kernels'), 16×2, 8×4 and 4×8.

    python -m sdf3d_tpu_torch.benchmarks.divergence [--device cuda] [--width 1920] [--height 1080]

Prints one JSON line.  The counts are the program's own, the same on any
device; ``--device`` only says where the plain render runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

#: Warp shapes (pixels across, pixels down), the kernels' first.
SHAPES = ((32, 1), (16, 2), (8, 4), (4, 8))


def warp_efficiency(steps: torch.Tensor, wx: int, wy: int) -> float:
    """Steps summed over 32 × each warp's most, for warps of ``wx × wy``
    pixels tiling the (H, W) plane ``steps`` (a ragged edge padded with
    idle lanes)."""
    H, W = steps.shape
    s = torch.nn.functional.pad(steps.to(torch.float64), (0, -W % wx, 0, -H % wy))
    s = s.reshape(s.shape[0] // wy, wy, s.shape[1] // wx, wx).permute(0, 2, 1, 3).reshape(-1, wx * wy)
    return float(s.sum() / (32.0 * s.max(1).values.sum()))


def measure(width: int = 1920, height: int = 1080, device="cuda") -> dict:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops.fit_kernel import _uniforms
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward_plain
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    dev = torch.device(device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=width, height=height)
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25)).to(dev)
    uni = _uniforms(tt.Camera.reference(device=dev), tt.reference_light(device=dev),
                    tt.reference_material(device=dev), cfg, dev)
    steps = {}
    render_kernel_forward_plain(scene, scene_param_vector(scene, dev), uni, cfg, steps=steps)
    out = {"width": width, "height": height, "device": str(dev)}
    for loop in ("primary", "shadow"):
        s = steps[loop]
        out[loop] = {"mean_steps": float(s.mean()), "max_steps": float(s.max()),
                     "warp_efficiency": {f"{wx}x{wy}": warp_efficiency(s, wx, wy) for wx, wy in SHAPES}}
    out["shadow"]["rays_marching"] = float((steps["shadow"] > 0).to(torch.float64).mean())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.width, args.height, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
