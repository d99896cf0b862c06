"""Fast-profile lab: throughput and image delta of the declared non-parity
fast profile (``config.fast_config``: tetrahedron normals and a capped
shadow march) against the parity profile, on the card (the port of
``benchmarks/fast_profile.py``).

Two measurements, at 1920×1080 unless asked otherwise:

1. **Image delta** on the reference scene and the flagship: one parity
   render and one fast render of the same frame, each ``render_batch(
   engine="kernel")`` (K1 on the card); PSNR, max abs error and the share
   of pixels that move by more than 1% over the clamped image
   (:func:`image_delta`).
2. **Throughput**: the slope-measured ``fwd`` (K1) and ``fwd_bwd`` (K3)
   rays/s of each profile through ``bench.run_benchmark``, the bench's own
   harness, so the rows compare with its headline cells.

The JAX lab's third profile, ``fast_stop2``, and its image delta thin the
TPU kernel's stop predicate (``PallasRenderConfig.stop_every``), a knob of
the TPU's whole-tile exit check that the port's kernels do not have (one
thread a ray exits on its own), so they are left out.

    python -m sdf3d_tpu_torch.benchmarks.fast_profile [--quick] [--width 1920 --height 1080] [--device cuda|cpu]

Prints each delta and each row as a JSON line, then one JSON object of all
of them.  ``--quick``: fewer slope iterations.  Runs on the card;
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch


def image_delta(scene_name: str, width: int = 1920, height: int = 1080, device="cuda") -> dict:
    """Parity against fast render of ``scene_name`` at the reference
    camera: ``psnr_db``, ``max_abs_err`` and ``pixels_changed_gt_1pct``
    over the images clamped to [0, 1] (the JAX lab's fields)."""
    import sdf3d_tpu_torch as tt

    dev = torch.device(device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=width, height=height)
    fast = tt.fast_config(cfg)
    cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
    scene = {"reference": tt.reference_scene, "flagship": tt.flagship_scene}[scene_name]()
    a, b = (np.clip(tt.render_batch(scene, [cam], light, mat, c, engine="kernel", device=dev)[0].cpu().numpy(),
                    0.0, 1.0) for c in (cfg, fast))
    mse = float(np.mean((a - b) ** 2))
    return {
        "scene": scene_name,
        "psnr_db": 10.0 * math.log10(1.0 / max(mse, 1e-12)),
        "max_abs_err": float(np.max(np.abs(a - b))),
        "pixels_changed_gt_1pct": float(np.mean(np.any(np.abs(a - b) > 0.01, axis=-1))),
    }


def main(argv=None) -> int:
    from sdf3d_tpu_torch.bench import run_benchmark

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.fast_profile", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="4 iterations of 8-frame chunks (default 10 of 16)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the lab runs on the card and no CUDA device is visible (--device cpu: plain versions)")
    out: dict = {"deltas": [], "throughput": []}
    for scene_name in ("reference", "flagship"):
        d = image_delta(scene_name, args.width, args.height, dev)
        out["deltas"].append(d)
        print(json.dumps(d), flush=True)
    for profile in ("parity", "fast"):
        for mode in ("fwd", "fwd_bwd"):
            r = run_benchmark(args.width, args.height, mode=mode, profile=profile, iters=4 if args.quick else 10,
                              frames_per_dispatch=8 if args.quick else 16, device=dev)
            row = {"profile": profile, "mode": mode, "rays_per_s": r["value"],
                   "ms_per_frame": 1e3 * r["seconds_per_frame"], "backend": r["backend"]}
            out["throughput"].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
