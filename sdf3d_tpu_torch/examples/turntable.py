"""360-degree turntable animation via the interactive session (the port of
``examples/turntable.py``).

    python -m sdf3d_tpu_torch.examples.turntable [--frames 24] [--out DIR]
        [--scene flagship|reference|csg] [--device cuda|cpu]

Each 320×240 frame (the JAX example's size) is ``render_batch(engine=
"kernel")`` of one orbit camera: one launch of the render kernel K1 on the
card (its plain PyTorch version with ``--device cpu``).  The PNG frames go to
``--out`` (default ``build/turntable`` under the repository).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.interact import render_turntable

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.turntable", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parents[2] / "build" / "turntable"))
    ap.add_argument("--scene", default="flagship", choices=["reference", "flagship", "csg"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=320, height=240)
    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    scene = {"reference": tt.reference_scene, "flagship": tt.flagship_scene,
             "csg": tt.csg_showcase}[args.scene]()

    frames = render_turntable(
        lambda cam: tt.render_batch(scene, [cam], light, mat, cfg, engine="kernel", device=dev)[0], cfg,
        n_frames=args.frames, out_dir=args.out, device=dev,
    )
    print(f"{len(frames)} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
