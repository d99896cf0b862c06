"""Free-form shape recovery: fit a voxel-grid SDF to a target render (the
port of ``examples/grid_fit.py``).

    python -m sdf3d_tpu_torch.examples.grid_fit [--res 24] [--steps 300]
        [--lr 2e-3] [--size 96] [--out DIR] [--device cuda|cpu]

The analytic fits (``inverse_fit``) recover a handful of named parameters;
this demo fits every sample of a voxel grid (``sdf.VoxelGrid``), the
discrete precursor of a neural SDF.  The grid starts as a baked sphere and is
pulled toward a smooth-union "peanut" it has never seen, under the
multiscale loss, the shadow off.  The analytic target renders on the render
kernel K1 (``render_batch(engine="kernel")``); no kernel takes a grid, so
the grid's images render on the torch engine and its fit runs the kernel
engine's banded route (``render_autograd.BandedRenderFunction``) on the
torch march.  ``--device cpu`` runs K1's plain PyTorch version.  The PNGs go
to ``--out`` (default ``build/grid_fit`` under the repository).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops.scene_program import has_emitters
    from sdf3d_tpu_torch.utils import write_png

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.grid_fit", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--res", type=int, default=24, help="grid resolution per axis")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--size", type=int, default=96, help="render width")
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parents[2] / "build" / "grid_fit"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = torch.device(args.device)
    cfg = dataclasses.replace(
        tt.REFERENCE_CONFIG,
        width=args.size,
        height=args.size * 3 // 4,
        shadow=dataclasses.replace(tt.REFERENCE_CONFIG.shadow, enabled=False),
    )
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()

    def render(scene):
        engine = "kernel" if has_emitters(scene) else "torch"
        return tt.render_batch(scene, [cam], light, mat, cfg, engine=engine, device=dev)[0]

    # Target: a smooth-union peanut the initial sphere-grid has never seen.
    blob = tt.sdf.smooth_union(
        tt.sdf.sphere(center=(-0.12, 0.4, 0.0), radius=0.18),
        tt.sdf.sphere(center=(0.15, 0.48, 0.0), radius=0.14),
        k=0.08,
    )
    target_scene = tt.sdf.ground_plane() | blob
    target = render(target_scene)
    write_png(out / "target.png", target.cpu().numpy())

    # Start: a baked sphere grid (every sample now a free parameter).
    box_lo, box_hi = (-0.6, -0.1, -0.6), (0.6, 1.1, 0.6)
    grid0 = tt.sdf.voxelize(
        tt.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2),
        resolution=args.res, lo=box_lo, hi=box_hi,
    )
    scene0 = tt.sdf.ground_plane() | grid0
    # One flag per leaf: the plane's normal and offset, the grid's values,
    # origin and spacing.
    trainable = (False, False, True, False, False)
    initial = render(scene0)
    write_png(out / "initial.png", initial.cpu().numpy())

    result = fit_scene(
        target, scene0, cam, light, mat, cfg,
        FitConfig(steps=args.steps, learning_rate=args.lr, loss="multiscale", log_every=max(args.steps // 10, 1)),
        trainable=trainable, device=dev,
    )
    final = render(result.scene)
    write_png(out / "fitted.png", final.cpu().numpy())

    err0 = float(torch.mean((initial - target) ** 2))
    err1 = float(torch.mean((final - target) ** 2))
    print(f"losses: {['%.1f' % x for x in result.losses]}")
    print(f"mean-sq pixel error: initial {err0:.5f} -> fitted {err1:.5f}")
    print(f"wrote {out}/target.png, initial.png, fitted.png")
    assert err1 < err0, "fit should reduce image error"
    return 0


if __name__ == "__main__":
    sys.exit(main())
