"""Inverse rendering demo: recover sphere parameters from a target image (the
port of ``examples/inverse_fit.py``).

    python -m sdf3d_tpu_torch.examples.inverse_fit [--steps 200] [--lr 1e-2]
        [--out DIR] [--device cuda|cpu]

The target, the start and the fitted scene render at 96×64 on a black
background with ``render_batch(engine="kernel")``: one launch of the render
kernel K1 each.  ``fit_scene`` with the multiscale loss and the silhouette
term launches the fit kernel K3 once a step, the pyramid and the coverage
term both inside it; the plane is frozen.  ``--device cpu`` runs the kernels'
plain PyTorch versions.  The PNGs, ``metrics.jsonl`` and a checkpoint every
50 steps (``ckpt/``) go to ``--out`` (default ``build/inverse_fit`` under the
repository); a checkpoint of the same setup there is resumed.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.utils import MetricsLogger, write_png

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.inverse_fit", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parents[2] / "build" / "inverse_fit"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = torch.device(args.device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=96, height=64, background=(0.0, 0.0, 0.0))
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()

    def render(scene):
        return tt.render_batch(scene, [cam], light, mat, cfg, engine="kernel", device=dev)[0]

    true_scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2))
    target = render(true_scene)
    write_png(out / "target.png", target.cpu().numpy())

    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.08, 0.45, 0.0), radius=0.27))
    write_png(out / "init.png", render(scene0).cpu().numpy())

    with MetricsLogger(str(out / "metrics.jsonl")) as log:
        result = fit_scene(
            target, scene0, cam, light, mat, cfg,
            FitConfig(steps=args.steps, learning_rate=args.lr, loss="multiscale", silhouette_weight=1.0,
                      checkpoint_dir=str(out / "ckpt"), checkpoint_every=50),
            logger=log, trainable=(False, False, True, True), device=dev,
        )

    write_png(out / "fitted.png", render(result.scene).cpu().numpy())
    center, radius = (x.detach().cpu() for x in (result.scene.b.center, result.scene.b.radius))
    print("true   : center (0, 0.4, 0)  radius 0.2")
    print(f"fitted : center {np.round(center.numpy(), 4).tolist()}  radius {float(radius):.4f}")
    print(f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.4f}  "
          f"({result.rays_per_second:.3g} rays/s fwd+bwd)  -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
