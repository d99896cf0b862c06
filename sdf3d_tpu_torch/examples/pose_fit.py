"""Camera-pose estimation demo: recover a perturbed camera from one image (the
port of ``examples/pose_fit.py``).

    python -m sdf3d_tpu_torch.examples.pose_fit [--steps 300] [--lr 2e-3]
        [--pert 0.06] [--out DIR] [--device cuda|cpu]

The complement of ``inverse_fit``: the scene is known and fixed; the unknowns
are the view parameters (the eye position and a rotation in the SO(3)
tangent space, ``fit_view``'s delta-rotation parameterisation).  The
silhouette (coverage) term supplies the pose gradient that the plain pixel L2
misses.  At 128×96 the target, the start and the fitted view render with
``render_batch(engine="kernel")`` (K1 once each) and ``fit_view`` launches
the fit kernel K3 once a step with the uniforms' gradient and the coverage
term; the target's coverage is ``diff.coverage`` on the torch march.
``--device cpu`` runs the kernels' plain PyTorch versions.  The PNGs and
``metrics.jsonl`` go to ``--out`` (default ``build/pose_fit`` under the
repository).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.camera import camera_rays
    from sdf3d_tpu_torch.diff import coverage
    from sdf3d_tpu_torch.fit import FitConfig, fit_view
    from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix
    from sdf3d_tpu_torch.utils import MetricsLogger, write_png

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.pose_fit", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--pert", type=float, default=0.06, help="pose perturbation scale")
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parents[2] / "build" / "pose_fit"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = torch.device(args.device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=128, height=96)
    light, mat = tt.reference_light(), tt.reference_material()
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2))

    def render(cam):
        return tt.render_batch(scene, [cam], light, mat, cfg, engine="kernel", device=dev)[0]

    cam_true = tt.Camera.reference()
    target = render(cam_true)
    write_png(out / "target.png", target.cpu().numpy())
    o, d = camera_rays(cam_true.to(dev), cfg.width, cfg.height, cfg.ray_mode)
    with torch.no_grad():
        cov_target = coverage(cfg.march, scene.to(dev), o, d, None)

    # Perturbed initial guess: translated + rotated (built on the CPU, in
    # float32, as the JAX script's).
    cam0 = tt.Camera(
        position=cam_true.position + args.pert * torch.tensor([1.0, -0.7, 1.3]),
        c2w=rotvec_to_matrix(args.pert * torch.tensor([0.3, 0.8, -0.3])) @ cam_true.c2w,
        fov_deg=cam_true.fov_deg,
    )
    write_png(out / "init.png", render(cam0).cpu().numpy())

    with MetricsLogger(str(out / "metrics.jsonl")) as log:
        result = fit_view(
            target, scene, cam0, light, mat, cfg,
            FitConfig(steps=args.steps, learning_rate=args.lr, silhouette_weight=1.0),
            optimize=("camera",), logger=log, target_coverage=cov_target, device=dev,
        )

    fitted = result.camera.to("cpu")
    write_png(out / "fitted.png", render(fitted).cpu().numpy())
    e0 = float(torch.linalg.vector_norm(cam0.position - cam_true.position))
    e1 = float(torch.linalg.vector_norm(fitted.position.detach() - cam_true.position))
    print(f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.4f}")
    print(f"position error {e0:.4f} -> {e1:.4f}   -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
