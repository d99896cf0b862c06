"""Render every scene preset and the flagship's AOV debug views to PNGs (the
port of ``examples/render_gallery.py``).

    python -m sdf3d_tpu_torch.examples.render_gallery [--width 320]
        [--height 240] [--out DIR] [--device cuda|cpu]

Seven scenes (the reference scene, the flagship, ``csg_showcase``, the
lattice, the capsule chain, ``random_blobs(n=8)`` and the fractal) under the
JAX gallery's cameras, with ambient occlusion on: ``render_batch(engine=
"kernel")``, one launch of the render kernel K1 (its AO branch) a scene.
The four AOVs of the flagship (depth, normals, shadow, AO) come from the
torch march (``sphere_trace``, ``estimate_normals``, ``soft_shadow``,
``ambient_occlusion``) through ``viz.turbo``.  ``--device cpu`` runs K1's
plain PyTorch version.  The PNGs go to ``--out`` (default ``build/
render_gallery`` under the repository).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch


def gallery_scenes() -> dict:
    """``name -> (scene, camera)``: the JAX gallery's scene presets under its
    cameras, on the CPU."""
    import sdf3d_tpu_torch as tt

    orbit = tt.Camera.orbit
    return {
        "reference": (tt.reference_scene(), tt.Camera.reference()),
        "flagship": (tt.flagship_scene(), orbit(30, 20, 2.0)),
        "csg_showcase": (tt.csg_showcase(), orbit(25, 25, 2.4)),
        "lattice": (tt.lattice_scene(), orbit(15, 18, 3.0)),
        "capsule_chain": (tt.capsule_chain(), orbit(0, 25, 2.2)),
        "random_blobs": (tt.random_blobs(n=8), orbit(40, 22, 2.4)),
        "fractal": (tt.fractal_scene(), orbit(20, 15, 1.9)),
    }


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.camera import camera_rays
    from sdf3d_tpu_torch.config import AOConfig
    from sdf3d_tpu_torch.march import ambient_occlusion, estimate_normals, soft_shadow, sphere_trace
    from sdf3d_tpu_torch.sdf.node import vnormalize
    from sdf3d_tpu_torch.utils import write_png
    from sdf3d_tpu_torch.viz import turbo

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.render_gallery", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parents[2] / "build" / "render_gallery"))
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = torch.device(args.device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=args.width, height=args.height, ao=AOConfig(enabled=True))
    light, mat = tt.reference_light(), tt.reference_material()

    scenes = gallery_scenes()
    for name, (scene, cam) in scenes.items():
        img = tt.render_batch(scene, [cam], light, mat, cfg, engine="kernel", device=dev)[0]
        write_png(out / f"{name}.png", img.cpu().numpy())
        print(f"{name}.png")

    # AOV debug views for the flagship scene.
    scene, cam = scenes["flagship"]
    scene, cam, light = scene.to(dev), cam.to(dev), light.to(dev)
    with torch.no_grad():
        o, d = camera_rays(cam, cfg.width, cfg.height)
        t = sphere_trace(scene.distance, o, d, cfg.march)
        p = o + t[..., None] * d
        n = estimate_normals(scene.distance, p, "central", cfg.march.epsilon)
        inc = vnormalize(light.position - p)
        sh = soft_shadow(scene.distance, p + n * 0.02, inc, cfg.shadow, cfg.march)
        ao = ambient_occlusion(scene.distance, p, n, cfg.ao)
    write_png(out / "aov_depth.png", turbo(torch.clamp(t / 5.0, 0, 1)).cpu().numpy())
    write_png(out / "aov_normals.png", (n * 0.5 + 0.5).cpu().numpy())
    write_png(out / "aov_shadow.png", turbo(sh).cpu().numpy())
    write_png(out / "aov_ao.png", turbo(ao).cpu().numpy())
    print("aov_{depth,normals,shadow,ao}.png")
    print(f"gallery -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
