"""Command-line entry point of the port: ``render``, ``fit``, ``fit-view``,
``bench`` and ``info`` (the ports of the JAX package's ``sdf3d`` subcommands
of those names).

    python -m sdf3d_tpu_torch.cli render --width 1920 --height 1080 --out out.png
    python -m sdf3d_tpu_torch.cli fit --width 1920 --height 1080 --steps 100 --metrics fit.jsonl
    python -m sdf3d_tpu_torch.cli fit-view --width 128 --height 96 --steps 200
    python -m sdf3d_tpu_torch.cli bench            # one JSON line: fwd_bwd rays/s at 1080p
    python -m sdf3d_tpu_torch.cli info

``render --engine kernel`` (default) renders through the CUDA render kernel,
``--engine torch`` through the plain PyTorch path (which alone takes
``--normals autodiff``); ``--depth`` writes the marched distance
(``render_depth``, the torch march) through the turbo colormap instead.  ``fit`` is the
inverse-rendering demo: it renders the scene as the target, then recovers
the sphere of a perturbed start with the fused fit-step kernel.  ``fit-view``
is the pose-estimation demo: it recovers a perturbed camera with the pixel L2
and the silhouette term (its target coverage from ``diff.coverage`` at the
true camera) and prints the position error before and after.
``--device`` defaults to ``cuda``; without a card the command fails rather
than moving to the CPU (pass ``--device cpu`` to run the kernels' plain
versions there).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
import warnings

import numpy as np


def _build_scene(name: str):
    import sdf3d_tpu_torch as s

    scenes = {"reference": s.reference_scene, "sphere": s.sphere_scene, "flagship": s.flagship_scene,
              "fractal": s.fractal_scene}
    if name not in scenes:
        raise SystemExit(f"unknown scene {name!r}; choose from {sorted(scenes)}")
    return scenes[name]()


def _apply_flags(cfg, args):
    """``--profile fast`` first, then the explicit flags, which win."""
    import sdf3d_tpu_torch as s

    if args.profile == "fast":
        cfg = s.fast_config(cfg)
    updates = {}
    if args.width:
        updates["width"] = args.width
    if args.height:
        updates["height"] = args.height
    if args.normals:
        updates["normals"] = args.normals
    if args.ao:
        updates["ao"] = dataclasses.replace(cfg.ao, enabled=True)
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _orbit_override_given(args) -> bool:
    return any(getattr(args, k) is not None for k in ("azimuth", "elevation", "radius"))


def _file_camera(cam, args):
    """Orbit flags on top of a setup file's camera: the pose changes, the
    file camera's fov is kept, and so is its distance from the default
    orbit target (0, 0.2, 0) unless ``--radius`` is passed."""
    import sdf3d_tpu_torch as s

    to_target = np.array([0.0, 0.2, 0.0]) - cam.position.detach().cpu().numpy()
    file_radius = float(np.linalg.norm(to_target))
    if args.radius is None:
        forward = -cam.c2w.detach().cpu().numpy()[:, 2]
        aligned = float(np.dot(forward, to_target) / max(file_radius, 1e-9))
        if aligned < 0.999:
            warnings.warn(
                "--azimuth/--elevation without --radius: camera distance inferred from the "
                f"default orbit target (0, 0.2, 0), but the file camera does not look at it "
                f"(alignment {aligned:.3f}); pass --radius to place the camera exactly",
                stacklevel=2,
            )
    return s.Camera.orbit(
        azimuth_deg=args.azimuth or 0.0,
        elevation_deg=args.elevation or 0.0,
        radius=args.radius if args.radius is not None else file_radius,
        fov_deg=float(cam.fov_deg),
    )


def cmd_render(args) -> int:
    import torch

    import sdf3d_tpu_torch as s
    from sdf3d_tpu_torch.utils import write_png

    if args.scene_file:
        from sdf3d_tpu_torch.sdf.io import load_setup

        setup = load_setup(args.scene_file)
        scene, cam = setup["scene"], setup["camera"]
        light, mat = setup["light"], setup["material"]
        cfg = _apply_flags(setup["config"], args)
        if _orbit_override_given(args):
            cam = _file_camera(cam, args)
    else:
        scene = _build_scene(args.scene)
        cfg = _apply_flags(s.REFERENCE_CONFIG, args)
        if _orbit_override_given(args):
            cam = s.Camera.orbit(
                azimuth_deg=args.azimuth or 0.0,
                elevation_deg=args.elevation or 0.0,
                radius=args.radius if args.radius is not None else 2.0,
            )
        else:
            cam = s.Camera.reference()
        light, mat = s.reference_light(), s.reference_material()

    if args.depth:
        # JAX's depth view: the marched distance over 5 units through turbo.
        from sdf3d_tpu_torch.viz import turbo

        dev = torch.device(args.device)
        d = s.render_depth(copy.deepcopy(scene).to(dev), cam.to(dev), cfg)
        img = turbo(torch.clamp(d / 5.0, 0.0, 1.0))
    else:
        img = s.render_batch(scene, [cam], light, mat, cfg, engine=args.engine, device=args.device)[0]
    write_png(args.out, img.to(torch.device("cpu")).numpy())
    print(f"wrote {cfg.width}x{cfg.height} -> {args.out}")
    return 0


def cmd_fit(args) -> int:
    import sdf3d_tpu_torch as s
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward
    from sdf3d_tpu_torch.utils import MetricsLogger

    cfg = _apply_flags(s.REFERENCE_CONFIG, args)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    target = render_kernel_forward(_build_scene(args.scene), cam, light, mat, cfg, device=args.device)[0]
    # Perturbed start: the demo recovers the reference sphere's centre and
    # radius; the plane is frozen (its unit normal is a constraint the raw
    # parameters do not encode).
    scene0 = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))
    with MetricsLogger(args.metrics) as logger:
        result = fit_scene(
            target, scene0, cam, light, mat, cfg,
            FitConfig(steps=args.steps, learning_rate=args.lr, checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir),
            logger=logger, trainable=(False, False, True, True), device=args.device,
        )
    print(f"final loss {result.losses[-1]:.6f} after {result.steps_run} steps "
          f"({result.rays_per_second:.3g} rays/s fwd+bwd)")
    return 0


def cmd_fit_view(args) -> int:
    import torch

    import sdf3d_tpu_torch as s
    from sdf3d_tpu_torch.fit import FitConfig, fit_view
    from sdf3d_tpu_torch.diff import coverage
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward
    from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix
    from sdf3d_tpu_torch.utils import MetricsLogger

    cfg = _apply_flags(s.REFERENCE_CONFIG, args)
    device = torch.device(args.device)
    scene = _build_scene(args.scene).to(device)
    light, mat = s.reference_light(device=device), s.reference_material(device=device)
    cam_true = s.Camera.reference(device=device)
    target = render_kernel_forward(scene, cam_true, light, mat, cfg, device=device)[0]
    o, d = s.camera_rays(cam_true, cfg.width, cfg.height, cfg.ray_mode)
    with torch.no_grad():
        cov_target = coverage(cfg.march, scene, o, d)

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    rot = rotvec_to_matrix(args.pert * vec([0.3, 0.8, -0.3]))
    cam0 = s.Camera(position=cam_true.position + args.pert * vec([1.0, -0.7, 1.3]),
                    c2w=(rot[:, :, None] * cam_true.c2w[None, :, :]).sum(1), fov_deg=cam_true.fov_deg)
    with MetricsLogger(args.metrics) as logger:
        result = fit_view(target, scene, cam0, light, mat, cfg,
                          FitConfig(steps=args.steps, learning_rate=args.lr, silhouette_weight=1.0),
                          optimize=("camera",), logger=logger, target_coverage=cov_target, device=device)
    e0 = float(torch.linalg.vector_norm(cam0.position - cam_true.position))
    e1 = float(torch.linalg.vector_norm(result.camera.position - cam_true.position))
    print(f"final loss {result.losses[-1]:.6f} after {result.steps_run} steps; position error {e0:.4f} -> {e1:.4f}")
    return 0


def cmd_bench(args) -> int:
    import json

    from sdf3d_tpu_torch.bench import run_benchmark

    result = run_benchmark(width=args.width or 1920, height=args.height or 1080, engine=args.engine,
                           profile=args.profile, device=args.device)
    print(json.dumps(result))
    return 0


def cmd_info(args) -> int:
    import torch

    import sdf3d_tpu_torch

    print(f"sdf3d_tpu_torch {sdf3d_tpu_torch.__version__}")
    print(f"torch {torch.__version__}")
    print(f"cuda {torch.version.cuda} (available: {torch.cuda.is_available()})")
    print("  cpu")
    for i in range(torch.cuda.device_count()):
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sdf3d_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="render a scene to a PNG")
    pr.add_argument("--scene", default="reference")
    pr.add_argument("--scene-file", default=None, help="JSON setup file (sdf.save_setup of either package)")
    pr.add_argument("--width", type=int, default=0)
    pr.add_argument("--height", type=int, default=0)
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--azimuth", type=float, default=None)
    pr.add_argument("--elevation", type=float, default=None)
    pr.add_argument("--radius", type=float, default=None)
    pr.add_argument("--normals", choices=["central", "tetrahedron", "autodiff"], default=None,
                    help="'autodiff' takes --engine torch (the kernels raise, as JAX's Pallas path)")
    pr.add_argument("--ao", action="store_true")
    pr.add_argument("--depth", action="store_true",
                    help="write the turbo-mapped marched distance (render_depth / 5) instead of RGB")
    pr.add_argument("--profile", choices=["parity", "fast"], default="parity",
                    help="'fast' = config.fast_config (non-parity)")
    pr.add_argument("--engine", choices=["kernel", "torch"], default="kernel")
    pr.add_argument("--device", default="cuda")
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("fit", help="inverse-rendering demo: recover scene params")
    pf.add_argument("--scene", default="reference")
    pf.add_argument("--width", type=int, default=96)
    pf.add_argument("--height", type=int, default=72)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--metrics", default=None, help="JSONL metrics file")
    pf.add_argument("--checkpoint-dir", default=None)
    pf.add_argument("--checkpoint-every", type=int, default=0)
    pf.add_argument("--device", default="cuda")
    pf.set_defaults(fn=cmd_fit, profile="parity", normals=None, ao=False)

    pv = sub.add_parser("fit-view", help="pose-estimation demo: recover a perturbed camera")
    pv.add_argument("--scene", default="reference")
    pv.add_argument("--width", type=int, default=128)
    pv.add_argument("--height", type=int, default=96)
    pv.add_argument("--steps", type=int, default=200)
    pv.add_argument("--lr", type=float, default=2e-3)
    pv.add_argument("--pert", type=float, default=0.06)
    pv.add_argument("--metrics", default=None, help="JSONL metrics file")
    pv.add_argument("--device", default="cuda")
    pv.set_defaults(fn=cmd_fit_view, profile="parity", normals=None, ao=False)

    pb = sub.add_parser("bench", help="throughput benchmark (prints one JSON line)")
    pb.add_argument("--width", type=int, default=0)
    pb.add_argument("--height", type=int, default=0)
    pb.add_argument("--engine", choices=["kernel", "torch"], default="kernel")
    pb.add_argument("--profile", choices=["parity", "fast"], default="parity",
                    help="'fast' = config.fast_config (non-parity)")
    pb.add_argument("--device", default="cuda")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="version and device info")
    pi.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
