"""Neural SDF demo: distill an analytic shape into an MLP, then orbit it (the
port of ``examples/neural_sdf.py``).

    python -m sdf3d_tpu_torch.examples.neural_sdf [--hidden 64] [--steps 400]
        [--frames 12] [--size 256] [--out DIR] [--device cuda|cpu]

Distills a smooth-union blob into a NeuralSDF of ``--hidden`` units and
depth 3 (distance regression plus eikonal regularisation, ``sdf.distill``,
batches of 4096 on ``--device``), then renders a turntable of
``ground_plane() | model`` at ``--size``×(3/4·``--size``) with a 64-step
march and a 32-step shadow: ``render_batch(engine="kernel")``, one launch of
the neural kernel K6 a frame (its plain PyTorch version with ``--device
cpu``).  The frames go to ``--out`` (default ``build/neural_sdf`` under the
repository).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch


def distill_blob(hidden: int, steps: int, device):
    """The JAX script's distillation: ``neural_sdf(0, hidden, depth=3,
    radius=0.3)`` regressed onto the blob for ``steps`` Adam steps of 4096
    points drawn from a generator seeded 1 on ``device``.  Returns
    ``(model, losses)``."""
    from sdf3d_tpu_torch import sdf

    blob = sdf.smooth_union(
        sdf.sphere(center=(-0.12, 0.4, 0.0), radius=0.18),
        sdf.sphere(center=(0.15, 0.48, 0.0), radius=0.14),
        k=0.08,
    )
    return sdf.distill(
        sdf.neural_sdf(0, hidden=hidden, depth=3, radius=0.3).to(device),
        blob, generator=1, steps=steps, batch=4096,
        lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6),
    )


def render_config(size: int):
    """The turntable's settings: ``size``×(3/4·``size``), a 64-step march and
    a 32-step shadow."""
    import sdf3d_tpu_torch as tt

    return dataclasses.replace(
        tt.REFERENCE_CONFIG, width=size, height=size * 3 // 4,
        march=dataclasses.replace(tt.REFERENCE_CONFIG.march, max_steps=64),
        shadow=dataclasses.replace(tt.REFERENCE_CONFIG.shadow, max_steps=32),
    )


def render_frames(model, n_frames: int, size: int, device) -> torch.Tensor:
    """``(n_frames, H, W, 3)``: orbit frames of ``ground_plane() | model`` at
    elevation 18°, one ``render_batch(engine="kernel")`` frame each."""
    import sdf3d_tpu_torch as tt

    cfg = render_config(size)
    scene = tt.sdf.ground_plane().to(device) | model.to(device)
    cams = [tt.Camera.orbit(azimuth_deg=360.0 * k / n_frames, elevation_deg=18.0) for k in range(n_frames)]
    return tt.render_batch(scene, cams, tt.reference_light(), tt.reference_material(), cfg, engine="kernel",
                           device=device)


def main(argv=None) -> int:
    from sdf3d_tpu_torch.utils import write_png

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.neural_sdf", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parents[2] / "build" / "neural_sdf"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("neural_sdf: no CUDA device; pass --device cpu to run the kernel's plain version")
    model, losses = distill_blob(args.hidden, args.steps, dev)
    print(f"distill loss {losses[0]:.4f} -> {losses[-1]:.6f}")

    frames = render_frames(model, args.frames, args.size, dev).cpu().numpy()
    for k in range(args.frames):
        write_png(out / f"frame_{k:05d}.png", frames[k])
    print(f"{args.frames} neural-scene frames -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
