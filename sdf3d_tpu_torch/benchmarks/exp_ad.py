"""Where does the fused fit step's fixed cost live?  (The port of
``benchmarks/exp_ad.py``.)

Variants of K3's kernel function (``ops.fit_kernel.fit_step_variant``, K9),
timed interleaved at 1080p with the march and the shadow cut to one step, so
that only the fixed section varies:

  full      value and gradient w.r.t. (params, uniforms)   [K3 itself]
  wrt_p     value and gradient w.r.t. params only
  nopow     full, the specular power as the chain x³·x³·x³·x³
  primal    tile loss only, no reverse pass

    python -m sdf3d_tpu_torch.benchmarks.exp_ad          # one-step marches
    python -m sdf3d_tpu_torch.benchmarks.exp_ad full     # REFERENCE_CONFIG

Prints ``name ms`` per variant: the best of 4 rounds of the time per frame
(``utils.profiling.benchmark_fn``, 10 chunks of 8 frames), then
``launches N``, the kernel launches of the run
(``fit_step_variant.launches``).  Runs on the card (``--device``; ``cpu``
runs the plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

FRAMES = 8


def short_config(cfg):
    """``cfg`` with the march and the shadow cut to one step (one
    evaluation each: the kernel has no whole-tile check to thin)."""
    return dataclasses.replace(cfg, march=dataclasses.replace(cfg.march, max_steps=1),
                               shadow=dataclasses.replace(cfg.shadow, max_steps=1))


def make_variant(variant: str, cfg, kc=None, device="cuda"):
    """``(fn, scene)`` for the fit step's ``variant`` on the reference scene,
    camera, light and material under ``cfg``: ``fn(scene)`` runs an
    8-frame chunk against a zero target, each frame adding ``1e-30·loss`` to
    every parameter on the device, and returns the 8 losses."""
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops.fit_kernel import _uniforms, fit_step_variant
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    device = torch.device(device)
    kc = kc or KernelConfig()
    scene = tt.reference_scene().to(device)
    cam = tt.Camera.reference(device=device)
    uni = _uniforms(cam, tt.reference_light(device=device), tt.reference_material(device=device), cfg, device)
    target = torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32, device=device)

    def fn(sc):
        prm = scene_param_vector(sc, device)
        losses = []
        for _ in range(FRAMES):
            loss = fit_step_variant(variant, sc, prm, uni, target, cfg, kc)[0]
            prm = prm + 1e-30 * loss
            losses.append(loss)
        return torch.stack(losses)

    return fn, scene


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_variant
    from sdf3d_tpu_torch.utils.profiling import benchmark_fn

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.exp_ad", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", nargs="?", choices=["short", "full"], default="short",
                    help="'full': REFERENCE_CONFIG; default: one-step march and shadow")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (--device cpu runs the plain versions)")

    base = dataclasses.replace(tt.REFERENCE_CONFIG, width=args.width, height=args.height)
    cfg = base if args.config == "full" else short_config(base)
    fns = {v: make_variant(v, cfg, device=args.device) for v in ("full", "wrt_p", "nopow", "primal")}
    best = {v: float("inf") for v in fns}
    for r in range(4):
        for v, (fn, scene) in fns.items():
            t = benchmark_fn(fn, scene, warmup=2 if r == 0 else 0, iters=10)
            best[v] = min(best[v], t / FRAMES)
        time.sleep(0.02)
    for v, t in best.items():
        print(f"{v:<10} {t * 1e3:7.3f} ms")
    print(f"{'launches':<10} {fit_step_variant.launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
