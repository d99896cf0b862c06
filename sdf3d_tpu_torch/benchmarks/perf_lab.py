"""Interleaved A/B kernel measurements on the card (the port of
``benchmarks/perf_lab.py``).

Measures a list of named render configurations round-robin (so a transient
slow window on a shared card cannot bias one configuration), reporting the
least time per frame of each over the rounds.  A case is ``(cfg, kc,
mode)``: a ``RenderConfig``, a ``KernelConfig`` and one of

- ``fwd``: K1 (``ops.render_kernel_forward``) over 8 orbit cameras;
- ``fwd_scan``: K1 at the reference camera, 8 frames in series, each
  frame's mean nudging the parameter vector so no frame can be skipped;
- ``fit``: K3 (``ops.fit_kernel.fit_step_kernel``, L2, without the
  uniforms' gradient), 8 steps in series (the bench's ``fwd_bwd`` chunk);
- ``fwd_bwd``: ``ops.render_kernel_diff`` (K1 forward, K5 backward) and the
  gradient of an L2 loss, 8 steps in series.

A chunk of ``FRAMES`` = 8 frames is a host loop (JAX's ``lax.map`` /
``lax.scan``), timed by ``utils.profiling.benchmark_fn``, which ends in a
device synchronisation.

Suites: ``stages``, ``breakdown``, ``refcam`` and ``fit_stages`` are the JAX
lab's without its TPU-only cases; ``tiles`` and ``fit_tiles`` sweep the one
knob of a kernel's shape that carries over to the card,
``KernelConfig.block_w × block_h`` (K1 and K3).  The JAX suites that sweep
TPU knobs only (``check``: ``check_every``; ``stop``: ``stop_every``; the
``chk*`` cases; the (8, 128)-multiple tile shapes) have no counterpart: the
kernels here have no whole-tile exit check to thin and no lane tiling.

    python -m sdf3d_tpu_torch.benchmarks.perf_lab [SUITE ...] [--cases NAME ...] [--rounds 4] [--iters 10]
        [--width 1920] [--height 1080] [--device cuda|cpu]

``--cases`` keeps only the named cases of the suites.

Prints one line per case (``name ms Mrays/s``), then one JSON object: each
case's ``ms`` and ``rays_per_s``, and the kernel launches of the run.  Runs
on the card; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

#: Frames of a chunk (one host loop, timed as one call).
FRAMES = 8


def make_fn(cfg, kc, mode: str = "fwd", scene_name: str = "reference", device="cuda"):
    """``(fn, arg)``: ``fn(arg)`` runs one chunk of ``FRAMES`` frames of
    ``mode`` on ``scene_name`` under ``cfg``/``kc`` and returns the frames'
    values (a tensor on the device)."""
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops.fit_kernel import _uniforms, fit_step_kernel
    from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward, render_kernel_run
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    device = torch.device(device)
    cam = tt.Camera.reference(device=device)
    light, mat = tt.reference_light(device=device), tt.reference_material(device=device)
    scene = {"reference": tt.reference_scene, "flagship": tt.flagship_scene}[scene_name]().to(device)
    if mode == "fwd":
        cams = [tt.Camera.orbit(azimuth_deg=360.0 * k / FRAMES, device=device) for k in range(FRAMES)]

        def fn(sc):
            return torch.stack([render_kernel_forward(sc, c, light, mat, cfg, kc, device=device)[0].mean()
                                for c in cams])

        return fn, scene
    uni = _uniforms(cam, light, mat, cfg, device)
    if mode == "fwd_scan":
        def fn(prm):
            out = []
            for _ in range(FRAMES):
                m = render_kernel_run(scene, prm, uni, cfg, kc)[0].mean()
                prm = prm + 1e-12 * m
                out.append(m)
            return torch.stack(out)

        return fn, scene_param_vector(scene, device)
    target = torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32, device=device)
    if mode == "fit":
        def fn(prm):
            out = []
            for _ in range(FRAMES):
                loss, g_prm, _ = fit_step_kernel(scene, prm, uni, target, cfg, kc, wrt_uniforms=False)
                prm = prm - 1e-30 * g_prm
                out.append(loss)
            return torch.stack(out)

        return fn, scene_param_vector(scene, device)
    if mode != "fwd_bwd":
        raise ValueError(f"unknown mode {mode!r}")
    target_hw = target.permute(1, 2, 0)

    def fn(sc):
        params, out = list(sc.parameters()), []
        for _ in range(FRAMES):
            loss = torch.sum((render_kernel_diff(cfg, kc, sc, cam, light, mat) - target_hw) ** 2)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.sub_(1e-30 * g)
            out.append(loss.detach())
        return torch.stack(out)

    return fn, scene


def launch_counts() -> dict:
    """The kernel launches of this process so far: K1, K3, K5."""
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward

    return {fn.__name__: fn.launches for fn in (render_kernel_forward, fit_step_kernel, render_kernel_backward)}


def _prebuild(cases: dict, device) -> None:
    """Build every case's library at once (one thread each) before timing."""
    if torch.device(device).type != "cuda":
        return
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.render_kernel import library_job

    scene = tt.reference_scene()
    jobs = {}
    for cfg, kc, mode in cases.values():
        job = library_job(scene, cfg, kc, wrt_uniforms=mode != "fit")
        jobs[job[0]] = job
    _build.LIBRARIES.load_many(list(jobs.values()))


def run(cases: dict, rounds: int = 4, iters: int = 10, device="cuda", out=print) -> dict:
    """``cases``: name -> ``(cfg, kc, mode)``.  Interleaved: each round
    times every case once (``iters`` chunks, two chunks of warm-up in the
    first round); a case's time is its least ms per frame over the rounds.
    Returns name -> seconds per frame."""
    from sdf3d_tpu_torch.utils.profiling import benchmark_fn

    _prebuild(cases, device)
    fns = {name: make_fn(cfg, kc, mode, device=device) for name, (cfg, kc, mode) in cases.items()}
    best = {name: float("inf") for name in cases}
    for r in range(rounds):
        for name, (fn, arg) in fns.items():
            t = benchmark_fn(fn, arg, warmup=2 if r == 0 else 0, iters=iters)
            best[name] = min(best[name], t / FRAMES)
        time.sleep(0.02)
    width = max(len(n) for n in best)
    for name, t in best.items():
        cfg = cases[name][0]
        out(f"{name:<{width}}  {t * 1e3:7.3f} ms  {cfg.width * cfg.height / t / 1e6:8.1f} Mrays/s")
    return best


def _no_shadow(cfg):
    return dataclasses.replace(cfg, shadow=dataclasses.replace(cfg.shadow, enabled=False))


def _one_step(cfg, march: bool, shadow: bool):
    if march:
        cfg = dataclasses.replace(cfg, march=dataclasses.replace(cfg.march, max_steps=1))
    if shadow:
        cfg = dataclasses.replace(cfg, shadow=dataclasses.replace(cfg.shadow, max_steps=1))
    return cfg


#: The block shapes of the ``tiles`` and ``fit_tiles`` sweeps (threads a
#: block: whole warps, at most 1024; 32×8 is the default).
BLOCKS = ((32, 8), (64, 4), (16, 16), (128, 2), (32, 4), (32, 16))


def suite_tiles(cfg):
    """K1 over the block shapes of :data:`BLOCKS` (JAX's tile sweep)."""
    from sdf3d_tpu_torch.ops import KernelConfig

    return {f"block_{bw}x{bh}": (cfg, KernelConfig(block_w=bw, block_h=bh), "fwd") for bw, bh in BLOCKS}


def suite_stages(cfg):
    from sdf3d_tpu_torch.ops import KernelConfig

    kc = KernelConfig()
    return {
        "fwd": (cfg, kc, "fwd"),
        "fwd_noshadow": (_no_shadow(cfg), kc, "fwd"),
        "fwd_bwd": (cfg, kc, "fwd_bwd"),
    }


def suite_breakdown(cfg):
    """Separate march-variable, shadow-variable and fixed (raygen, normals,
    shading, launch) cost: clamp each march to 1 step and difference."""
    from sdf3d_tpu_torch.ops import KernelConfig

    kc = KernelConfig()
    return {
        "full": (cfg, kc, "fwd"),
        "march1": (_one_step(cfg, True, False), kc, "fwd"),
        "shadow1": (_one_step(cfg, False, True), kc, "fwd"),
        "march1_shadow1": (_one_step(cfg, True, True), kc, "fwd"),
    }


def suite_refcam(cfg):
    """Reference-camera costs, serially dependent (comparable to the bench):
    forward-only against forward + backward."""
    from sdf3d_tpu_torch.ops import KernelConfig

    kc = KernelConfig()
    return {"fwdscan_default": (cfg, kc, "fwd_scan"), "fwdbwd_default": (cfg, kc, "fwd_bwd")}


def suite_fit_tiles(cfg):
    """K3 (the bench's ``fwd_bwd`` chunk) over the block shapes of
    :data:`BLOCKS`: the reverse pass may move the best shape."""
    from sdf3d_tpu_torch.ops import KernelConfig

    return {f"fit_{bw}x{bh}": (cfg, KernelConfig(block_w=bw, block_h=bh), "fit") for bw, bh in BLOCKS}


def suite_fit_stages(cfg):
    """Stage isolation for the fused fit step: clamp each march to 1 step to
    separate march, shadow and the reverse pass's shading."""
    from sdf3d_tpu_torch.ops import KernelConfig

    kc = KernelConfig()
    return {
        "fit_full": (cfg, kc, "fit"),
        "fit_march1": (_one_step(cfg, True, False), kc, "fit"),
        "fit_shadow1": (_one_step(cfg, False, True), kc, "fit"),
        "fit_march1_shadow1": (_one_step(cfg, True, True), kc, "fit"),
        "fwd_full": (cfg, kc, "fwd_scan"),
    }


SUITES = {"tiles": suite_tiles, "stages": suite_stages, "breakdown": suite_breakdown, "refcam": suite_refcam,
          "fit_tiles": suite_fit_tiles, "fit_stages": suite_fit_stages}


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.perf_lab", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("suites", nargs="*", default=["stages"], help=f"any of {', '.join(SUITES)}, or all")
    ap.add_argument("--cases", nargs="+", default=None, help="only these cases of the suites")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the lab runs on the card and no CUDA device is visible (--device cpu: plain versions)")
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=args.width, height=args.height)
    names = list(SUITES) if "all" in args.suites else args.suites
    unknown = [n for n in names if n not in SUITES]
    if unknown:
        ap.error(f"unknown suite {unknown[0]!r}; choose from {', '.join(SUITES)} or all")
    suites = {name: SUITES[name](cfg) for name in names}
    if args.cases:
        missing = set(args.cases) - {c for cases in suites.values() for c in cases}
        if missing:
            ap.error(f"no case {sorted(missing)} in the suites {names}")
        suites = {name: {c: v for c, v in cases.items() if c in args.cases} for name, cases in suites.items()}
    result = {"suites": {}, "device": device.type, "size": [args.width, args.height]}
    for name, cases in suites.items():
        if not cases:
            continue
        print(f"--- {name} ---", flush=True)
        best = run(cases, args.rounds, args.iters, device)
        result["suites"][name] = {case: {"ms": t * 1e3, "rays_per_s": args.width * args.height / t}
                                  for case, t in best.items()}
    result["launches"] = launch_counts()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
