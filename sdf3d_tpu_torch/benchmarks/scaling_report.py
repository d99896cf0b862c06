"""Scaling-efficiency projection from measured per-ray march work (the port
of ``benchmarks/scaling_report.py``).

Scaling over several cards cannot be measured on one card, but its
dominant term can: with no communication in the forward and one all-reduce
a fit step, scaling efficiency is load balance times a small communication
factor.  This tool measures the per-ray march step counts (primary +
shadow, the loops that dominate the work) on real scenes and projects
``total_work / (n · max_device_work)`` for every layout the port ships:

- **contiguous** row slabs: rank d gets rows [d·H/n, (d+1)·H/n);
- **interleaved** tile_h-row blocks strided by n;
- **tiles_rr**: the tile queue (``parallel/tile_queue.py``) with the
  round-robin policy;
- **tiles_balanced**: the tile queue planned by greedy LPT on the
  1/8-resolution march pre-pass (``estimate_tile_work``, what a fit runs),
  evaluated against the exact work, so the number holds the estimator's
  error too.

Each record also carries the gradient all-reduce's communication model:
``eff_with_comm = eff · t_step/(t_step + t_comm)``, t_comm from the ring's
message count ((n−1) hops a stream) at ``hop_latency_s`` a hop plus the
wire bytes at ``link_bytes_per_s``, against ``t_step``, the time of one
``fit_scene`` step (the fit demo) measured by this lab on this run's device
(or given with ``--step-ms`` and ``--step-card``).  The defaults of the two
link figures are the card's, named in each record's ``basis``:
:data:`HOP_LATENCY_S` is the port's own K7 call between two ranks of a
ring in one process (a flag round trip), and :data:`LINK_BYTES_PER_S`
NVLink 4's rate to one peer on the H100 SXM.  The gradient is the port's
all-reduced vector, ``[loss, g_prm]`` in float64.  None of the JAX lab's
TPU figures (its ICI hop and link rate, its step time) is used.

Writes one JSON line per (scene, layout, n) to stdout, and to ``--out``
only when given (the repository's ``SCALING.jsonl`` holds the JAX package's
TPU records and is not this tool's):

    python -m sdf3d_tpu_torch.benchmarks.scaling_report [--width 1920 --height 1080] [--device cuda|cpu]
        [--step-ms MS --step-card NAME] [--hop-us US] [--link-gbs GB/S] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

#: One hop of the ring: K7's call at N = 2, 9 float64 values, both ranks in
#: one process (``LocalRing``, a host thread a rank), 0.0386 ms on an
#: NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 25; PERF.md §6, K7's row).
HOP_LATENCY_S = 3.86e-5
#: NVLink 4 from one H100 SXM to one peer through the NVSwitch: 18 links of
#: 25 GB/s each way (NVIDIA's H100 data sheet: 900 GB/s both ways).
LINK_BYTES_PER_S = 450e9
HOP_SOURCE = "K7 at N=2 in one process, 0.0386 ms on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 25)"
LINK_SOURCE = "NVLink 4 to one peer, H100 SXM (NVIDIA data sheet)"
SCENES = ("reference", "flagship", "fractal")


def march_step_counts(scene, origins, directions, mc, shadow_cfg=None, light=None) -> torch.Tensor:
    """Per-ray primary march step count (+ shadow steps when configured):
    the primary counter is ``march.march_step_map`` (which also drives the
    tile queue's balanced plans); the shadow term marches from the hit
    toward the light as JAX's does, for every hit ray (the lit-side gate
    left out: hit or miss dominates)."""
    from sdf3d_tpu_torch.march import march_step_map
    from sdf3d_tpu_torch.sdf.node import vlength

    with torch.no_grad():
        dist, steps = march_step_map(scene.distance, origins, directions, mc)
        if shadow_cfg is None or not shadow_cfg.enabled:
            return steps
        hit = dist <= mc.max_distance
        p = origins + dist[..., None] * directions
        ldir = light.position - p
        ldir = ldir / torch.clamp(vlength(ldir)[..., None], min=1e-9)
        so = p + 2.0 * mc.epsilon * ldir  # origin offset along the light direction, about 2ε
        d = torch.zeros_like(dist)
        ssteps = torch.zeros_like(dist)
        active = hit.to(dist.dtype)
        for _ in range(shadow_cfg.max_steps):
            if not bool(active.any()):
                break  # the rest of JAX's fixed-count loop changes nothing
            sv = scene.distance(so + d[..., None] * ldir)
            ssteps = ssteps + active
            d_new = torch.where(active > 0, d + sv, d)
            done = (d_new > mc.max_distance) | (sv < mc.epsilon)
            d = d_new
            active = active * (1.0 - done.to(dist.dtype))
        return steps + ssteps


def project(work_rows, n, tile_h, interleaved):
    """Projected efficiency total/(n·max) for a row layout of per-row work
    (JAX's, copied)."""
    H = work_rows.shape[0]
    if interleaved:
        blocks = H // (n * tile_h)
        v = work_rows[: blocks * n * tile_h].reshape(blocks, n, tile_h)
        per_dev = v.sum(axis=(0, 2))
    else:
        slab = H // n
        per_dev = work_rows[: slab * n].reshape(n, slab).sum(axis=1)
    return float(per_dev.sum() / (n * per_dev.max()))


def project_tiles(exact_tile_work, n, plan):
    """Projected efficiency of a TilePlan evaluated on the exact per-tile
    work (the plan itself may have been built from an estimate; JAX's,
    copied)."""
    th, tw = plan.tile_h, plan.tile_w
    loads = np.zeros(n)
    for d in range(n):
        for t in range(plan.tiles_per_device):
            r, c = float(plan.rows[d, t]), float(plan.cols[d, t])
            if r >= plan.height:
                continue  # dummy tile
            loads[d] += exact_tile_work[int(r) // th, int(c) // tw]
    return float(loads.sum() / (n * loads.max()))


def comm_factor(n, grad_bytes, step_seconds, hop_latency_s=HOP_LATENCY_S, link_bw=LINK_BYTES_PER_S):
    """t_step/(t_step+t_comm) for the per-step gradient ring all-reduce.

    Ring model (``parallel/collectives.py``): n−1 hops a stream, each a
    message of grad_bytes/2 — latency (n−1)·hop_latency (the streams
    overlap), wire (n−1)/2·grad_bytes/link_bw.  Conservative: no overlap of
    compute and communication.  The step time has no default: it is
    measured (:func:`measure_step_seconds`) or given."""
    if n == 1:
        return 1.0
    t_comm = (n - 1) * hop_latency_s + (n - 1) * grad_bytes / 2 / link_bw
    return step_seconds / (step_seconds + t_comm)


def measure_step_seconds(width: int, height: int, device="cuda", steps: int = 10) -> float:
    """Seconds a step of ``fit_scene`` on the fit demo (the CLI's ``fit``:
    the reference scene's render as target, the sphere moved, the plane
    frozen) at ``width`` × ``height`` on ``device``: the host clock between
    the logged ends of steps 1 and ``steps`` (each step a chunk of its own,
    its loss read back), the first step's set-up left out."""
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward

    dev = torch.device(device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=width, height=height)
    cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
    target = render_kernel_forward(tt.reference_scene(), cam, light, mat, cfg, device=dev)[0]
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))

    times = []

    class Clock:
        def log(self, **fields):
            times.append(time.perf_counter())

    fit_scene(target, scene0, cam, light, mat, cfg, FitConfig(steps=steps + 1, log_every=1), logger=Clock(),
              trainable=(False, False, True, True), device=dev)
    return (times[-1] - times[1]) / (steps - 1)


def layout_records(scene_name: str, steps: np.ndarray, est: np.ndarray, width: int, height: int, grad_bytes: int,
                   step_seconds: float, basis: str, tile_hs=(24, 8), queue_tile=(8, 128), sizes=(2, 4, 8, 16, 32),
                   hop_latency_s=HOP_LATENCY_S, link_bw=LINK_BYTES_PER_S) -> list:
    """The records of one scene from its exact (H, W) step counts ``steps``
    and the balanced planner's estimate ``est`` (any resolution): for each
    n, contiguous, interleaved at each of ``tile_hs``, and the tile queue
    over ``queue_tile`` tiles round-robin and balanced (JAX's records)."""
    from sdf3d_tpu_torch.parallel.tile_queue import plan_tiles, pool_work_to_tiles

    TH, TW = queue_tile
    work_rows = steps.sum(axis=1)
    exact_tiles = pool_work_to_tiles(steps.astype(np.float64), height, width, TH, TW)
    est_tiles = pool_work_to_tiles(est, height, width, TH, TW)
    lines = []
    for n in sizes:
        cf = comm_factor(n, grad_bytes, step_seconds, hop_latency_s, link_bw)

        def emit(layout, th, eff):
            lines.append({
                "metric": "projected_scaling_efficiency",
                "scene": scene_name,
                "resolution": f"{width}x{height}",
                "n_devices": n,
                "layout": layout,
                "tile_h": th,
                "value": round(eff, 4),
                "comm_factor": round(cf, 4),
                "value_with_comm": round(eff * cf, 4),
                "basis": basis,
            })

        emit("contiguous", 0, project(work_rows, n, tile_hs[0], False))
        for th in tile_hs:
            # Truncated to the largest n*tile_h-divisible row prefix (a
            # projection; an interleaved run needs exact divisibility).
            emit("interleaved", th, project(work_rows, n, th, True))
        emit("tiles_rr", TH, project_tiles(exact_tiles, n, plan_tiles(height, width, TH, TW, n, "round_robin")))
        emit("tiles_balanced", TH, project_tiles(exact_tiles, n,
                                                 plan_tiles(height, width, TH, TW, n, "balanced", est_tiles)))
    return lines


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.camera import camera_rays
    from sdf3d_tpu_torch.ops import KernelConfig
    from sdf3d_tpu_torch.ops.scene_program import count_params
    from sdf3d_tpu_torch.parallel.tile_queue import estimate_tile_work

    kc = KernelConfig()
    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.scaling_report", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile-h", type=int, default=0,
                    help=f"interleave block height; 0 = both {kc.tile_h} (the kernels' tile) and 8 (finer mixing)")
    ap.add_argument("--queue-tile", type=int, nargs=2, default=(kc.tile_h, kc.tile_w), metavar=("TH", "TW"),
                    help="the tile queue's tile (default the kernels' tile)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="the fit step's ms, with --step-card (default: measured here on --device)")
    ap.add_argument("--step-card", default=None, help="the device the given --step-ms was measured on")
    ap.add_argument("--hop-us", type=float, default=HOP_LATENCY_S * 1e6)
    ap.add_argument("--link-gbs", type=float, default=LINK_BYTES_PER_S / 1e9)
    ap.add_argument("--out", default=None, help="also write the records here (JSONL, rewritten whole)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the lab runs on the card and no CUDA device is visible (--device cpu)")
    if (args.step_ms is None) != (args.step_card is None):
        ap.error("--step-ms and --step-card go together")
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if args.step_ms is None:
        step_s = measure_step_seconds(args.width, args.height, dev)
        step_src = f"fit_scene (the fit demo) measured by this run on {card}"
    else:
        step_s = args.step_ms / 1e3
        step_src = f"fit_scene (the fit demo) measured on {args.step_card} (--step-ms)"
    hop_s, link = args.hop_us * 1e-6, args.link_gbs * 1e9
    hop_src = HOP_SOURCE if args.hop_us == ap.get_default("hop_us") else "--hop-us"
    link_src = LINK_SOURCE if args.link_gbs == ap.get_default("link_gbs") else "--link-gbs"
    basis = (f"march+shadow step counts on {card}; eff = total_work/(n*max_device_work); comm = (n-1)-hop ring "
             f"model: hop {args.hop_us:g} us ({hop_src}), link {args.link_gbs:g} GB/s ({link_src}), "
             f"step {step_s * 1e3:.4g} ms ({step_src})")

    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=args.width, height=args.height)
    cam, light = tt.Camera.reference(device=dev), tt.reference_light(device=dev)
    o, d = camera_rays(cam, cfg.width, cfg.height, cfg.ray_mode)
    scenes = {"reference": tt.reference_scene, "flagship": tt.flagship_scene, "fractal": tt.fractal_scene}
    tile_hs = (args.tile_h,) if args.tile_h else (kc.tile_h, 8)
    lines = []
    for name in SCENES:
        scene = scenes[name]().to(dev)
        steps = march_step_counts(scene, o, d, cfg.march, cfg.shadow, light).cpu().numpy()
        est = estimate_tile_work(scene, cam, cfg, light, scale=8)
        grad_bytes = 8 * (count_params(scene) + 1)
        lines += layout_records(name, steps, est, args.width, args.height, grad_bytes, step_s, basis, tile_hs,
                                tuple(args.queue_tile), hop_latency_s=hop_s, link_bw=link)
    text = "".join(json.dumps(line) + "\n" for line in lines)
    print(text, end="", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
