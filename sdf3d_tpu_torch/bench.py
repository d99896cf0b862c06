"""Benchmark harness: rays/s for forward renders and fit steps (the port of
``sdf3d_tpu/bench.py``).

    python -m sdf3d_tpu_torch.bench          # the fwd_bwd cell at 1080p: one JSON line

The north star's target is 1e9 rays/s per card at 1080p fwd+bwd;
``vs_baseline`` reports the measured value against it.  The timing protocol
is the JAX package's: frames are pipelined K to a dispatch and the time per
frame is the two-point slope between K and 4K frames, the constant cost of a
window (the final synchronisation, the first launch) subtracted.

Unlike JAX's chunk, a ``lax.scan`` compiled into one program, the port's
chunk is a host loop of kernel launches: the slope keeps the host's work per
frame (uniform packing, library lookup, allocation, the float64 partial
sum), so a cell is the sustained rate of the port's own path, not of its
kernels alone (``chip_smoke.py`` prints the kernel's CUDA-event time beside
it).  Runs on the card by default; without one it raises, and the CPU runs
only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from sdf3d_tpu_torch.utils import profiling

def robust_min_seconds(
    fn,
    *args,
    iters: int = 10,
    min_windows: int = 8,
    max_windows: int = 30,
    agree_tol: float = 0.05,
    min_span_s: float = 4.0,
) -> float:
    """Amortized seconds per call: the min over many windows.

    Samples ``min_windows`` amortized windows (:func:`profiling.benchmark_fn`)
    spread over at least ``min_span_s`` of wall time, then keeps sampling (up
    to ``max_windows``) until the two best windows agree within
    ``agree_tol``: a minimum corroborated by a second window, not a fluke.
    The first window carries the warm-up."""
    times: list[float] = []
    t0 = time.perf_counter()
    times.append(profiling.benchmark_fn(fn, *args, warmup=2, iters=iters))
    while True:
        enough = len(times) >= min_windows and (time.perf_counter() - t0) >= min_span_s
        if enough:
            best = sorted(times)
            if best[1] <= best[0] * (1.0 + agree_tol):
                break
        if len(times) >= max_windows:
            break
        times.append(profiling.benchmark_fn(fn, *args, warmup=0, iters=iters))
        # Spread the windows so that consecutive ones do not all fall into
        # one slow period.
        time.sleep(0.05)
    return min(times)


def robust_slope_seconds_per_frame(
    make_fn,
    args,
    k_small: int,
    k_large: int,
    iters: int = 4,
    min_rounds: int = 8,
    max_rounds: int = 30,
    agree_tol: float = 0.05,
) -> float:
    """Per-frame seconds by two-point differencing: time a ``k_small``-frame
    and a ``k_large``-frame dispatch and divide the difference by the extra
    frames, which subtracts the window's constant cost.

    Both K are sampled interleaved in every round (a slow period hits both
    or neither), for at least ``min_rounds`` rounds, until the two best
    positive slopes agree within ``agree_tol`` or ``max_rounds`` is reached.
    Returns the second-best positive slope (the minimum is biased low: a
    round that pairs a slowed small window with a fast large one
    underestimates), the only one when there is one, and ``t_l / k_large``
    of the last round when no slope is positive."""
    fn_s, fn_l = make_fn(k_small), make_fn(k_large)
    slopes: list[float] = []
    t_s = profiling.benchmark_fn(fn_s, *args, warmup=2, iters=iters)
    t_l = profiling.benchmark_fn(fn_l, *args, warmup=2, iters=iters)
    slopes.append((t_l - t_s) / (k_large - k_small))
    while True:
        if len(slopes) >= min_rounds:
            best = sorted(s for s in slopes if s > 0)
            if len(best) >= 2 and best[1] <= best[0] * (1.0 + agree_tol):
                break
        if len(slopes) >= max_rounds:
            break
        t_s = profiling.benchmark_fn(fn_s, *args, warmup=0, iters=iters)
        t_l = profiling.benchmark_fn(fn_l, *args, warmup=0, iters=iters)
        slopes.append((t_l - t_s) / (k_large - k_small))
        time.sleep(0.05)
    positive = sorted(s for s in slopes if s > 0)
    if not positive:
        return t_l / k_large
    if len(positive) == 1:
        return positive[0]
    return positive[1]


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the benchmark runs on the card and no CUDA device is visible "
                           "(device='cpu' runs the kernels' plain versions)")
    return device


def _scene(name: str):
    import sdf3d_tpu_torch as tt

    scenes = {"reference": tt.reference_scene, "sphere": tt.sphere_scene, "flagship": tt.flagship_scene,
              "fractal": tt.fractal_scene}
    if name not in scenes:
        raise ValueError(f"scene_name must be one of {sorted(scenes)}, not {name!r}")
    return scenes[name]()


def make_workload(width: int = 1920, height: int = 1080, engine: str = "kernel", scene_name: str = "reference",
                  mode: str = "fwd_bwd", profile: str = "parity", kc_overrides: dict | None = None,
                  device="cuda"):
    """``(make_fn, args)`` of a benchmark cell: ``make_fn(k)(*args)`` runs a
    K-frame chunk and returns its K per-frame values on the device.

    - ``fwd``: a turntable of K golden-angle cameras (camera i is the same
      pose at every K, so a K-frame chunk is a prefix of the 4K one), the
      cameras made outside the timed window; each frame the mean of the
      rendered image (``render_kernel_forward`` for ``engine="kernel"``,
      ``render`` for ``"torch"``).
    - ``fwd_bwd``: a K-step fit chunk on the fused fit step
      (``fit_step_kernel``, ``wrt_uniforms=False``) against a zero target,
      each step ``prm − 1e-30·g_prm`` on the device: the steps depend on one
      another without moving the scene; the values are the K losses.
      Nothing in a chunk reads a value back to the host.
    """
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops.fit_kernel import _uniforms, fit_step_kernel
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    if engine not in ("kernel", "torch"):
        raise ValueError(f"engine must be 'kernel' or 'torch', not {engine!r}")
    if mode not in ("fwd", "fwd_bwd"):
        raise ValueError(f"mode must be 'fwd' or 'fwd_bwd', not {mode!r}")
    if profile not in ("parity", "fast"):
        raise ValueError(f"profile must be 'parity' or 'fast', not {profile!r}")
    device = _device(device)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=width, height=height)
    if profile == "fast":
        cfg = tt.fast_config(cfg)
    scene = _scene(scene_name).to(device)
    cam = tt.Camera.reference(device=device)
    light, mat = tt.reference_light(device=device), tt.reference_material(device=device)
    kc = KernelConfig(**(kc_overrides or {}))

    if mode == "fwd":
        if engine == "kernel":
            def one(c):
                return render_kernel_forward(scene, c, light, mat, cfg, kc, device=device)[0].mean()
        else:
            def one(c):
                return tt.render(scene, c, light, mat, cfg).mean()

        def make_fn(k):
            cams = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0, device=device) for i in range(k)]
            return lambda _scene: torch.stack([one(c) for c in cams])

        return make_fn, (scene,)

    if engine == "torch":
        raise NotImplementedError("the torch engine's fit step renders through diff.py, which is not ported yet "
                                  "(ROADMAP item 5)")
    uni = _uniforms(cam, light, mat, cfg, device)
    target = torch.zeros((3, height, width), dtype=torch.float32, device=device)

    def make_fn(k):
        def chunk(prm):
            losses = []
            for _ in range(k):
                loss, g_prm, _ = fit_step_kernel(scene, prm, uni, target, cfg, kc, wrt_uniforms=False)
                prm = prm - 1e-30 * g_prm
                losses.append(loss)
            return torch.stack(losses)
        return chunk

    return make_fn, (scene_param_vector(scene, device),)


def run_benchmark(
    width: int = 1920,
    height: int = 1080,
    engine: str = "kernel",
    scene_name: str = "reference",
    mode: str = "fwd_bwd",
    iters: int = 10,
    frames_per_dispatch: int = 16,
    profile: str = "parity",
    kc_overrides: dict | None = None,
    device="cuda",
) -> dict:
    """Time one cell (:func:`make_workload`) and return the one-line JSON
    payload: ``metric`` (``rays_per_second_{H}p_{mode}_{engine}``),
    ``value`` (rays/s), ``unit``, ``vs_baseline`` (against 1e9),
    ``seconds_per_frame`` and ``backend`` (the device type the cell ran on).

    ``engine``: ``"kernel"`` (the CUDA kernels; JAX's ``"pallas"``) or
    ``"torch"`` (the plain path; JAX's ``"xla"``).  ``kc_overrides``:
    ``KernelConfig`` fields.  With ``frames_per_dispatch`` K ≥ 4 the time
    per frame is the slope between K and 4K frames
    (:func:`robust_slope_seconds_per_frame`), else the best amortized
    window over K (:func:`robust_min_seconds`)."""
    make_fn, args = make_workload(width, height, engine, scene_name, mode, profile, kc_overrides, device)
    K = max(1, frames_per_dispatch)
    if K >= 4:
        seconds = robust_slope_seconds_per_frame(make_fn, args, k_small=K, k_large=4 * K, iters=max(1, iters // 2))
    else:
        seconds = robust_min_seconds(make_fn(K), *args, iters=max(1, iters // 4)) / K
    rays_s = profiling.rays_per_second(width, height, seconds)
    return {
        "metric": f"rays_per_second_{height}p_{mode}_{engine}",
        "value": rays_s,
        "unit": "rays/s",
        "vs_baseline": rays_s / 1e9,
        "seconds_per_frame": seconds,
        "backend": _device(device).type,
    }


def run_extras(budget_s: float = 900.0, on_update=None, device="cuda") -> dict:
    """Secondary cells beside the headline, with a reduced protocol
    (``iters=4``, ``frames_per_dispatch=8``): ``fwd_4k``, ``fit_4k``,
    ``fit_fast_1080p``, ``fit_fractal_1080p`` and ``fit_multiview_720p_v4``.

    Each entry holds either ``rays_per_second`` and ``seconds_per_frame``,
    or an error string: ``"error: NotImplementedError: ..."`` for a path not
    ported yet (the multiview fit, ROADMAP item 12), ``"skipped: ..."`` once
    the budget is spent.  Any other failure
    raises.  ``on_update(partial_dict)`` is called after every entry."""
    from sdf3d_tpu_torch.fit import fit_scene_multiview

    out: dict = {}
    deadline = time.monotonic() + budget_s

    def _run(name, fn):
        if time.monotonic() > deadline - 60:
            out[name] = "skipped: extras budget exhausted"
        else:
            try:
                out[name] = fn()
            except NotImplementedError as e:
                out[name] = f"error: NotImplementedError: {e}"
        if on_update is not None:
            on_update(dict(out))

    def _via(mode, **kw):
        r = run_benchmark(engine="kernel", mode=mode, iters=4, frames_per_dispatch=8, device=device, **kw)
        return {"rays_per_second": r["value"], "seconds_per_frame": r["seconds_per_frame"]}

    _run("fwd_4k", lambda: _via("fwd", width=3840, height=2160))
    _run("fit_4k", lambda: _via("fwd_bwd", width=3840, height=2160))
    _run("fit_fast_1080p", lambda: _via("fwd_bwd", profile="fast"))
    _run("fit_fractal_1080p", lambda: _via("fwd_bwd", scene_name="fractal"))
    # The V = 4 multiview fit step at 720p: fit_scene_multiview raises, its
    # fit-kernel variant is not ported (ROADMAP item 12).
    _run("fit_multiview_720p_v4", fit_scene_multiview)
    return out


if __name__ == "__main__":
    import sys

    from sdf3d_tpu_torch import cli

    sys.exit(cli.main(["bench", *sys.argv[1:]]))
