#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sdf3d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's forward render through the entry points a user calls, at
1920×1080 on the reference scene, with the CUDA render kernel built from the
sources in this checkout.  Phases, one line each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the reference scene's kernel library is built once; a second frame
   with another sphere radius reuses it (parameters are run-time inputs);
3. kernel vs its plain PyTorch version on the card at 256×192, two cameras,
   ray form and point form, all four output planes, within the pixel budget
   of ``sdf3d_tpu_torch/utils/parity.py``;
4. main path: ``render_batch(engine="kernel")`` over 4 golden-angle orbit
   cameras (one launch each), output checks, frame 0 against the plain
   version at 1080p;
5. CLI: ``python -m sdf3d_tpu_torch.cli render`` at 1080p writes a PNG;
6. times at 1080p with CUDA events (3 warm-up frames, 20 timed; plain,
   kernel, kernel, plain).

Then the training path, ``fit_scene`` on the reference scene at 1920×1080
(the JAX CLI's fit demo: a perturbed sphere, the plane frozen, Adam):

7. build: the fit step (K3) and render backward (K5) libraries, with the
   ``ptxas`` registers and spills of all three kernels;
8. fit step vs its plain version at 256×192 (two cameras, ``wrt_uniforms``
   and ``frozen_slots`` both ways) and at a ragged 250×190;
9. render backward vs its plain version at 256×192 (same planes, a seeded
   cotangent);
10. main path: ``fit_scene`` for 20 Adam steps launches the fit step once a
    step and nothing else; ``fit_scene(loss="multiscale")`` for 5 steps
    launches the forward and backward kernels once a step each; step 0 of
    the fit step against its plain version at 1080p;
11. CLI: ``python -m sdf3d_tpu_torch.cli fit`` at 1080p writes a metrics file;
12. times at 1080p (fit step, render backward, each beside its plain
    version; ``fit_scene`` ms/step and fwd_bwd rays/s).

Gradient comparisons use the bars of ``utils/parity.py::check_grads`` with
the cotangent (or residual) zero on grazing rays (``conditioned``): 1e-5 of
the gradient mass where both sides differentiate the same primal planes,
1e-3 where the plain version marches its own.

Then one JSON line describing the kernels, and last the JSON result line.
Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, sort_keys=True), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def project(cam, point, width, height):
    """Pixel (row, col) of a world point under the reference ray mode."""
    import numpy as np

    v = cam.c2w.cpu().numpy().T @ (np.asarray(point) - cam.position.cpu().numpy())
    fz = 2.0 / np.tan(np.radians(float(cam.fov_deg)) / 2.0)
    qx = v[0] / -v[2] * fz / (width / height)
    qy = v[1] / -v[2] * fz
    return int(round((1.0 - qy) / 2.0 * height - 0.5)), int(round((qx + 1.0) / 2.0 * width - 0.5))


def time_ms(torch, fn, warmup=3, frames=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    card = card_name_and_power()
    log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    print(card, flush=True)

    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch import cli
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import check_planes

    dev = torch.device("cuda", 0)
    light, mat = tt.reference_light(), tt.reference_material()
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    scene = tt.reference_scene()

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    # ---- 2. build, and no rebuild on a parameter change ----
    libs, launches0 = _build.LIBRARIES, render_kernel_forward.launches
    t0 = time.perf_counter()
    a = render_kernel_forward(scene, tt.Camera.reference(), light, mat, cfg, device=dev)[0]
    torch.cuda.synchronize()
    first_frame_s = time.perf_counter() - t0
    bigger = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.0, 0.4, 0.0), 0.25))
    b = render_kernel_forward(bigger, tt.Camera.reference(), light, mat, cfg, device=dev)[0]
    torch.cuda.synchronize()
    check(libs.loaded == 1 and libs.builds <= 1,
          f"expected one library, got {libs.loaded} loaded and {libs.builds} built")
    check(render_kernel_forward.launches - launches0 == 2, "expected two launches")
    check(bool((a != b).any()), "changing the sphere radius did not change the image")
    key = libs.key(cuda_scene_source(scene, cfg, KernelConfig()))
    ptxas = [ln.strip() for ln in libs.log(key).splitlines() if "registers" in ln or "spill" in ln]
    log("build", builds=libs.builds, libraries=libs.loaded, build_seconds=libs.build_seconds,
        first_frame_seconds=first_frame_s, launches=render_kernel_forward.launches - launches0, ptxas=ptxas)

    # ---- 3. kernel vs plain at 256x192 ----
    small = dataclasses.replace(cfg, width=256, height=192)
    for cam_name, cam in (("reference", tt.Camera.reference()),
                          ("orbit30_15", tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0))):
        for ray_sdf in (True, False):
            kc = KernelConfig(ray_sdf=ray_sdf)
            prm, uni = inputs(scene, cam, small)
            got = render_kernel_launch(scene, prm, uni, small, kc)
            want = render_kernel_forward_plain(scene, prm, uni, small, kc)
            torch.cuda.synchronize()
            stats = check_planes(got, want, small.march.max_distance, f"{cam_name} ray_sdf={ray_sdf}")
            log("parity_256x192", camera=cam_name, ray_sdf=ray_sdf,
                **{n: {k: st[k] for k in ("over_atol", "max_abs_err")} for n, st in stats.items()})
    check(libs.loaded == 2, f"expected two libraries (ray and point form), got {libs.loaded}")

    # ---- 4. main path: render_batch over 4 orbit cameras ----
    cams = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0) for i in range(4)]
    render_kernel_forward.launches = 0
    frames = tt.render_batch(scene, cams, light, mat, cfg, engine="kernel")
    torch.cuda.synchronize()
    batch_launches = render_kernel_forward.launches
    check(batch_launches == 4, f"render_batch launched {batch_launches} kernels for 4 frames")
    check(tuple(frames.shape) == (4, H, W, 3) and frames.device.type == "cuda", f"bad frames {frames.shape}")
    check(bool(torch.isfinite(frames).all()), "non-finite pixels in the main path")

    # ---- 5. CLI through the kernel ----
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render.png")
        check(cli.main(["render", "--width", str(W), "--height", str(H), "--out", png]) == 0, "cli failed")
        with open(png, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == W.to_bytes(4, "big") + H.to_bytes(4, "big"),
              "the CLI did not write a 1920x1080 PNG")
        png_bytes = os.path.getsize(png)
    main_launches = render_kernel_forward.launches
    check(main_launches == 5, f"main path launched {main_launches} kernels, expected 5")

    # Output checks on frame 0 (outside the counted window).
    prm0, uni0 = inputs(scene, cams[0], cfg)
    k_rgb, k_t, k_sh, k_ao = render_kernel_launch(scene, prm0, uni0, cfg)
    torch.testing.assert_close(k_rgb.permute(1, 2, 0), frames[0], rtol=0, atol=0)
    row, col = project(cams[0], (0.0, 0.4, 0.0), W, H)
    ambient = torch.tensor([0.0, 0.02, 0.08], device=dev)
    centre = frames[0, row, col]
    check(1.7 < float(k_t[row, col]) < 1.9, f"sphere centre pixel t={float(k_t[row, col])}, expected about 1.81")
    check(bool((centre - ambient > 1e-3).all()), f"sphere centre pixel {centre.tolist()} is not lit")
    sky = frames[0, 0, 0]
    check(float(k_t[0, 0]) > cfg.march.max_distance, "top-left pixel is not a miss")
    torch.testing.assert_close(sky, ambient, rtol=0, atol=1e-6)
    p_rgb, p_t, p_sh, p_ao = render_kernel_forward_plain(scene, prm0, uni0, cfg)
    parity = check_planes((k_rgb, k_t, k_sh, k_ao), (p_rgb, p_t, p_sh, p_ao), cfg.march.max_distance,
                          "1080p frame 0")
    log("main_path", frames=list(frames.shape), launches=main_launches, render_batch_launches=batch_launches,
        cli_png_bytes=png_bytes, sphere_centre_px=[row, col], sphere_centre_rgb=centre.tolist(),
        sky_rgb=sky.tolist(), parity_1080p={n: {k: st[k] for k in ("over_atol", "max_abs_err")}
                                            for n, st in parity.items()})

    # ---- 6. times at 1080p (plain, kernel, kernel, plain) ----
    prm, uni = inputs(scene, tt.Camera.reference(), cfg)
    kern = lambda: render_kernel_launch(scene, prm, uni, cfg)  # noqa: E731
    plain = lambda: render_kernel_forward_plain(scene, prm, uni, cfg)  # noqa: E731
    wrapper = lambda: render_kernel_forward(scene, tt.Camera.reference(), light, mat, cfg, device=dev)  # noqa: E731
    p1 = time_ms(torch, plain)
    k1 = time_ms(torch, kern)
    k2 = time_ms(torch, kern)
    p2 = time_ms(torch, plain)
    w1 = time_ms(torch, wrapper)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log("times_1080p", card=card, kernel_ms=kernel_ms, kernel_ms_runs=[k1, k2],
        kernel_rays_per_s=W * H / (kernel_ms / 1e3), wrapper_ms=w1, plain_ms=plain_ms, plain_ms_runs=[p1, p2],
        plain_rays_per_s=W * H / (plain_ms / 1e3), build_seconds=libs.build_seconds)

    fit_kernels = fit_phases(torch, tt, card, dev)
    print(json.dumps({"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "sdf3d_tpu_torch/ops/csrc/render_kernel.cu",
        "replaces": "sdf3d_tpu/ops/render_kernel.py:614",
        "launches": main_launches,
        "max_abs_err": parity["rgb"]["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }] + fit_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes per kernel from an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = next((k for k in ("render_fwd", "fit_step", "render_bwd") if k in m.group(1)), m.group(1))
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


class PlainCalls:
    """Counts calls of the kernels' plain versions while active (wrapping
    every module-level reference to them in the package)."""

    NAMES = ("render_kernel_forward_plain", "fit_step_kernel_plain", "render_kernel_backward_plain")

    def __enter__(self):
        self.calls, self._saved = {n: 0 for n in self.NAMES}, []
        for mod in [m for k, m in sys.modules.items() if k.startswith("sdf3d_tpu_torch")]:
            for n in self.NAMES:
                fn = getattr(mod, n, None)
                if fn is not None:
                    self._saved.append((mod, n, fn))
                    setattr(mod, n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for mod, n, fn in self._saved:
            setattr(mod, n, fn)
        return False


def fit_phases(torch, tt, card: str, dev) -> list:
    """Phases 7-12: the training path.  Returns the fit step's and the
    render backward's entries of the kernels line."""
    from sdf3d_tpu_torch import cli
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel, fit_step_kernel_launch, fit_step_kernel_plain
    from sdf3d_tpu_torch.ops.render_bwd_kernel import (
        render_kernel_backward,
        render_kernel_backward_launch,
        render_kernel_backward_plain,
    )
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_launch,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import check_grads, conditioned, gradient_mass

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    frozen = (0, 1, 2, 3)  # the plane of the fit demo
    trainable = (False, False, True, True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)

    def scene0():
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def k3_vs_plain(sc, cam, c, wrt_uniforms, frozen_slots, label, target=None, same_tol=1e-5):
        """The fit step against (1) the plain reverse pass on the kernel's own
        primal planes (K1's: the same arithmetic), at the K5 bar, and (2) the
        plain version, which marches its own primal: a ray that ends a step
        apart moves its pixel's term, so the bar is looser.  With no target,
        the kernel render plus seeded noise, none on grazing rays; a given
        target keeps its grazing rays, hence ``same_tol``."""
        prm, uni = inputs(sc, cam, c)
        rgb, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
        if target is None:
            keep = conditioned(sc, prm, uni, t, c)
            noise = torch.rand((3, c.height, c.width), generator=gen, device=dev) * 0.2 - 0.1
            target = (rgb + noise * keep).contiguous()
        got = fit_step_kernel_launch(sc, prm, uni, target, c, KernelConfig(), wrt_uniforms, frozen_slots)
        want = fit_step_kernel_plain(sc, prm, uni, target, c, KernelConfig(), wrt_uniforms, frozen_slots)
        g_p, g_u = render_kernel_backward_plain(sc, prm, uni, 2.0 * (rgb - target), t, sh, ao, c)
        g_p[list(frozen_slots)] = 0.0
        same = torch.cat([g_p, g_u if wrt_uniforms else torch.zeros_like(g_u)])
        torch.cuda.synchronize()
        mass = gradient_mass(sc, prm, uni, 2.0 * (rgb - target), t, sh, ao, c)
        loss_rel = abs(float(got[0]) / float(want[0]) - 1.0)
        check(loss_rel <= 1e-5, f"{label}: loss off by {loss_rel:.3g} relative")
        check(all(float(got[1][k]) == 0.0 for k in frozen_slots), f"{label}: a frozen slot's gradient is not 0")
        check(wrt_uniforms or float(got[2].abs().max()) == 0.0, f"{label}: uniform gradients without wrt_uniforms")
        g = torch.cat(got[1:])
        return {"loss_rel_err": loss_rel,
                "same_planes": check_grads(g, same, mass, rtol=1e-4, mass_tol=same_tol, label=f"{label} (same planes)"),
                "own_march": check_grads(g, torch.cat(want[1:]), mass, rtol=1e-4, mass_tol=1e-3, label=label)}

    # ---- 7. build: the fit step and backward libraries ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    sc = scene0()
    prm, uni = inputs(sc, tt.Camera.reference(device=dev), cfg)
    small = dataclasses.replace(cfg, width=256, height=192)
    target = torch.zeros((3, 192, 256), device=dev)
    fit_step_kernel_launch(sc, prm, uni, target, small, KernelConfig(), False, frozen)
    render_kernel_backward_launch(sc, prm, uni, target, target[0], target[1], target[2], small)
    torch.cuda.synchronize()
    ptxas = {}
    for wrt, fr in ((False, frozen), (True, ())):
        key = libs.key(cuda_scene_source(sc, cfg, KernelConfig(), wrt, fr))
        ptxas[f"wrt_uniforms={wrt} frozen={list(fr)}"] = ptxas_summary(libs.log(key))
    log("build_fit", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        libraries=libs.loaded, ptxas=ptxas)
    for kernels in ptxas.values():
        check(set(kernels) >= {"render_fwd", "fit_step", "render_bwd"}, f"ptxas reported {sorted(kernels)}")

    # ---- 8. fit step vs plain at 256x192, and ragged 250x190 ----
    cams = (("reference", tt.Camera.reference(device=dev)),
            ("orbit30_15", tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)))
    for (cam_name, cam), wrt, fr in itertools.product(cams, (False, True), ((), frozen)):
        st = k3_vs_plain(sc, cam, small, wrt, fr, f"fit step {cam_name} wrt_uniforms={wrt} frozen={fr}")
        log("fit_step_256x192", camera=cam_name, wrt_uniforms=wrt, frozen=list(fr), **st)
    ragged = dataclasses.replace(cfg, width=250, height=190)
    for cam_name, cam in cams:
        st = k3_vs_plain(sc, cam, ragged, True, frozen, f"fit step 250x190 {cam_name}")
        log("fit_step_250x190", camera=cam_name, **st)

    # ---- 9. render backward vs plain at 256x192, and ragged 250x190 ----
    for c, (cam_name, cam) in ((small, cams[0]), (small, cams[1]), (ragged, cams[1])):
        prm, uni = inputs(sc, cam, c)
        _, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
        keep = conditioned(sc, prm, uni, t, c)
        g_rgb = (torch.randn((3, c.height, c.width), generator=gen, device=dev) * keep).contiguous()
        got = render_kernel_backward_launch(sc, prm, uni, g_rgb, t, sh, ao, c)
        want = render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, c)
        torch.cuda.synchronize()
        st = check_grads(torch.cat(got), torch.cat(want), gradient_mass(sc, prm, uni, g_rgb, t, sh, ao, c),
                         rtol=1e-4, mass_tol=1e-5, label=f"render backward {c.width}x{c.height} {cam_name}")
        log(f"render_bwd_{c.width}x{c.height}", camera=cam_name, **st)

    # ---- 10. main path: fit_scene at 1920x1080 ----
    cam = tt.Camera.reference(device=dev)
    target = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, device=dev)[0]
    with PlainCalls() as plain:
        render_kernel_forward.launches = fit_step_kernel.launches = render_kernel_backward.launches = 0
        t0 = time.perf_counter()
        l2 = fit_scene(target, scene0(), cam, light, mat, cfg, FitConfig(steps=20, learning_rate=1e-2, log_every=1),
                       trainable=trainable, device=dev)
        l2_seconds = time.perf_counter() - t0
        l2_counts = (fit_step_kernel.launches, render_kernel_forward.launches, render_kernel_backward.launches)
        render_kernel_forward.launches = fit_step_kernel.launches = render_kernel_backward.launches = 0
        t0 = time.perf_counter()
        ms = fit_scene(target, scene0(), cam, light, mat, cfg,
                       FitConfig(steps=5, learning_rate=1e-2, log_every=1, loss="multiscale"),
                       trainable=trainable, device=dev)
        ms_counts = (fit_step_kernel.launches, render_kernel_forward.launches, render_kernel_backward.launches)
        ms_seconds = time.perf_counter() - t0
    check(l2_counts == (20, 0, 0), f"fit_scene launched (fit step, forward, backward) = {l2_counts}, expected (20, 0, 0)")
    check(ms_counts == (0, 5, 5), f"multiscale fit launched (fit step, forward, backward) = {ms_counts}, expected (0, 5, 5)")
    check(sum(plain.calls.values()) == 0, f"the main path called plain versions: {plain.calls}")
    for name, res in (("l2", l2), ("multiscale", ms)):
        check(all(math.isfinite(v) for v in res.losses), f"{name} fit: non-finite loss")
        check(res.losses[-1] < res.losses[0], f"{name} fit: the loss did not fall ({res.losses[0]} -> {res.losses[-1]})")
    # Step 0 of the fit step against its plain version at 1080p (the real
    # target, grazing rays included).
    fit_st = k3_vs_plain(scene0(), cam, cfg, False, frozen, "fit step 1080p step 0",
                         target.permute(2, 0, 1).contiguous(), same_tol=1e-4)
    log("fit_main_path", steps=20, l2_launches=dict(zip(("fit_step", "render_fwd", "render_bwd"), l2_counts)),
        multiscale_launches=dict(zip(("fit_step", "render_fwd", "render_bwd"), ms_counts)), plain_calls=plain.calls,
        l2_losses=l2.losses, multiscale_losses=ms.losses, radius=l2.scene.b.radius.item(),
        l2_seconds=l2_seconds, multiscale_seconds=ms_seconds, step0=fit_st)

    # ---- 11. CLI ----
    fit_step_kernel.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "fit.jsonl")
        check(cli.main(["fit", "--width", str(W), "--height", str(H), "--steps", "10", "--metrics", metrics]) == 0,
              "cli fit failed")
        with open(metrics) as f:
            lines = [json.loads(ln) for ln in f]
    check(len(lines) >= 2 and all(math.isfinite(ln["loss"]) for ln in lines), f"bad metrics {lines}")
    check(fit_step_kernel.launches == 10, f"cli fit launched the fit step {fit_step_kernel.launches} times")
    log("cli_fit", metrics_lines=len(lines), losses=[ln["loss"] for ln in lines], launches=fit_step_kernel.launches)

    # ---- 12. times at 1080p (plain, kernel, kernel, plain) ----
    sc = scene0()
    prm, uni = inputs(sc, cam, cfg)
    tgt = target.permute(2, 0, 1).contiguous()
    _, t, sh, ao = render_kernel_launch(sc, prm, uni, cfg)
    g_rgb = torch.randn((3, H, W), generator=gen, device=dev)
    bwd = lambda: render_kernel_backward_launch(sc, prm, uni, g_rgb, t, sh, ao, cfg)  # noqa: E731
    bwd_plain = lambda: render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, cfg)  # noqa: E731
    fit_k = lambda: fit_step_kernel_launch(sc, prm, uni, tgt, cfg, KernelConfig(), False, frozen)  # noqa: E731
    fit_p = lambda: fit_step_kernel_plain(sc, prm, uni, tgt, cfg, KernelConfig(), False, frozen)  # noqa: E731
    runs = {}
    for name, kern, plain_fn in (("fit_step", fit_k, fit_p), ("render_bwd", bwd, bwd_plain)):
        p1, k1, k2, p2 = time_ms(torch, plain_fn), time_ms(torch, kern), time_ms(torch, kern), time_ms(torch, plain_fn)
        runs[name] = {"ms": (k1 + k2) / 2, "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}
    bwd_st = check_grads(torch.cat(bwd()), torch.cat(bwd_plain()), gradient_mass(sc, prm, uni, g_rgb, t, sh, ao, cfg),
                         rtol=1e-4, mass_tol=1e-3, label="render backward 1080p")
    fit_scene(target, scene0(), cam, light, mat, cfg, FitConfig(steps=5, log_every=5), trainable=trainable, device=dev)
    res = fit_scene(target, scene0(), cam, light, mat, cfg, FitConfig(steps=50, log_every=50),
                    trainable=trainable, device=dev)
    fit_ms = W * H / res.rays_per_second * 1e3
    log("times_fit_1080p", card=card, fit_scene_ms_per_step=fit_ms, fwd_bwd_rays_per_s=res.rays_per_second,
        render_bwd_1080p=bwd_st, **runs)
    return [
        {"name": "fit_step", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/fit_kernel.cu",
         "replaces": "sdf3d_tpu/ops/fit_kernel.py:93", "launches": l2_counts[0],
         "max_abs_err": fit_st["own_march"]["max_abs_err"], "ms": runs["fit_step"]["ms"],
         "plain_ms": runs["fit_step"]["plain_ms"]},
        {"name": "render_bwd", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/render_bwd_kernel.cu",
         "replaces": "sdf3d_tpu/ops/render_bwd_kernel.py:194", "launches": ms_counts[2],
         "max_abs_err": bwd_st["max_abs_err"], "ms": runs["render_bwd"]["ms"],
         "plain_ms": runs["render_bwd"]["plain_ms"]},
    ]


if __name__ == "__main__":
    sys.exit(main())
