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

Then one JSON line describing the kernel, and last the JSON result line.
Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

    print(json.dumps({"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "sdf3d_tpu_torch/ops/csrc/render_kernel.cu",
        "replaces": "sdf3d_tpu/ops/render_kernel.py:614",
        "launches": main_launches,
        "max_abs_err": parity["rgb"]["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
