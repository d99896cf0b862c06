"""Headless frame loop (the port of ``sdf3d_tpu/interact/app.py``).

The reference loop (its ``main.cpp:87-98``) is begin → poll events →
navigate → plot → end.  Here the same loop runs headless: input events come
from a programmatic source (scripted gestures, a replay file, or live
callbacks), navigation runs in the native controller, and frames land in an
image sink instead of a swapchain.  The renderer is a plain function of the
camera, typically a closure over ``ops.render_kernel_forward`` (K1 on the
card, one launch a frame); the camera is a run-time input, so a new pose
never rebuilds a kernel.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Iterable

import numpy as np
import torch

from sdf3d_tpu_torch.camera import REFERENCE_BASE_POSITION, Camera
from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.interact.controller import NavigationController
from sdf3d_tpu_torch.utils.image_io import write_png


@dataclasses.dataclass
class FrameStats:
    """Per-frame timing — the tic/toc analogue (``main.cpp:89,97``)."""

    frame: int
    seconds: float
    rays_per_second: float


def _to_host(img) -> np.ndarray:
    """An image as a host numpy array: a tensor is copied back from its
    device (``.cpu()``, which waits for the work that makes it)."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


class InteractiveSession:
    """Drive a renderer with a navigation controller, frame by frame.

    ``render_fn(camera) -> (H, W, 3) image`` (a tensor on any device, or an
    array) — typically a closure over ``ops.render_kernel_forward`` with the
    scene, light and material bound.  The cameras are built on ``device``
    (the card unless the caller asks for the CPU).
    """

    def __init__(
        self,
        render_fn: Callable[[Camera], object],
        config: RenderConfig,
        nav: NavigationController | None = None,
        fov_deg: float = 60.0,
        device="cuda",
    ):
        self.render_fn = render_fn
        self.config = config
        self.nav = nav or NavigationController().configure()
        self.fov_deg = fov_deg
        self.device = torch.device(device)
        self.frame_count = 0
        self.stats: list[FrameStats] = []

    def camera(self) -> Camera:
        # Host-side numpy pose math (a 4×4 inverse), as the JAX package's:
        # one small upload of the result instead of a few tiny device ops.
        V = np.asarray(self.nav.view_matrix(), np.float32)
        Vinv = np.linalg.inv(V)
        base = np.array([*REFERENCE_BASE_POSITION, 1.0], np.float32)
        return Camera(
            position=torch.from_numpy((Vinv @ base)[:3].astype(np.float32)).to(self.device),
            c2w=torch.from_numpy(np.ascontiguousarray(Vinv[:3, :3], np.float32)).to(self.device),
            fov_deg=torch.tensor(self.fov_deg, dtype=torch.float32, device=self.device),
        )

    def frame(self, dt: float = 1 / 60) -> np.ndarray:
        """Advance navigation and render one frame.  ``FrameStats.seconds``
        runs from the pose math to the image on the host: the copy back
        waits for the device, so it holds the device's work too."""
        self.nav.step(dt)
        t0 = time.perf_counter()
        img = _to_host(self.render_fn(self.camera()))
        seconds = time.perf_counter() - t0
        self.stats.append(
            FrameStats(
                frame=self.frame_count,
                seconds=seconds,
                rays_per_second=self.config.width * self.config.height / max(seconds, 1e-12),
            )
        )
        self.frame_count += 1
        return img

    def run(
        self,
        events: Iterable[Callable[[NavigationController], None]],
        out_dir: str | None = None,
        dt: float = 1 / 60,
    ) -> list[np.ndarray]:
        """Replay a gesture script: each element is a callable applied to the
        controller before its frame (None-like no-ops allowed)."""
        frames = []
        out = pathlib.Path(out_dir) if out_dir else None
        if out:
            out.mkdir(parents=True, exist_ok=True)
        for event in events:
            if event is not None:
                event(self.nav)
            img = self.frame(dt)
            frames.append(img)
            if out:
                write_png(out / f"frame_{self.frame_count - 1:05d}.png", img)
        return frames


def render_turntable(
    render_fn: Callable[[Camera], object],
    config: RenderConfig,
    n_frames: int = 24,
    elevation_deg: float = 15.0,
    radius: float = 2.0,
    out_dir: str | None = None,
    device="cuda",
) -> list[np.ndarray]:
    """Orbit 360° around the scene — the scripted stand-in for mouse orbit.
    The cameras are ``Camera.orbit`` on ``device``."""
    frames = []
    out = pathlib.Path(out_dir) if out_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    for k in range(n_frames):
        cam = Camera.orbit(
            azimuth_deg=360.0 * k / n_frames, elevation_deg=elevation_deg, radius=radius, device=device
        )
        img = _to_host(render_fn(cam))
        frames.append(img)
        if out:
            write_png(out / f"frame_{k:05d}.png", img)
    return frames
