"""Projection modes: side-by-side stereo and anaglyph (the port of
``sdf3d_tpu/stereo.py``).

The inter-ocular offset lies along the camera's +x (right) axis;
``convergence`` (optional) toes both eyes in so their optical axes meet at
that distance along the centre's forward axis (a parallel rig when None).
The camera pair is differentiable in ``baseline`` and ``convergence``.
"""

from __future__ import annotations

import dataclasses

import torch

from sdf3d_tpu_torch.camera import Camera
from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.lighting import Material, PointLight
from sdf3d_tpu_torch.sdf.node import SDFNode
from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=like.device)
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _rotate(r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``r @ m`` for 3x3 matrices as elementwise products and sums (a matrix
    product may run in TF32 on the card)."""
    return (r[:, :, None] * m[None, :, :]).sum(1)


def stereo_cameras(camera: Camera, baseline=0.065, convergence=None) -> tuple[Camera, Camera]:
    """Split a camera into a (left, right) stereo pair: the eyes sit
    ``±baseline/2`` along its right axis; with ``convergence`` each eye also
    yaws about the camera's up axis by ``atan(baseline / (2·convergence))``,
    the left by −θ and the right by +θ, so the optical axes meet at that
    distance (a toe-in rig)."""
    b = _scalar(baseline, camera.position)
    offset = camera.c2w[:, 0] * (b * 0.5)
    left_pos, right_pos = camera.position - offset, camera.position + offset
    if convergence is None:
        return (dataclasses.replace(camera, position=left_pos), dataclasses.replace(camera, position=right_pos))
    up = camera.c2w[:, 1]
    theta = torch.atan2(b * 0.5, _scalar(convergence, camera.position))
    r_l, r_r = rotvec_to_matrix(up * (-theta)), rotvec_to_matrix(up * theta)
    return (dataclasses.replace(camera, position=left_pos, c2w=_rotate(r_l, camera.c2w)),
            dataclasses.replace(camera, position=right_pos, c2w=_rotate(r_r, camera.c2w)))


def render_stereo(scene: SDFNode, camera: Camera, light: PointLight, mat: Material, config: RenderConfig,
                  mode: str = "sbs", baseline=0.065, convergence=None, engine: str = "kernel", kc=None,
                  device="cuda") -> torch.Tensor:
    """Stereo render of both eyes in one ``render_batch`` call (with
    ``engine="kernel"`` one render-kernel launch an eye; ``"torch"`` is
    JAX's ``"xla"``), on ``device``.  ``mode``: ``"sbs"``, side by side
    ``(H, 2W, 3)`` (left | right); ``"cross"``, crossed ``(H, 2W, 3)``
    (right | left); ``"anaglyph"``, a red/cyan composite ``(H, W, 3)``: red
    from the left eye, green and blue from the right."""
    from sdf3d_tpu_torch.render import render_batch

    if mode not in ("sbs", "cross", "anaglyph"):
        raise ValueError(f"unknown stereo mode {mode!r} (sbs | cross | anaglyph)")
    left, right = render_batch(scene, list(stereo_cameras(camera, baseline, convergence)), light, mat, config,
                               engine=engine, kc=kc, device=device)
    if mode == "sbs":
        return torch.cat([left, right], dim=1)
    if mode == "cross":
        return torch.cat([right, left], dim=1)
    return torch.stack([left[..., 0], right[..., 1], right[..., 2]], dim=-1)
