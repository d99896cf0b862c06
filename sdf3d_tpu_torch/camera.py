"""Pinhole camera and ray generation (the port of ``sdf3d_tpu/camera.py``).

The camera is a plain dataclass of float32 tensors: eye ``position`` (3,),
camera-to-world rotation ``c2w`` (3,3) and vertical ``fov_deg`` ().  Ray
directions are ``normalize(c2w · normalize(qx·AR, qy, focal_z))`` over the
pixel grid, both normalisations kept for parity with the reference shader.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sdf3d_tpu_torch.sdf.node import as_f32, mat_vec, tensors_to, vnormalize

#: The reference app's base eye position.
REFERENCE_BASE_POSITION = (0.0, 0.2, 2.0)


@dataclasses.dataclass
class Camera:
    """Pinhole camera: ``position`` (3,), ``c2w`` (3,3), ``fov_deg`` ()."""

    position: torch.Tensor
    c2w: torch.Tensor
    fov_deg: torch.Tensor

    def to(self, device) -> "Camera":
        """A copy with every tensor on ``device``."""
        return tensors_to(self, device)

    @staticmethod
    def reference(view_matrix=None, device=None) -> "Camera":
        """The reference app's camera: eye (0, 0.2, 2), identity rotation,
        fov 60°.  ``view_matrix`` (4×4 arcball ``V_mat``) applies its inverse
        to the eye and the rays, as the shader does."""
        if view_matrix is not None:
            return Camera.from_view_matrix(view_matrix, fov_deg=60.0, device=device)
        return Camera(
            position=as_f32(REFERENCE_BASE_POSITION, device),
            c2w=torch.eye(3, dtype=torch.float32, device=device),
            fov_deg=as_f32(60.0, device),
        )

    @staticmethod
    def from_view_matrix(view_matrix, base_position=None, fov_deg=60.0, device=None) -> "Camera":
        """Eye ``inverse(V) · base``; rotation block of ``inverse(V)``."""
        V = as_f32(view_matrix, device)
        Vinv = torch.linalg.inv(V)
        base = as_f32(REFERENCE_BASE_POSITION if base_position is None else base_position, device)
        one = torch.ones(1, dtype=torch.float32, device=device)
        pos = mat_vec(Vinv, torch.cat([base, one]))[:3]
        return Camera(position=pos, c2w=Vinv[:3, :3].contiguous(), fov_deg=as_f32(fov_deg, device))

    @staticmethod
    def orbit(azimuth_deg=0.0, elevation_deg=0.0, radius=2.0, target=(0.0, 0.2, 0.0), fov_deg=60.0, device=None) -> "Camera":
        """Camera on a sphere of ``radius`` around ``target``, looking at it."""
        az = math.radians(azimuth_deg)
        el = math.radians(elevation_deg)
        eye_dir = as_f32(
            [math.cos(el) * math.sin(az), math.sin(el), math.cos(el) * math.cos(az)], device
        )
        target = as_f32(target, device)
        position = target + radius * eye_dir
        return Camera.look_at(position, target, fov_deg=fov_deg, device=device)

    @staticmethod
    def look_at(position, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fov_deg=60.0, device=None) -> "Camera":
        """Camera at ``position`` looking toward ``target`` (−z forward)."""
        position = as_f32(position, device)
        target = as_f32(target, device)
        up = as_f32(up, device)
        forward = vnormalize(target - position)
        right = vnormalize(torch.linalg.cross(forward, up))
        true_up = torch.linalg.cross(right, forward)
        c2w = torch.stack([right, true_up, -forward], dim=-1)
        return Camera(position=position, c2w=c2w, fov_deg=as_f32(fov_deg, device))


def pixel_grid(width: int, height: int, device=None):
    """NDC coordinates ``(qx, qy)`` of every pixel centre, each (H, W), row 0
    at the top."""
    f32 = torch.float32
    xs = (2.0 * (torch.arange(width, dtype=f32, device=device) + 0.5) / width) - 1.0
    ys = 1.0 - (2.0 * (torch.arange(height, dtype=f32, device=device) + 0.5) / height)
    return xs[None, :].expand(height, width), ys[:, None].expand(height, width)


def focal_z(fov_deg: torch.Tensor, ray_mode: str) -> torch.Tensor:
    """The (negative) z of the unnormalised camera-frame ray, in float32:
    ``-2/tan(fov·π/360)`` for ``"reference"`` (the shader's factor 2 halves
    the effective FOV), ``-1/tan(fov/2)`` for ``"pinhole"``.  A tensor
    ``fov_deg`` keeps its autograd graph."""
    fov = fov_deg.to(torch.float32) if isinstance(fov_deg, torch.Tensor) else as_f32(fov_deg)
    half_angle = fov * (math.pi / 360.0)
    scale = {"reference": 2.0, "pinhole": 1.0}[ray_mode]
    return -scale / torch.tan(half_angle)


def generate_rays(camera: Camera, qx, qy, aspect_ratio: float, ray_mode: str = "reference"):
    """World ray directions for NDC coordinates ``(qx, qy)``; returns
    ``qx.shape + (3,)``."""
    z = focal_z(camera.fov_deg, ray_mode).to(qx.device).expand(qx.shape)
    cam_dir = vnormalize(torch.stack([qx * aspect_ratio, qy, z], dim=-1))
    return vnormalize(mat_vec(camera.c2w, cam_dir))


def camera_rays(camera: Camera, width: int, height: int, ray_mode: str = "reference"):
    """Full-image ray bundle ``(origins, directions)``, each (H, W, 3), on the
    camera's device."""
    qx, qy = pixel_grid(width, height, camera.position.device)
    directions = generate_rays(camera, qx, qy, width / height, ray_mode)
    return camera.position.expand(directions.shape), directions


def camera_rays_for_rows(camera: Camera, width: int, height: int, rows, ray_mode: str = "reference"):
    """Ray bundle ``(origins, directions)``, each (R, W, 3), for the absolute
    image rows ``rows`` (any order: an interleaved rank passes its permuted
    rows).  Row ``k`` equals row ``rows[k]`` of :func:`camera_rays`: the NDC
    mapping uses the full image's extent.  A rank of a sharded fit builds
    only its own rows with it (``parallel/launch.py``)."""
    dev = camera.position.device
    rows = torch.as_tensor(rows, dtype=torch.float32, device=dev)
    xs = (2.0 * (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width) - 1.0
    ys = 1.0 - (2.0 * (rows + 0.5) / height)
    r = rows.shape[0]
    qx, qy = xs[None, :].expand(r, width), ys[:, None].expand(r, width)
    directions = generate_rays(camera, qx, qy, width / height, ray_mode)
    return camera.position.expand(directions.shape), directions
