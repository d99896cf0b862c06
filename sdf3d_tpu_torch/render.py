"""The forward rendering pipeline (the port of ``sdf3d_tpu/render.py``).

``render`` is the port's own reference path, the counterpart of the JAX
package's XLA engine: camera → sphere trace → normals → soft shadow (+AO) →
shade, as whole-image PyTorch code on the device of its inputs.
``render_batch`` renders several cameras with either that path
(``engine="torch"``) or the CUDA render kernel (``engine="kernel"``, one
launch per frame).  The port is forward only: nothing here records an
autograd graph.
"""

from __future__ import annotations

import copy

import torch

from sdf3d_tpu_torch.camera import Camera, camera_rays
from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.lighting import Material, PointLight
from sdf3d_tpu_torch.march import ambient_occlusion, estimate_normals, hit_mask, soft_shadow, sphere_trace
from sdf3d_tpu_torch.sdf.node import SDFNode, vnormalize
from sdf3d_tpu_torch.shade import blinn_phong, lambert


def shade_pixels(
    scene: SDFNode,
    origins: torch.Tensor,
    directions: torch.Tensor,
    distances: torch.Tensor,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
) -> torch.Tensor:
    """Shade rays given their marched distances; RGB ``(..., 3)``.  The hit
    point ``origin + d·ray`` is shaded even for misses unless
    ``config.background`` composites them out."""
    sdf_fn = scene.distance
    p = origins + distances[..., None] * directions
    n = estimate_normals(sdf_fn, p, config.normals, config.march.epsilon)
    if config.shadow.enabled:
        shadow_origin = p + n * (2.0 * config.march.epsilon)
        incident = vnormalize(light.position - p)
        shadow = soft_shadow(sdf_fn, shadow_origin, incident, config.shadow, config.march)
    else:
        shadow = torch.ones_like(distances)
    ao = ambient_occlusion(sdf_fn, p, n, config.ao) if config.ao.enabled else None

    if config.shading == "blinn_phong":
        rgb = blinn_phong(p, n, origins, light, mat, shadow, ao)
    elif config.shading == "lambert":
        rgb = lambert(p, n, light, mat, shadow)
    else:
        raise ValueError(f"unknown shading mode: {config.shading!r}")

    if config.background is not None:
        bg = torch.tensor(config.background, dtype=rgb.dtype, device=rgb.device)
        rgb = torch.where(hit_mask(distances, config.march)[..., None], rgb, bg)
    return rgb


@torch.no_grad()
def render_rays(
    scene: SDFNode,
    origins: torch.Tensor,
    directions: torch.Tensor,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
) -> torch.Tensor:
    """March and shade a ray bundle ``(..., 3)`` → RGB ``(..., 3)``."""
    distances = sphere_trace(scene.distance, origins, directions, config.march)
    return shade_pixels(scene, origins, directions, distances, light, mat, config)


@torch.no_grad()
def render(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
) -> torch.Tensor:
    """Render a full image ``(H, W, 3)`` on the device of the inputs."""
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return render_rays(scene, origins, directions, light, mat, config)


@torch.no_grad()
def render_batch(
    scene: SDFNode,
    cameras,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    engine: str = "kernel",
    kc=None,
    device="cuda",
) -> torch.Tensor:
    """Render a sequence of cameras on ``device``: ``(N, H, W, 3)``.

    ``engine="kernel"`` launches the CUDA render kernel once per frame (on a
    CPU device its plain PyTorch version runs instead); ``engine="torch"``
    runs :func:`render`.  The default device is the card, and there is no
    quiet move to the CPU: without CUDA the call fails.
    """
    device = torch.device(device)
    if engine == "kernel":
        from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward

        kc = kc or KernelConfig()

        def one(cam):
            return render_kernel_forward(scene, cam, light, mat, config, kc, device=device)[0]
    elif engine == "torch":
        scene_d = copy.deepcopy(scene).to(device)
        light_d, mat_d = light.to(device), mat.to(device)

        def one(cam):
            return render(scene_d, cam.to(device), light_d, mat_d, config)
    else:
        raise ValueError(f"unknown engine {engine!r}; choose 'kernel' or 'torch'")
    return torch.stack([one(cam) for cam in cameras])
