"""The forward rendering pipeline (the port of ``sdf3d_tpu/render.py``).

``render`` is the port's own reference path, the counterpart of the JAX
package's XLA engine: camera → sphere trace → normals → soft shadow (+AO) →
shade, as whole-image PyTorch code on the device of its inputs.
``render_banded``, ``render_rays_banded`` and ``render_aux_banded`` run it
over bands of rows, each band marching until its own rays stop (the JAX
package's engine for neural scenes).  ``render_batch`` renders several
cameras with either ``render`` (``engine="torch"``) or a CUDA kernel
(``engine="kernel"``, one launch per frame: the neural kernel for a neural
scene, the render kernel for an analytic one).  Nothing here records an
autograd graph (``ops.render_kernel_diff`` is the differentiable render).
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
    shadow_override: torch.Tensor | None = None,
    ao_override: torch.Tensor | None = None,
) -> torch.Tensor:
    """Shade rays given their marched distances; RGB ``(..., 3)``.  The hit
    point ``origin + d·ray`` is shaded even for misses unless
    ``config.background`` composites them out.  ``shadow_override`` /
    ``ao_override`` substitute factors already computed for the secondary
    marches (``render_aux_banded``)."""
    sdf_fn = scene.distance
    p = origins + distances[..., None] * directions
    n = estimate_normals(sdf_fn, p, config.normals, config.march.epsilon)
    if shadow_override is not None:
        shadow = shadow_override
    elif config.shadow.enabled:
        shadow = soft_shadow(sdf_fn, p + n * (2.0 * config.march.epsilon), vnormalize(light.position - p),
                             config.shadow, config.march)
    else:
        shadow = torch.ones_like(distances)
    if ao_override is not None:
        ao = ao_override if config.ao.enabled else None
    else:
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


def render_aa(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    factor: int = 2,
    engine: str = "kernel",
    device="cuda",
) -> torch.Tensor:
    """Supersampled render ``(H, W, 3)``: the image rendered at ``factor``
    times the size (``factor²`` rays a pixel), then the mean of each
    ``factor × factor`` block, in JAX's reshape order.  No reference
    counterpart.  ``engine``: ``"kernel"`` (JAX's ``"pallas"``) or
    ``"torch"`` (JAX's ``"xla"``), through :func:`render_batch` on
    ``device``; JAX's ``"diff"`` engine is ``diff.py``'s, not ported yet
    (ROADMAP item 5)."""
    import dataclasses

    if engine == "diff":
        raise NotImplementedError("render_aa(engine='diff') renders through diff.py, which is not ported yet "
                                  "(ROADMAP item 5)")
    big = dataclasses.replace(config, width=config.width * factor, height=config.height * factor)
    img = render_batch(scene, [camera], light, mat, big, engine=engine, device=device)[0]
    h, w = config.height, config.width
    return img.reshape(h, factor, w, factor, 3).mean(dim=(1, 3))


@torch.no_grad()
def render_depth(scene: SDFNode, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Marched distance per pixel ``(H, W)`` (an AOV for debugging), on the
    device of the inputs: :func:`camera_rays` and :func:`sphere_trace`,
    over-relaxed when ``config.march.relaxation != 1``."""
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return sphere_trace(scene.distance, origins, directions, config.march)


def _bands(x: torch.Tensor, band_rows: int) -> torch.Tensor:
    """(H, W, ...) → (n_bands, band_rows, W, ...), the last band padded by
    repeating the last row (JAX's ``jnp.pad(mode="edge")``)."""
    H = x.shape[0]
    Hp = -(-H // band_rows) * band_rows
    if Hp != H:
        x = torch.cat([x, x[-1:].expand(Hp - H, *x.shape[1:])])
    return x.reshape(Hp // band_rows, band_rows, *x.shape[1:])


@torch.no_grad()
def render_rays_banded(
    scene: SDFNode,
    origins: torch.Tensor,
    directions: torch.Tensor,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    band_rows: int = 48,
    inner=None,
) -> torch.Tensor:
    """:func:`render_rays` over bands of ``band_rows`` rows of a ray bundle
    (H, W, 3) × 2 → RGB (H, W, 3): each band's marches stop when its own rays
    have, not the image's.  Per-ray values are those of the unbanded render.
    ``inner`` defaults to :func:`render_rays`."""
    fn = inner or render_rays
    H = origins.shape[0]
    band_rows = min(band_rows, H)
    ob, db = _bands(origins, band_rows), _bands(directions, band_rows)
    out = torch.stack([fn(scene, o, d, light, mat, config) for o, d in zip(ob, db)])
    return out.reshape(-1, *out.shape[2:])[:H]


@torch.no_grad()
def render_banded(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    band_rows: int = 48,
) -> torch.Tensor:
    """A full image ``(H, W, 3)`` by :func:`render_rays_banded`."""
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return render_rays_banded(scene, origins, directions, light, mat, config, band_rows)


@torch.no_grad()
def render_aux_banded(
    scene: SDFNode,
    camera: Camera,
    light: PointLight,
    mat: Material,
    config: RenderConfig,
    band_rows: int = 48,
):
    """Banded render returning ``(rgb (H,W,3), t, shadow, ao)``: the planes
    of the render kernels' outputs, from the reference path's marches
    (shadow and AO ones where disabled)."""
    H, W = config.height, config.width
    origins, directions = camera_rays(camera, W, H, config.ray_mode)
    outs = []
    for o, d in zip(_bands(origins, band_rows), _bands(directions, band_rows)):
        t = sphere_trace(scene.distance, o, d, config.march)
        p = o + t[..., None] * d
        n = estimate_normals(scene.distance, p, config.normals, config.march.epsilon)
        if config.shadow.enabled:
            sh = soft_shadow(scene.distance, p + n * (2.0 * config.march.epsilon), vnormalize(light.position - p),
                             config.shadow, config.march)
        else:
            sh = torch.ones_like(t)
        ao = ambient_occlusion(scene.distance, p, n, config.ao) if config.ao.enabled else torch.ones_like(t)
        rgb = shade_pixels(scene, o, d, t, light, mat, config, shadow_override=sh, ao_override=ao)
        outs.append((rgb, t, sh, ao))
    return tuple(torch.cat(planes)[:H] for planes in zip(*outs))


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
    nc=None,
) -> torch.Tensor:
    """Render a sequence of cameras on ``device``: ``(N, H, W, 3)``.

    ``engine="kernel"`` launches a CUDA kernel once per frame (on a CPU
    device its plain PyTorch version runs instead): the neural kernel
    (settings ``nc``) for a scene ``ops.neural_kernel.split_neural``
    accepts, else the render kernel (settings ``kc``), which raises
    ``NotImplementedError`` for a node without an emitter.  ``engine="torch"`` runs :func:`render`.  The
    default device is the card, and there is no quiet move to the CPU:
    without CUDA the call fails.
    """
    device = torch.device(device)
    if engine == "kernel":
        from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, render_neural_forward
        from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward
        from sdf3d_tpu_torch.ops.scene_program import is_neural_shape

        if is_neural_shape(scene):
            nc = nc or NeuralRenderConfig()

            def one(cam):
                return render_neural_forward(scene, cam, light, mat, config, nc, device=device)[0]
        else:
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
