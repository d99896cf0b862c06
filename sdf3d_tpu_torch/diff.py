"""Implicit-function gradients through the sphere-trace march (the port of
``sdf3d_tpu/diff.py``).

Reverse-differentiating the march step by step would keep every step's
intermediates.  Instead the hit distance is treated as an implicit function
of everything upstream: at convergence the march satisfies ``f(o + t·d; θ)
= ε``, so

    dt = −(∇f·do + t·∇f·dd + f_θ·dθ) / (∇f·d)

and the backward needs **one extra distance evaluation**, however long the
march.  The forward is the port's own march (``march.py``), recorded by no
graph; :class:`SphereTraceImplicit` and :class:`RayMinSdfDiff` are
``torch.autograd.Function``s whose backward evaluates the distance once at
the recorded point under ``torch.enable_grad()``.

A ``torch.autograd.Function`` returns gradients only for tensors passed to
``apply``, so the scene's parameters that require grad
(``scene.parameters()`` order) follow the rays as inputs; the scene itself
rides on ``ctx``.  The denominator ``∇f·d`` comes from ``autograd.grad`` of
the distance with unit weights (the distance is pointwise: one point's value
depends on that point alone), where JAX takes a ``jvp``: the two round apart
in the last bits.

Misses (``t > max_distance``) and grazing rays (``|∇f·d| < DENOM_FLOOR``)
get zero gradient.  Silhouette motion is invisible to interior-point
gradients; :func:`coverage` (the ray's closest approach, an envelope-theorem
gradient) is the channel that sees it.  Everything runs on the device of its
inputs.
"""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.camera import Camera, camera_rays
from sdf3d_tpu_torch.config import MarchConfig, RenderConfig
from sdf3d_tpu_torch.lighting import Material, PointLight
from sdf3d_tpu_torch.march import ray_min_sdf, sphere_trace
from sdf3d_tpu_torch.render import shade_pixels
from sdf3d_tpu_torch.sdf.node import SDFNode

#: Grazing-ray guard: |∇f·d| below this gets zero gradient instead of a blowup.
DENOM_FLOOR = 1e-4


def _trained(scene: SDFNode) -> list:
    """The scene's parameters that require grad, in ``parameters()`` order."""
    return [p for p in scene.parameters() if p.requires_grad]


def _at_point(ctx):
    """``(p, f(p))`` at the recorded point ``p = o + t·d`` (``t`` the saved
    march distance), ``p`` a fresh leaf, recorded by autograd: call under
    ``torch.enable_grad()``."""
    origins, directions, t = ctx.saved_tensors
    p = (origins + t[..., None] * directions).detach().requires_grad_(True)
    return p, ctx.scene.distance(p)


def _pullback(ctx, p, f, u):
    """``(None, None, ō, d̄, *θ̄)`` of the cotangent ``u`` on ``f = f(p; θ)``
    with ``p = o + t·d`` and ``t`` held as data: ``ō = p̄``, ``d̄ = t·p̄``
    (summed to the rays' shapes where they broadcast)."""
    origins, directions, t = ctx.saved_tensors
    p_bar, *scene_bar = torch.autograd.grad(f, [p, *ctx.params], u, allow_unused=True)
    o_bar = p_bar.sum_to_size(origins.shape) if ctx.needs_input_grad[2] else None
    d_bar = (t[..., None] * p_bar).sum_to_size(directions.shape) if ctx.needs_input_grad[3] else None
    return (None, None, o_bar, d_bar, *scene_bar)


class SphereTraceImplicit(torch.autograd.Function):
    """``t = sphere_trace(scene.distance, o, d, cfg)`` with the
    implicit-function backward (module docstring).  ``apply(cfg, scene, o,
    d, *params)``: ``params`` the scene's tensors that take a gradient."""

    @staticmethod
    def forward(ctx, cfg: MarchConfig, scene: SDFNode, origins, directions, *params):
        t = sphere_trace(scene.distance, origins, directions, cfg)
        ctx.save_for_backward(origins, directions, t)
        ctx.cfg, ctx.scene, ctx.params = cfg, scene, params
        return t

    @staticmethod
    def backward(ctx, g):
        _, directions, t = ctx.saved_tensors
        with torch.enable_grad():
            p, f = _at_point(ctx)
            (grad_f,) = torch.autograd.grad(f, p, torch.ones_like(f), retain_graph=True)
            denom = (grad_f * directions).sum(-1)
            usable = (t <= ctx.cfg.max_distance) & (denom.abs() >= DENOM_FLOOR)
            u = torch.where(usable, -g / torch.where(usable, denom, torch.ones_like(denom)), torch.zeros_like(g))
            return _pullback(ctx, p, f, u)


def sphere_trace_implicit(cfg: MarchConfig, scene: SDFNode, origins: torch.Tensor,
                          directions: torch.Tensor) -> torch.Tensor:
    """March distance with the implicit-function gradient; its value is
    :func:`~sdf3d_tpu_torch.march.sphere_trace`'s bit for bit."""
    return SphereTraceImplicit.apply(cfg, scene, origins, directions, *_trained(scene))


class RayMinSdfDiff(torch.autograd.Function):
    """``min_s`` of :func:`~sdf3d_tpu_torch.march.ray_min_sdf` with the
    envelope-theorem backward: ``∂min_s/∂θ = ∂f/∂θ`` at the closest-approach
    point ``o + t_min·d``, ``t_min`` held as data."""

    @staticmethod
    def forward(ctx, cfg: MarchConfig, scene: SDFNode, origins, directions, *params):
        min_s, t_min = ray_min_sdf(scene.distance, origins, directions, cfg)
        ctx.save_for_backward(origins, directions, t_min)
        ctx.scene, ctx.params = scene, params
        return min_s

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            p, f = _at_point(ctx)
            return _pullback(ctx, p, f, g)


def ray_min_sdf_diff(cfg: MarchConfig, scene: SDFNode, origins: torch.Tensor,
                     directions: torch.Tensor) -> torch.Tensor:
    """Differentiable closest approach of each ray to the scene, shape
    ``(...,)``: the silhouette gradient channel, one distance evaluation in
    the backward."""
    return RayMinSdfDiff.apply(cfg, scene, origins, directions, *_trained(scene))


def coverage(cfg: MarchConfig, scene: SDFNode, origins: torch.Tensor, directions: torch.Tensor,
             beta: float | None = None) -> torch.Tensor:
    """Soft hit coverage per ray in (0, 1): ``sigmoid((2ε − min_s)/β)``, by
    default ``β = ε/2.5``.  Near 1 where the ray hits (the march stops once
    ``f < ε``, so a hit's ``min_s`` lies below ε and the ``2ε`` shift puts it
    at ``σ(≥ ε/β)`` ≥ 0.92), toward 0 away from surfaces, smooth across
    silhouettes: the term that restores the silhouette force in a fit."""
    beta = cfg.epsilon / 2.5 if beta is None else beta
    min_s = ray_min_sdf_diff(cfg, scene, origins, directions)
    return torch.sigmoid((2.0 * cfg.epsilon - min_s) / beta)


def render_rays_diff(scene: SDFNode, origins: torch.Tensor, directions: torch.Tensor, light: PointLight,
                     mat: Material, config: RenderConfig) -> torch.Tensor:
    """Differentiable march and shade of a ray bundle ``(..., 3)`` → RGB
    ``(..., 3)``: the value of :func:`~sdf3d_tpu_torch.render.render_rays`,
    with gradients for the scene, the rays, the light and the material
    through the implicit march and autograd of the shading (normals, AO; the
    shadow as ``config.shadow.grad`` says).  With ``normals="autodiff"`` the
    normals' own gradient graph carries the surface orientation's terms."""
    distances = sphere_trace_implicit(config.march, scene, origins, directions)
    return shade_pixels(scene, origins, directions, distances, light, mat, config)


def render_diff(scene: SDFNode, camera: Camera, light: PointLight, mat: Material,
                config: RenderConfig) -> torch.Tensor:
    """Differentiable full image ``(H, W, 3)`` on the device of its inputs:
    any loss of it has gradients for the scene's parameters and every
    camera, light and material tensor that requires grad."""
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return render_rays_diff(scene, origins, directions, light, mat, config)


def depth_implicit(scene: SDFNode, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Differentiable depth map ``(H, W)`` through the implicit march."""
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    return sphere_trace_implicit(config.march, scene, origins, directions)
