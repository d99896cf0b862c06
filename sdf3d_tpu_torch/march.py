"""Sphere-trace, soft-shadow and AO marches and normal estimation (the port of
``sdf3d_tpu/march.py``), in plain PyTorch.

Every march is a masked loop over a whole batch of rays: an ``active`` mask
freezes finished rays, and with ``early_exit`` the loop stops once no ray is
active.  Updates are ordered as the reference shader's loop bodies.  All
functions take ``sdf_fn: (..., 3) -> (...)``, typically ``scene.distance``.
"""

from __future__ import annotations

from typing import Callable

import torch

from sdf3d_tpu_torch.config import AOConfig, MarchConfig, ShadowConfig
from sdf3d_tpu_torch.sdf.node import sqrt_rn, vnormalize

SDFFn = Callable[[torch.Tensor], torch.Tensor]

#: Attenuation used when the shadow step is degenerate (see soft_shadow).
_NO_DARKEN = 1e30
_TINY = 1e-30
#: Closest-approach estimates beyond this are degenerate and discarded.
_INTER_CAP = 1e15


class _SqrtGradSafe(torch.autograd.Function):
    """:func:`sqrt_rn` with JAX's ``_sqrt_grad_safe`` derivative: ``g·0.5/
    max(r, 1e-20)`` where ``x > 0`` and 0 at ``x = 0``, where a shadow step
    that marches straight away from a plane (``d2 = 0`` exactly) would
    otherwise give ``0·inf = NaN``."""

    @staticmethod
    def forward(ctx, x):
        r = sqrt_rn(x.detach())
        ctx.save_for_backward(x, r)
        return r

    @staticmethod
    def backward(ctx, g):
        x, r = ctx.saved_tensors
        return torch.where(x > 0, 0.5 / torch.clamp(r, min=1e-20), torch.zeros_like(r)) * g


def _batch(origins, directions):
    return torch.broadcast_shapes(origins.shape[:-1], directions.shape[:-1])


def sphere_trace(sdf_fn: SDFFn, origins: torch.Tensor, directions: torch.Tensor, cfg: MarchConfig) -> torch.Tensor:
    """Sphere-trace march; the marched distance per ray, shape ``(...,)``.

    Each step evaluates the SDF, **adds it to the distance**, then stops the
    ray when ``distance > max_distance or sdf < epsilon`` — so the returned
    distance overshoots by the last step, and a miss carries a distance
    beyond ``max_distance`` (test with :func:`hit_mask`).  With
    ``cfg.relaxation != 1`` the march is over-relaxed
    (:func:`_sphere_trace_relaxed`).
    """
    if cfg.relaxation != 1.0:
        return _sphere_trace_relaxed(sdf_fn, origins, directions, cfg)
    dist = torch.zeros(_batch(origins, directions), dtype=origins.dtype, device=origins.device)
    active = torch.ones_like(dist, dtype=torch.bool)
    for _ in range(cfg.max_steps):
        if cfg.early_exit and not bool(active.any()):
            break
        s = sdf_fn(origins + dist[..., None] * directions)
        dist = torch.where(active, dist + s, dist)
        active = active & ~((dist > cfg.max_distance) | (s < cfg.epsilon))
    return dist


def _sphere_trace_relaxed(sdf_fn: SDFFn, origins: torch.Tensor, directions: torch.Tensor,
                          cfg: MarchConfig) -> torch.Tensor:
    """Over-relaxed sphere trace (Keinert et al. 2014; JAX's
    ``_sphere_trace_relaxed``): a ray steps ``ω·s``; when consecutive
    bounding spheres stop overlapping (``ω > 1`` and ``|s| + prev_r <
    step_len``) the step failed, so the ray steps back by ``step_len·(1 −
    ω)`` and marches on with ``ω = 1``.  A hit (no failure and ``s <
    epsilon``) lands with ``+s``, like the exact march; a failed step's
    ``s < epsilon`` does not stop the ray (its point lies beyond the
    validated interval).  A ray stops on a hit or past ``max_distance``."""
    shape = _batch(origins, directions)
    kw = dict(dtype=origins.dtype, device=origins.device)
    t = torch.zeros(shape, **kw)
    prev_r = torch.zeros(shape, **kw)
    step_len = torch.zeros(shape, **kw)
    om = torch.full(shape, cfg.relaxation, **kw)
    active = torch.ones(shape, dtype=torch.bool, device=origins.device)
    for _ in range(cfg.max_steps):
        if cfg.early_exit and not bool(active.any()):
            break
        s = sdf_fn(origins + t[..., None] * directions)
        t, prev_r, step_len, om, active = relaxed_step(s, t, prev_r, step_len, om, active, cfg)
    return t


def relaxed_step(s, t, prev_r, step_len, om, active, cfg: MarchConfig):
    """One step of the over-relaxed march from the distance ``s`` at ``t``:
    the new ``(t, prev_r, step_len, ω, active)``, the inactive rays' ``t``
    and ``step_len`` unmoved (:func:`_sphere_trace_relaxed`; the kernels'
    ``csrc/render_kernel.cuh::march_primary``)."""
    fail = (om > 1.0) & (torch.abs(s) + prev_r < step_len)
    hit = ~fail & (s < cfg.epsilon)
    new_step = torch.where(fail, step_len * (1.0 - om), om * s)
    new_step = torch.where(hit, s, new_step)
    om = torch.where(fail, torch.ones_like(om), om)
    t = torch.where(active, t + new_step, t)
    done = hit | (t > cfg.max_distance)
    return t, torch.abs(s), torch.where(active, new_step, step_len), om, active & ~done


def march_step_map(sdf_fn: SDFFn, origins: torch.Tensor, directions: torch.Tensor, cfg: MarchConfig):
    """Per-ray ``(distance, steps)`` of the unrelaxed primary march: the
    masked loop of :func:`sphere_trace` with a count of the steps each ray
    took (float32).  The work model of the tile-queue's balanced plans
    (``parallel/tile_queue.estimate_tile_work``) and of the kernels' bounds:
    a ray costs one distance evaluation a step.  It marches unrelaxed
    whatever ``cfg.relaxation`` says, as JAX's."""
    dist = torch.zeros(_batch(origins, directions), dtype=origins.dtype, device=origins.device)
    steps = torch.zeros_like(dist)
    active = torch.ones_like(dist, dtype=torch.bool)
    for _ in range(cfg.max_steps):
        if cfg.early_exit and not bool(active.any()):
            break
        s = sdf_fn(origins + dist[..., None] * directions)
        steps = steps + active.to(steps.dtype)
        dist = torch.where(active, dist + s, dist)
        active = active & ~((dist > cfg.max_distance) | (s < cfg.epsilon))
    return dist, steps


def hit_mask(distance: torch.Tensor, cfg: MarchConfig) -> torch.Tensor:
    """True where the march converged on a surface."""
    return distance <= cfg.max_distance


def ray_min_sdf(sdf_fn: SDFFn, origins: torch.Tensor, directions: torch.Tensor, cfg: MarchConfig):
    """Minimum SDF along each ray's march and the marched distance where it
    occurred: ``(min_s, t_at_min)``, both shape ``(...,)``.

    Hit rays give ``min_s`` near ``epsilon`` (or below); misses their
    closest approach to any surface.  The silhouette quantity:
    ``sigmoid((2ε − min_s)/β)`` is a coverage that moves smoothly with the
    silhouettes.  Not differentiable (the fit step's coverage term
    re-attaches its gradient at ``t_at_min``).  The march is the exact one
    whatever ``cfg.relaxation`` says."""
    shape = _batch(origins, directions)

    def ev(t):
        return sdf_fn(origins + t[..., None] * directions)

    with torch.no_grad():
        return min_sdf_along(ev, shape, cfg, origins.device, origins.dtype)


def min_sdf_along(ev, shape, cfg: MarchConfig, device, dtype=torch.float32):
    """``(min_s, t_at_min)`` of the exact march along rays whose distance at
    ``t`` (a ``shape`` tensor) is ``ev(t)``: before a ray's distance moves,
    a step whose ``s`` is below the ray's minimum so far records ``s`` and
    the distance (JAX's ``ray_min_sdf``; the kernels' ``march_primary``
    tracked form).  ``min_s`` starts at ``+inf`` and ``t_at_min`` at 0; a ray
    stops as in :func:`sphere_trace`."""
    kw = dict(dtype=dtype, device=device)
    dist = torch.zeros(shape, **kw)
    min_s = torch.full(shape, float("inf"), **kw)
    t_min = torch.zeros(shape, **kw)
    active = torch.ones(shape, dtype=torch.bool, device=device)
    for _ in range(cfg.max_steps):
        if not bool(active.any()):
            break
        s = ev(dist)
        better = active & (s < min_s)
        min_s = torch.where(better, s, min_s)
        t_min = torch.where(better, dist, t_min)
        dist = torch.where(active, dist + s, dist)
        active = active & ~((dist > cfg.max_distance) | (s < cfg.epsilon))
    return min_s, t_min


def soft_shadow(
    sdf_fn: SDFFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: ShadowConfig,
    march: MarchConfig,
) -> torch.Tensor:
    """Quilez improved soft shadow; the factor clamped to [0, 1].

    Per step, with the previous and current SDF samples: ``intersection =
    sdf²/(2·prev)`` (0 on the first step), ``d_est = sqrt(sdf² −
    intersection²)``, ``shadow = min(shadow, k·d_est/(distance −
    intersection))``, then ``distance += sdf``; a ray stops when
    ``distance > max_distance or shadow < epsilon``.  A step whose ``d_est``
    is not real or whose denominator is not positive does not darken — the
    explicit ``valid`` predicate, which the reference gets from GPU
    ``min(x, NaN) = x``.
    """
    shape = _batch(origins, directions)
    kw = dict(dtype=origins.dtype, device=origins.device)
    dist = torch.zeros(shape, **kw)
    prev = torch.full(shape, float("inf"), **kw)
    shadow = torch.ones(shape, **kw)
    active = torch.ones(shape, dtype=torch.bool, device=origins.device)
    for i in range(cfg.max_steps):
        if march.early_exit and not bool(active.any()):
            break
        s = sdf_fn(origins + dist[..., None] * directions)
        if i == 0:
            inter = torch.zeros_like(s)
        else:
            inter = s * s / (2.0 * torch.where(prev == 0.0, _TINY, prev))
        inter = torch.clamp(inter, -_INTER_CAP, _INTER_CAP)
        d2 = s * s - inter * inter
        d_est = _SqrtGradSafe.apply(torch.clamp(d2, min=0.0))
        denom = dist - inter
        valid = (denom > 0.0) & (d2 >= 0.0)
        atten = torch.where(valid, cfg.k * d_est / torch.where(valid, denom, 1.0), _NO_DARKEN)
        shadow = torch.where(active, torch.minimum(shadow, atten), shadow)
        dist = torch.where(active, dist + s, dist)
        prev = torch.where(active, s, prev)
        active = active & ~((dist > march.max_distance) | (shadow < march.epsilon))
    return torch.clamp(shadow, 0.0, 1.0)


def ambient_occlusion(sdf_fn: SDFFn, points: torch.Tensor, normals: torch.Tensor, cfg: AOConfig) -> torch.Tensor:
    """N-tap SDF ambient occlusion: ``clamp(1 − strength·Σ falloff^(i−1)·
    (i·step − sdf(p + i·step·n)), 0, 1)``."""
    occ = torch.zeros(points.shape[:-1], dtype=points.dtype, device=points.device)
    weight = 1.0
    for i in range(1, cfg.samples + 1):
        h = cfg.step * i
        occ = occ + weight * (h - sdf_fn(points + h * normals))
        weight *= cfg.falloff
    return torch.clamp(1.0 - cfg.strength * occ, 0.0, 1.0)


def normal_central(sdf_fn: SDFFn, points: torch.Tensor, eps: float) -> torch.Tensor:
    """Central-difference normals: 6 SDF taps at ``±eps`` per axis."""
    offs = torch.eye(3, dtype=points.dtype, device=points.device) * eps
    comps = [sdf_fn(points + offs[a]) - sdf_fn(points - offs[a]) for a in range(3)]
    return vnormalize(torch.stack(comps, dim=-1))


def normal_tetrahedron(sdf_fn: SDFFn, points: torch.Tensor, eps: float) -> torch.Tensor:
    """Tetrahedron-offset normals: 4 SDF taps."""
    k = torch.tensor(
        [[1.0, -1.0, -1.0], [-1.0, -1.0, 1.0], [-1.0, 1.0, -1.0], [1.0, 1.0, 1.0]],
        dtype=points.dtype,
        device=points.device,
    )
    n = sum(k[i] * sdf_fn(points + eps * k[i])[..., None] for i in range(4))
    return vnormalize(n)


def normal_autodiff(sdf_fn: SDFFn, points: torch.Tensor) -> torch.Tensor:
    """Exact normals: the gradient of the distance (``torch.autograd.grad``
    of ``sum(sdf(p))``, the distance being pointwise), normalised.  When the
    caller differentiates (autograd records a graph), the gradient keeps its
    own graph (``create_graph``), so the normals are differentiable too."""
    differentiating = torch.is_grad_enabled()
    with torch.enable_grad():
        p = points if points.requires_grad else points.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sdf_fn(p).sum(), p, create_graph=differentiating)
    return vnormalize(g)


def estimate_normals(sdf_fn: SDFFn, points: torch.Tensor, mode: str, eps: float) -> torch.Tensor:
    """Dispatch on the configured normal scheme."""
    if mode == "central":
        return normal_central(sdf_fn, points, eps)
    if mode == "tetrahedron":
        return normal_tetrahedron(sdf_fn, points, eps)
    if mode == "autodiff":
        return normal_autodiff(sdf_fn, points)
    raise ValueError(f"unknown normals mode: {mode!r}")
