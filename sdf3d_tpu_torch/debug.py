"""Debugging and validation (the port of ``sdf3d_tpu/debug.py``).

- :func:`checked_render`: a render that reports the first stage whose
  values went non-finite (NaN or ±inf) instead of passing them on; the
  JAX package's ``checkify`` float checks become explicit checks of each
  stage's output here;
- :func:`finite_params`: every scene leaf is finite;
- :func:`check_lipschitz`: a statistical test that the scene is a metric
  SDF (``|f(a) − f(b)| ≤ ‖a − b‖``), on which sphere tracing depends (a
  non-unit plane normal breaks it);
- :func:`validate_scene`: both static checks;
- :func:`nan_debugging`: ``torch.autograd.set_detect_anomaly`` for the
  context (JAX's ``jax_debug_nans``).

JAX's ``interpret_mode`` (run Pallas kernels in their interpreter) exists
only for the TPU's kernels and has no counterpart: on CPU tensors every
kernel of the port runs its plain PyTorch version.
"""

from __future__ import annotations

import contextlib

import torch

from sdf3d_tpu_torch.camera import Camera, camera_rays
from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.lighting import Material, PointLight
from sdf3d_tpu_torch.march import ambient_occlusion, estimate_normals, soft_shadow, sphere_trace
from sdf3d_tpu_torch.render import shade_pixels
from sdf3d_tpu_torch.sdf.node import SDFNode, vnormalize


class RenderError:
    """The outcome of :func:`checked_render` (the shape of ``checkify``'s
    error): ``get()`` is the message of the first stage that went
    non-finite, or None; ``throw()`` raises ``FloatingPointError`` with it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)

    def __bool__(self) -> bool:
        return self.message is not None

    def __repr__(self) -> str:
        return f"RenderError({self.message!r})"


@torch.no_grad()
def checked_render(scene: SDFNode, camera: Camera, light: PointLight, mat: Material, config: RenderConfig):
    """Render with float checks: ``(error, image)``.  The stages of
    ``render`` run one by one (the scene's parameters, the rays, the march,
    the normals, the shadow, AO, the shading) and ``error`` names the first
    whose output holds a NaN or an infinity, with the count; the image is
    rendered whatever it says.  For debugging new primitives or suspicious
    fits: the checks cost a host sync a stage."""
    stages = []

    def checked(name, *xs):
        if not stages:
            bad = sum(int((~torch.isfinite(x)).sum()) for x in xs)
            if bad:
                stages.append(f"non-finite values ({bad}) at stage {name!r} of the render")
        return xs[0]

    checked("scene parameters", *(p.detach() for p in scene.parameters()))
    origins, directions = camera_rays(camera, config.width, config.height, config.ray_mode)
    checked("rays", origins, directions)
    sdf_fn = scene.distance
    t = checked("march", sphere_trace(sdf_fn, origins, directions, config.march))
    p = origins + t[..., None] * directions
    n = checked("normals", estimate_normals(sdf_fn, p, config.normals, config.march.epsilon))
    if config.shadow.enabled:
        shadow = checked("shadow", soft_shadow(sdf_fn, p + n * (2.0 * config.march.epsilon),
                                               vnormalize(light.position - p), config.shadow, config.march))
    else:
        shadow = torch.ones_like(t)
    ao = checked("ambient occlusion", ambient_occlusion(sdf_fn, p, n, config.ao)) if config.ao.enabled else None
    rgb = checked("shading", shade_pixels(scene, origins, directions, t, light, mat, config, shadow_override=shadow,
                                          ao_override=ao))
    return RenderError(stages[0] if stages else None), rgb


def finite_params(scene: SDFNode) -> bool:
    """True when every numeric leaf of the scene is finite."""
    return all(bool(torch.isfinite(p).all()) for p in scene.parameters())


@torch.no_grad()
def check_lipschitz(scene: SDFNode, generator: torch.Generator | None = None, n_samples: int = 4096,
                    box: float = 3.0, tol: float = 1.01) -> tuple[bool, float]:
    """Sample point pairs and test the 1-Lipschitz bound: ``(ok,
    worst_ratio)`` with ratio ``|f(a) − f(b)| / ‖a − b‖`` (a true SDF keeps
    it at most 1; ``tol`` absorbs rounding).  ``a`` is uniform in
    ``[−box, box]³`` and ``b = a + 0.1·N(0, 1)``, both drawn from
    ``generator`` (by default one seeded with 0) on the device of the
    scene's parameters.  A ratio over 1 means the march can step through a
    surface: normalise plane normals, use bound-correct primitives."""
    device = next(iter(scene.parameters())).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    a = (torch.rand((n_samples, 3), generator=generator, device=device) * 2.0 - 1.0) * box
    b = a + torch.randn((n_samples, 3), generator=generator, device=device) * 0.1
    ratio = (scene.distance(a) - scene.distance(b)).abs() / torch.clamp(torch.linalg.vector_norm(a - b, dim=-1),
                                                                        min=1e-9)
    worst = float(ratio.max())
    return worst <= tol, worst


def validate_scene(scene: SDFNode, strict: bool = False) -> list[str]:
    """Run the static scene checks; a list of warnings (``strict=True``
    raises ``ValueError`` with them instead)."""
    problems = []
    if not finite_params(scene):
        problems.append("scene has non-finite parameters")
    ok, worst = check_lipschitz(scene)
    if not ok:
        problems.append(
            f"scene violates the 1-Lipschitz SDF bound (worst ratio {worst:.3f}); "
            "sphere tracing may overshoot — check plane normals/custom primitives"
        )
    if strict and problems:
        raise ValueError("; ".join(problems))
    return problems


@contextlib.contextmanager
def nan_debugging():
    """Autograd's anomaly detection inside the context: a backward that
    produces a NaN raises with the forward operation that recorded it."""
    with torch.autograd.set_detect_anomaly(True):
        yield
