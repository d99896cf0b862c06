"""Analytic SDF primitives (the port of ``sdf3d_tpu/sdf/primitives.py``).

The reference's two primitives, the sphere and the ground plane, the
flagship scene's box, rounded box and torus, the capsule, cylinder and
ellipsoid, and the power-8 Mandelbulb of the fractal scene.  A node's fields
are its parameters in ``tree_flatten`` order.
"""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.sdf.node import SDFNode, sqrt_rn, vlength, vlength_safe


class Sphere(SDFNode):
    """Sphere: ``length(p - center) - radius``."""

    fields = ("center", "radius")  # (3,), ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return vlength(p - self.center) - self.radius


class Plane(SDFNode):
    """Half-space ``dot(normal, p) - offset`` (unit ``normal`` for a true
    distance).  The reference's ground plane is ``Plane((0,1,0), 0)``."""

    fields = ("normal", "offset")  # (3,), ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return torch.sum(p * self.normal, dim=-1) - self.offset


def _box_distance(p: torch.Tensor, center: torch.Tensor, half_extents: torch.Tensor) -> torch.Tensor:
    """Quilez ``sdBox``: ``q = |p - center| - half_extents``,
    ``length(max(q, 0)) + min(max_component(q), 0)``."""
    q = torch.abs(p - center) - half_extents
    outside = vlength_safe(torch.clamp(q, min=0.0))
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside


class Box(SDFNode):
    """Axis-aligned box, exact SDF."""

    fields = ("center", "half_extents")  # (3,), (3,)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return _box_distance(p, self.center, self.half_extents)


class RoundBox(SDFNode):
    """Box with rounded edges: the box SDF minus ``corner_radius``."""

    fields = ("center", "half_extents", "corner_radius")  # (3,), (3,), ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return _box_distance(p, self.center, self.half_extents) - self.corner_radius


class Torus(SDFNode):
    """Torus in the xz-plane: major radius ``major``, tube radius ``minor``."""

    fields = ("center", "major", "minor")  # (3,), (), ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        q = p - self.center
        ring = sqrt_rn(q[..., 0] ** 2 + q[..., 2] ** 2) - self.major
        return sqrt_rn(ring**2 + q[..., 1] ** 2) - self.minor


class Capsule(SDFNode):
    """Capsule between endpoints ``a`` and ``b`` with given ``radius``."""

    fields = ("a", "b", "radius")  # (3,), (3,), ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        pa = p - self.a
        ba = self.b - self.a
        denom = torch.clamp(torch.sum(ba * ba, dim=-1), min=1e-12)
        h = torch.clamp(torch.sum(pa * ba, dim=-1) / denom, 0.0, 1.0)
        return vlength(pa - ba * h[..., None]) - self.radius


class Cylinder(SDFNode):
    """Capped vertical (y-axis) cylinder, exact SDF (Quilez ``sdCappedCylinder``)."""

    fields = ("center", "radius", "half_height")  # (3,), (), ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        q = p - self.center
        radial = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - self.radius
        axial = torch.abs(q[..., 1]) - self.half_height
        outside = vlength_safe(torch.stack([torch.clamp(radial, min=0.0), torch.clamp(axial, min=0.0)], dim=-1))
        inside = torch.clamp(torch.maximum(radial, axial), max=0.0)
        return outside + inside


class Ellipsoid(SDFNode):
    """Ellipsoid, Quilez bound-improved approximation (not exact off-axis)."""

    fields = ("center", "radii")  # (3,), (3,)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        q = p - self.center
        k0 = vlength(q / self.radii)
        k1 = vlength(q / (self.radii * self.radii))
        return k0 * (k0 - 1.0) / torch.clamp(k1, min=1e-12)


def sphere(center=(0.0, 0.0, 0.0), radius=1.0) -> Sphere:
    return Sphere(center=center, radius=radius)


def plane(normal=(0.0, 1.0, 0.0), offset=0.0) -> Plane:
    return Plane(normal=normal, offset=offset)


def ground_plane() -> Plane:
    """The reference's ground plane ``y = 0``."""
    return plane((0.0, 1.0, 0.0), 0.0)


def box(half_extents=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> Box:
    return Box(center=center, half_extents=half_extents)


def round_box(half_extents=(1.0, 1.0, 1.0), corner_radius=0.1, center=(0.0, 0.0, 0.0)) -> RoundBox:
    return RoundBox(center=center, half_extents=half_extents, corner_radius=corner_radius)


def torus(major=1.0, minor=0.25, center=(0.0, 0.0, 0.0)) -> Torus:
    return Torus(center=center, major=major, minor=minor)


def capsule(a=(0.0, 0.0, 0.0), b=(0.0, 1.0, 0.0), radius=0.25) -> Capsule:
    return Capsule(a=a, b=b, radius=radius)


def cylinder(radius=0.5, half_height=0.5, center=(0.0, 0.0, 0.0)) -> Cylinder:
    return Cylinder(center=center, radius=radius, half_height=half_height)


def ellipsoid(radii=(1.0, 0.5, 0.5), center=(0.0, 0.0, 0.0)) -> Ellipsoid:
    return Ellipsoid(center=center, radii=radii)


def mandelbulb_de(qx, qy, qz, iterations: int, m, bailout: float = 4.0):
    """The power-8 Mandelbulb's distance estimate at ``q`` (components), in
    the JAX package's algebra and operation order
    (``sdf3d_tpu/sdf/primitives.py::_mandelbulb_de``): ``iterations``
    unrolled steps of the triplex map ``w <- w^8 + q`` (the angles' sines
    and cosines by three doublings of ``y/rho``, ``k/rho``, ``x/k``,
    ``z/k``), the derivative ``dr <- 8 rho^7 dr + 1``, escaped points frozen
    by 0/1 masks (``where(stay > 0.5, ...)``), then ``max(0.5 *
    0.5 log(rho) rho / dr, |q| - 1.2)`` with every squared norm clamped at
    1e-12.  ``m`` is a backend of the scene compiler (``ops/scene_program.py``:
    tensors, C text or its tape); ``let`` names each value, so the C text
    grows linearly with ``iterations``.

    One term differs from JAX's: ``rho^8 = m²·m²`` is clamped at 2^100.  A
    point that escapes with ``|w|²`` near 2^32 (its ``|w|²`` was within
    rounding of the bailout 16 a step before) makes it overflow, or its
    product with an angle factor that rounding put a hair above 1, in the
    escape selects' untaken branch, whose adjoint, the select's 0, times inf
    is NaN in JAX's reverse mode; such points sit near every iteration's
    escape boundary, so at 1920×1080 a fit step's gradient totals met one.
    The clamp changes no value a select takes (a kept ``m`` is at most 16, so
    ``rho^8`` at most 65536) and so no distance or gradient where JAX's is
    finite (ROADMAP Queue 3)."""
    eps = 1e-12
    b2 = bailout * bailout
    big = 2.0 ** 100
    wx, wy, wz = qx, qy, qz
    dr = 1.0
    r_kept = eps
    active = None  # all ones before the first step: JAX's ones_like
    for it in range(iterations):
        mm = m.let(m.maximum(wx * wx + wy * wy + wz * wz, eps))
        r = m.let(m.sqrt(mm))
        # The radius at the top of the step counts on the escaping step too.
        inside = m.where(m.greater(mm, b2), 0.0, 1.0)
        if active is None:
            r_kept, stay = r, m.let(inside)
        else:
            r_kept = m.let(m.where(m.greater(active, 0.5), r, r_kept))
            stay = m.let(active * inside)
        go = m.greater(stay, 0.5)
        m2 = m.let(mm * mm)
        dr = m.let(m.where(go, 8.0 * (m2 * mm) * r * dr + 1.0, dr))
        active = stay
        if it == iterations - 1:
            break  # the last step's w is never read (no named value left unused)
        inv_r = m.let(m.rsqrt(mm))
        k2 = m.let(m.maximum(wx * wx + wz * wz, eps))
        inv_k = m.let(m.rsqrt(k2))
        ct, st = m.let(wy * inv_r), m.let(m.sqrt(k2) * inv_r)
        cp, sp = m.let(wx * inv_k), m.let(wz * inv_k)
        for _dbl in range(3):
            ct, st = m.let(ct * ct - st * st), m.let(2.0 * ct * st)
            cp, sp = m.let(cp * cp - sp * sp), m.let(2.0 * cp * sp)
        r8 = m.let(m.minimum(m2 * m2, big))
        wx = m.let(m.where(go, r8 * st * cp + qx, wx))
        wy = m.let(m.where(go, r8 * ct + qy, wy))
        wz = m.let(m.where(go, r8 * st * sp + qz, wz))
    est = m.let(0.5 * m.log(r_kept) * r_kept / dr)
    d_bound = m.let(m.sqrt(m.maximum(qx * qx + qy * qy + qz * qz, eps)) - 1.2)
    return m.maximum(0.5 * est, d_bound)


class Mandelbulb(SDFNode):
    """Power-8 Mandelbulb fractal (an escape-time distance estimate, sphere-
    trace safe).  No reference counterpart: the JAX package's
    eval-dominated scene node (about 300 operations an evaluation).
    ``center`` and ``scale`` are parameters; ``iterations`` is static (a
    different unroll is another generated kernel)."""

    fields = ("center", "scale", "iterations")  # (3,), (), static int
    static = ("iterations",)
    defaults = {"iterations": 6}

    @property
    def scale(self):
        # The field shadows SDFNode.scale (the transform sugar), as the JAX
        # dataclass field shadows the method there.
        try:
            return self._parameters["scale"]
        except KeyError:
            raise AttributeError("scale") from None

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        from sdf3d_tpu_torch.ops.scene_program import _TorchOps

        q = (p - self.center) / self.scale
        d = mandelbulb_de(q[..., 0], q[..., 1], q[..., 2], int(self.iterations), _TorchOps)
        return d * self.scale


def mandelbulb(center=(0.0, 0.0, 0.0), scale=1.0, iterations=6) -> Mandelbulb:
    return Mandelbulb(center=center, scale=scale, iterations=int(iterations))
