"""Analytic SDF primitives (the port of ``sdf3d_tpu/sdf/primitives.py``).

The reference's two primitives, the sphere and the ground plane, the
flagship scene's box, rounded box and torus, and the capsule, cylinder and
ellipsoid.  The JAX package's Mandelbulb is not ported yet (ROADMAP item
13c).  A node's fields are its parameters in ``tree_flatten`` order.
"""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.sdf.node import SDFNode, vlength, vlength_safe


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
        ring = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - self.major
        return torch.sqrt(ring**2 + q[..., 1] ** 2) - self.minor


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
