"""Analytic SDF primitives (the port of ``sdf3d_tpu/sdf/primitives.py``).

The reference's two primitives, the sphere and the ground plane, and the
flagship scene's box, rounded box and torus.  The other primitives of the
JAX package (capsule, cylinder, ellipsoid, Mandelbulb) are not ported yet.
A node's fields are its parameters in ``tree_flatten`` order.
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
