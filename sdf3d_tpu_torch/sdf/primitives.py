"""Analytic SDF primitives (the port of ``sdf3d_tpu/sdf/primitives.py``).

The reference's two primitives, the sphere and the ground plane.  The other
primitives of the JAX package are not ported yet.
"""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.sdf.node import SDFNode, vlength


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


def sphere(center=(0.0, 0.0, 0.0), radius=1.0) -> Sphere:
    return Sphere(center=center, radius=radius)


def plane(normal=(0.0, 1.0, 0.0), offset=0.0) -> Plane:
    return Plane(normal=normal, offset=offset)


def ground_plane() -> Plane:
    """The reference's ground plane ``y = 0``."""
    return plane((0.0, 1.0, 0.0), 0.0)
