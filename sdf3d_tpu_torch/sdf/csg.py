"""CSG combinators (the port of ``sdf3d_tpu/sdf/csg.py``): the hard union,
intersection and subtraction, and their polynomial smooth variants."""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.sdf.node import SDFNode


class Union(SDFNode):
    """Hard union ``min(a, b)``."""

    fields = ("a", "b")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return torch.minimum(self.a.distance(p), self.b.distance(p))


class Intersection(SDFNode):
    """Hard intersection ``max(a, b)``."""

    fields = ("a", "b")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.a.distance(p), self.b.distance(p))


class Subtraction(SDFNode):
    """Carve ``b`` out of ``a``: ``max(a, -b)``."""

    fields = ("a", "b")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.a.distance(p), -self.b.distance(p))


def _smooth_mix(da: torch.Tensor, db: torch.Tensor, k: torch.Tensor, sign: float) -> torch.Tensor:
    """Quilez polynomial smooth min (``sign = +1``) / smooth max (``-1``)."""
    k = torch.clamp(k, min=1e-6)
    h = torch.clamp(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)
    mixed = db + (da - db) * h
    return mixed - sign * k * h * (1.0 - h)


class SmoothUnion(SDFNode):
    """Polynomial smooth union with blend radius ``k``."""

    fields = ("a", "b", "k")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return _smooth_mix(self.a.distance(p), self.b.distance(p), self.k, +1.0)


class SmoothIntersection(SDFNode):
    """Polynomial smooth intersection with blend radius ``k``."""

    fields = ("a", "b", "k")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return _smooth_mix(self.a.distance(p), self.b.distance(p), self.k, -1.0)


class SmoothSubtraction(SDFNode):
    """Polynomial smooth subtraction (carve ``b`` out of ``a``) with radius ``k``."""

    fields = ("a", "b", "k")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return _smooth_mix(self.a.distance(p), -self.b.distance(p), self.k, -1.0)


def union(*nodes: SDFNode) -> SDFNode:
    """Left-fold hard union of any number of nodes."""
    out = nodes[0]
    for n in nodes[1:]:
        out = Union(a=out, b=n)
    return out


def intersection(*nodes: SDFNode) -> SDFNode:
    """Left-fold hard intersection of any number of nodes."""
    out = nodes[0]
    for n in nodes[1:]:
        out = Intersection(a=out, b=n)
    return out


def subtraction(a: SDFNode, b: SDFNode) -> Subtraction:
    return Subtraction(a=a, b=b)


def smooth_union(a: SDFNode, b: SDFNode, k=0.25) -> SmoothUnion:
    return SmoothUnion(a=a, b=b, k=k)


def smooth_intersection(a: SDFNode, b: SDFNode, k=0.25) -> SmoothIntersection:
    return SmoothIntersection(a=a, b=b, k=k)


def smooth_subtraction(a: SDFNode, b: SDFNode, k=0.25) -> SmoothSubtraction:
    return SmoothSubtraction(a=a, b=b, k=k)
