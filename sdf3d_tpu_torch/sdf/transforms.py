"""Spatial and shape transforms over SDF nodes (the port of
``sdf3d_tpu/sdf/transforms.py``): translate, rotate (axis-angle), uniform
scale, rounding, shelling, elongation and infinite repetition, each
differentiable in its parameters.  A node's fields are its child, then its
parameters (``tree_flatten`` order)."""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.sdf.node import SDFNode, mat_vec


def rotvec_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector → 3×3 rotation matrix (Rodrigues), differentiable.

    Uses the series-safe form near zero angle so gradients are finite at
    ``rotvec = 0``: the exact branch is evaluated at a safe θ there (a
    double ``where``).  ``K²`` is written out entry by entry, not as a
    matrix product, which may run in reduced precision on the card."""
    theta2 = torch.sum(rotvec * rotvec)
    small = theta2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    wx, wy, wz = rotvec[0], rotvec[1], rotvec[2]
    zero = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zero, -wz, wy]), torch.stack([wz, zero, -wx]), torch.stack([-wy, wx, zero])])
    KK = torch.stack([
        torch.stack([-(wy * wy + wz * wz), wx * wy, wx * wz]),
        torch.stack([wx * wy, -(wx * wx + wz * wz), wy * wz]),
        torch.stack([wx * wz, wy * wz, -(wx * wx + wy * wy)]),
    ])
    return torch.eye(3, dtype=rotvec.dtype, device=rotvec.device) + sinc * K + cosc * KK


class Translate(SDFNode):
    """Translate the child by ``offset``: ``d(p) = child(p - offset)``."""

    fields = ("child", "offset")  # node, (3,)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return self.child.distance(p - self.offset)


class Rotate(SDFNode):
    """Rotate the child about the origin by axis-angle ``rotvec``: the child
    is evaluated at ``R⁻¹ p = Rᵀ p``."""

    fields = ("child", "rotvec")  # node, (3,)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return self.child.distance(mat_vec(rotvec_to_matrix(self.rotvec).T, p))


class Scale(SDFNode):
    """Uniform scale: ``d(p) = child(p / s) * s`` (keeps the field metric)."""

    fields = ("child", "factor")  # node, ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        s = torch.clamp(self.factor, min=1e-12)
        return self.child.distance(p / s) * s


class Round(SDFNode):
    """Round all edges of the child by ``radius`` (subtract radius)."""

    fields = ("child", "radius")  # node, ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return self.child.distance(p) - self.radius


class Onion(SDFNode):
    """Hollow the child into a shell of given ``thickness``: ``|d| - t``."""

    fields = ("child", "thickness")  # node, ()

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return torch.abs(self.child.distance(p)) - self.thickness


class Elongate(SDFNode):
    """Stretch the child along each axis by clamping the query point."""

    fields = ("child", "amount")  # node, (3,)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return self.child.distance(p - torch.clamp(p, -self.amount, self.amount))


class RepeatInfinite(SDFNode):
    """Infinite lattice repetition with per-axis ``period`` (0 disables an
    axis); exact only when the child fits within half a period.  The fold
    rounds half to even (``torch.round``, as ``jnp.round``)."""

    fields = ("child", "period")  # node, (3,)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        period = self.period
        on = period > 0.0
        q = torch.where(on, p - period * torch.round(p / torch.where(on, period, torch.ones_like(period))), p)
        return self.child.distance(q)


def translate(child: SDFNode, offset) -> Translate:
    return Translate(child=child, offset=offset)


def rotate(child: SDFNode, rotvec) -> Rotate:
    return Rotate(child=child, rotvec=rotvec)


def scale(child: SDFNode, factor) -> Scale:
    return Scale(child=child, factor=factor)


def round_edges(child: SDFNode, radius) -> Round:
    return Round(child=child, radius=radius)


def onion(child: SDFNode, thickness) -> Onion:
    return Onion(child=child, thickness=thickness)


def elongate(child: SDFNode, amount) -> Elongate:
    return Elongate(child=child, amount=amount)


def repeat_infinite(child: SDFNode, period) -> RepeatInfinite:
    return RepeatInfinite(child=child, period=period)
