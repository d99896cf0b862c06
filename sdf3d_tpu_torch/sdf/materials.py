"""Per-object materials on the SDF scene graph (the port of
``sdf3d_tpu/sdf/materials.py``).

:class:`Shaded` tags a subtree with its own :class:`Material`: it is
transparent to the distance (a march never sees it), and its material's
fields are parameters of the scene like the shapes', so a fit can recover
per-object colours.  :func:`material_at` resolves the material at query
points by folding over the CSG tree: hard operations select the winning
side's material (``<=`` for a union, ``>=`` for an intersection: a tie takes
``a``'s), smooth operations blend the two with the smooth-min's own ``h``
weight, a subtraction keeps ``a``'s material (the carve shows ``a``'s
inside), and every transform passes the material through.  Subtrees without
a tag take the render call's material; a scene without tags skips the fold.

This is the reference form over points; the kernels run the same semantics
through the scene compiler's material program
(``ops/scene_program.py::compile_scene_material``), evaluated once a pixel at
the hit point.  A ``Shaded`` node's parameters follow its child's in the
flat parameter vector: ambient rgb, diffuse rgb, specular rgb, shininess.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sdf3d_tpu_torch.lighting import Material, material
from sdf3d_tpu_torch.sdf import csg, transforms
from sdf3d_tpu_torch.sdf.node import SDFNode, as_f32, mat_vec


class Shaded(SDFNode):
    """Tag a subtree with its own material; distance-transparent.  The
    material's four fields are parameters of the node (``material`` returns
    them as a :class:`Material`)."""

    fields = ("child", "material")

    def __init__(self, child: SDFNode, material: Material):
        nn.Module.__init__(self)
        self.child = child
        for f in dataclasses.fields(Material):
            setattr(self, f.name, nn.Parameter(as_f32(getattr(material, f.name))))

    @property
    def material(self) -> Material:
        return Material(*(getattr(self, f.name) for f in dataclasses.fields(Material)))

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return self.child.distance(p)


def shaded(child: SDFNode, mat: Material | None = None, **mat_kwargs) -> Shaded:
    """Wrap ``child`` with a material: a :class:`Material`, or
    ``material(...)``'s keyword arguments (e.g. ``diffuse=(1, 0, 0)``), which
    also override the fields of ``mat`` when both are given."""
    if mat is None:
        mat = material(**mat_kwargs)
    elif mat_kwargs:
        mat = dataclasses.replace(mat, **{k: as_f32(v) for k, v in mat_kwargs.items()})
    return Shaded(child=child, material=mat)


def scene_has_materials(scene: SDFNode) -> bool:
    """True when a :class:`Shaded` node appears anywhere in the tree."""
    if isinstance(scene, Shaded):
        return True
    return any(isinstance(getattr(scene, f), SDFNode) and scene_has_materials(getattr(scene, f))
               for f in scene.fields)


def _bcast(mat: Material, shape) -> Material:
    """A scalar material as per-point planes of ``shape``."""
    return Material(*(mat_field.expand(shape + mat_field.shape) for mat_field in
                      (mat.ambient, mat.diffuse, mat.specular, mat.shininess)))


def _select(cond: torch.Tensor, ma: Material, mb: Material) -> Material:
    c3 = cond[..., None]
    return Material(torch.where(c3, ma.ambient, mb.ambient), torch.where(c3, ma.diffuse, mb.diffuse),
                    torch.where(c3, ma.specular, mb.specular), torch.where(cond, ma.shininess, mb.shininess))


def _lerp(h: torch.Tensor, ma: Material, mb: Material) -> Material:
    """``h = 1`` gives ``ma``: the smooth-min's mix ``db + (da − db)·h``."""
    h3 = h[..., None]
    return Material(mb.ambient + (ma.ambient - mb.ambient) * h3, mb.diffuse + (ma.diffuse - mb.diffuse) * h3,
                    mb.specular + (ma.specular - mb.specular) * h3,
                    mb.shininess + (ma.shininess - mb.shininess) * h)


def _smooth_h(da, db, k, sign: float):
    """The smooth mix's weight ``h`` (``csg._smooth_mix``'s)."""
    k = torch.clamp(k, min=1e-6)
    return torch.clamp(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)


def _fold(node: SDFNode, p: torch.Tensor, default: Material):
    """``(distance, material planes)`` at the points ``p`` (..., 3)."""
    shape = p.shape[:-1]
    if not scene_has_materials(node):
        return node.distance(p), _bcast(default, shape)
    if isinstance(node, Shaded):
        # The tag replaces the default for its subtree; a tag deeper down
        # replaces it again.
        return _fold(node.child, p, node.material)
    if isinstance(node, (csg.Union, csg.Intersection)):
        da, ma = _fold(node.a, p, default)
        db, mb = _fold(node.b, p, default)
        if isinstance(node, csg.Union):
            return torch.minimum(da, db), _select(da <= db, ma, mb)
        return torch.maximum(da, db), _select(da >= db, ma, mb)
    if isinstance(node, csg.Subtraction):
        da, ma = _fold(node.a, p, default)
        return torch.maximum(da, -node.b.distance(p)), ma
    if isinstance(node, (csg.SmoothUnion, csg.SmoothIntersection)):
        sign = 1.0 if isinstance(node, csg.SmoothUnion) else -1.0
        da, ma = _fold(node.a, p, default)
        db, mb = _fold(node.b, p, default)
        return csg._smooth_mix(da, db, node.k, sign), _lerp(_smooth_h(da, db, node.k, sign), ma, mb)
    if isinstance(node, csg.SmoothSubtraction):
        da, ma = _fold(node.a, p, default)
        return csg._smooth_mix(da, -node.b.distance(p), node.k, -1.0), ma
    if isinstance(node, transforms.Translate):
        return _fold(node.child, p - node.offset, default)
    if isinstance(node, transforms.Rotate):
        return _fold(node.child, mat_vec(transforms.rotvec_to_matrix(node.rotvec).T, p), default)
    if isinstance(node, transforms.Scale):
        s = torch.clamp(node.factor, min=1e-12)
        d, m = _fold(node.child, p / s, default)
        return d * s, m
    if isinstance(node, transforms.Round):
        d, m = _fold(node.child, p, default)
        return d - node.radius, m
    if isinstance(node, transforms.Onion):
        d, m = _fold(node.child, p, default)
        return torch.abs(d) - node.thickness, m
    if isinstance(node, transforms.Elongate):
        return _fold(node.child, p - torch.clamp(p, -node.amount, node.amount), default)
    if isinstance(node, transforms.RepeatInfinite):
        period = node.period
        on = period > 0.0
        q = torch.where(on, p - period * torch.round(p / torch.where(on, period, torch.ones_like(period))), p)
        return _fold(node.child, q, default)
    raise TypeError(f"the material fold does not know node {type(node).__name__} "
                    "(sdf3d_tpu_torch/sdf/materials.py::_fold)")


def material_at(scene: SDFNode, p: torch.Tensor, default: Material) -> Material:
    """The material governing each query point of ``p`` (..., 3): a
    :class:`Material` of per-point planes ((..., 3) colours, (...,)
    shininess), differentiable in every material and shape parameter of the
    tree; ``default`` serves the untagged subtrees."""
    return _fold(scene, p, default)[1]
