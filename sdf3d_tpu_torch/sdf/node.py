"""Base machinery for SDF scene graphs (the port of ``sdf3d_tpu/sdf/node.py``).

A scene is a tree of ``nn.Module`` nodes.  Each node class names its fields
in ``fields`` (the JAX dataclass field order); a field is a child node (a
submodule), a float32 ``nn.Parameter``, one of the class's ``tuples``
fields, a tuple of parameters (an ``nn.ParameterList``, e.g. an MLP's
weights), or one of its ``static`` fields, a plain Python value that is no
parameter (the JAX package's ``pytree_node=False``).  The flat parameter vector walks the fields
in that order (``ops/scene_program.py::scene_param_vector``), which is the JAX
package's ``tree_flatten`` order — not ``nn.Module.parameters()``, which lists
a node's own parameters before its children's.

``distance(p)`` takes points of shape ``(..., 3)`` and returns ``(...,)``.
``translate``, ``rotate``, ``scale``, ``round``, ``shell`` and
``smooth_union`` wrap a node in a transform or a smooth union, as the JAX
package's methods do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


def as_f32(x, device=None) -> torch.Tensor:
    """Coerce Python scalars, lists, numpy arrays or tensors to a float32
    tensor (detached; on ``device`` when given)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def tensors_to(obj, device):
    """A copy of a dataclass of tensors with every field on ``device``."""
    return type(obj)(*(as_f32(getattr(obj, f.name), device) for f in dataclasses.fields(obj)))


class _Sqrt(torch.autograd.Function):
    """The square root of :func:`sqrt_rn` with lax's derivative ``g·(0.5/r)``
    (the generated reverse pass's ``g * (0.5f / v)``; torch's own is
    ``g/(2r)``, one rounding apart)."""

    @staticmethod
    def forward(ctx, x):
        r = torch.sqrt(x.double()).to(x.dtype) if x.dtype == torch.float32 else torch.sqrt(x)
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return g * (0.5 / r)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root rounded to nearest, as IEEE ``sqrtf`` on the
    card and in the host build: taken in float64 and rounded once (a
    float64 square root of a float32 value rounds to the float32 one
    correctly).  torch's float32 ``sqrt`` on the CPU is not correctly
    rounded: its vectorised kernel missed by one ulp on about 20% of
    uniform inputs in [0, 1), and which values it misses depends on the
    machine (``tests/test_torch_render_modes.py`` holds the two)."""
    return _Sqrt.apply(x)


def vlength(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (GLSL ``length``)."""
    return sqrt_rn(torch.sum(v * v, dim=-1))


def vlength_safe(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis with a zero gradient at ``v = 0``.

    ``sqrt(sum(v²))`` has a ``0·inf = NaN`` gradient at the origin, which a
    box's clamped outside vector is at every interior point; the double
    ``where`` guards both branches of the derivative."""
    sq = torch.sum(v * v, dim=-1)
    positive = sq > 0.0
    return torch.where(positive, sqrt_rn(torch.where(positive, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def vnormalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit vector over the last axis, safe at zero (GLSL ``normalize``)."""
    return v / torch.clamp(vlength(v), min=eps)[..., None]


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (GLSL ``dot``)."""
    return torch.sum(a * b, dim=-1)


def mat_vec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a (3,3) (or (4,4)) matrix to vectors ``v`` of shape (..., N).

    An elementwise broadcast multiply and sum, not ``torch.matmul``: a matrix
    product may run in reduced precision (TF32 on the card), which costs
    about three decimal digits on every ray direction (``docs/parity.md``).
    """
    return torch.sum(M * v[..., None, :], dim=-1)


class SDFNode(nn.Module):
    """Base of every scene node.

    Subclasses set ``fields``, and ``tuples``, ``static`` and ``defaults``
    where they have such fields or defaults; the constructor takes the
    fields positionally or by name.  Child nodes become submodules, static
    fields plain attributes, tuple fields an ``nn.ParameterList``, everything
    else a float32 ``nn.Parameter``.  ``a | b`` is the hard union, ``a & b``
    the intersection and ``a - b`` the subtraction; the transform methods
    below wrap the node.
    """

    fields: tuple[str, ...] = ()
    tuples: tuple[str, ...] = ()
    static: tuple[str, ...] = ()
    defaults: dict = {}

    def __init__(self, *args, **kwargs):
        super().__init__()
        if len(args) > len(self.fields):
            raise TypeError(f"{type(self).__name__} takes fields {self.fields}")
        values = dict(zip(self.fields, args))
        for name, value in kwargs.items():
            if name not in self.fields or name in values:
                raise TypeError(f"{type(self).__name__}: unexpected or repeated field {name!r}")
            values[name] = value
        values = {**self.defaults, **values}
        missing = [f for f in self.fields if f not in values]
        if missing:
            raise TypeError(f"{type(self).__name__}: missing fields {missing}")
        for name in self.fields:
            value = values[name]
            if isinstance(value, SDFNode) or name in self.static:
                setattr(self, name, value)
            elif name in self.tuples:
                setattr(self, name, nn.ParameterList([nn.Parameter(as_f32(v)) for v in value]))
            else:
                setattr(self, name, nn.Parameter(as_f32(value)))

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        """Signed distance from points ``p`` of shape ``(..., 3)``."""
        raise NotImplementedError

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        return self.distance(p)

    def __or__(self, other: "SDFNode") -> "SDFNode":
        from sdf3d_tpu_torch.sdf.csg import Union

        return Union(self, other)

    def __and__(self, other: "SDFNode") -> "SDFNode":
        from sdf3d_tpu_torch.sdf.csg import Intersection

        return Intersection(self, other)

    def __sub__(self, other: "SDFNode") -> "SDFNode":
        from sdf3d_tpu_torch.sdf.csg import Subtraction

        return Subtraction(self, other)

    # --- transform sugar (JAX's SDFNode methods) ---------------------------
    def translate(self, offset) -> "SDFNode":
        from sdf3d_tpu_torch.sdf.transforms import Translate

        return Translate(self, offset)

    def rotate(self, rotvec) -> "SDFNode":
        from sdf3d_tpu_torch.sdf.transforms import Rotate

        return Rotate(self, rotvec)

    def scale(self, factor) -> "SDFNode":
        from sdf3d_tpu_torch.sdf.transforms import Scale

        return Scale(self, factor)

    def round(self, radius) -> "SDFNode":
        from sdf3d_tpu_torch.sdf.transforms import Round

        return Round(self, radius)

    def shell(self, thickness) -> "SDFNode":
        from sdf3d_tpu_torch.sdf.transforms import Onion

        return Onion(self, thickness)

    def smooth_union(self, other: "SDFNode", k) -> "SDFNode":
        from sdf3d_tpu_torch.sdf.csg import SmoothUnion

        return SmoothUnion(self, other, k)

    def extra_repr(self) -> str:
        return ", ".join(self.fields)
