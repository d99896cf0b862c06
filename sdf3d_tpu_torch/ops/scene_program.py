"""Scene compiler (the port of ``sdf3d_tpu/ops/scene_program.py``).

One tree walk over the scene emits its distance function in two backends
from the same emitter code, so parameter offsets cannot drift between them:

- **torch**: :func:`compile_scene` returns ``soa(px, py, pz, getp)`` over
  component planes, and :func:`compile_scene_ray` returns
  ``setup(o, d, getp) -> eval(t)`` — the evaluators of the plain PyTorch
  version of the render kernel and of the CPU tests;
- **CUDA**: :func:`cuda_scene_source` runs the same emitters on symbolic C
  expressions and writes the header that the render kernel
  (``csrc/render_kernel.cu``) is compiled with: a point-form
  ``Scene::sdf(px, py, pz, p)``, a ray form ``Scene::Ray`` whose ``setup``
  hoists the per-ray constants out of the march loop and whose ``eval(t)``
  is the per-step work, the AO taps, and the static settings as
  ``constexpr`` (``struct Cfg``); for the backward kernels the reverse mode
  of the point form (``Scene::sdf_bwd``, ``sdf_grad_p``, ``ao_bwd``), which
  the same emitters produce on a tape of symbolic values, and the fit
  kernel's static settings (``struct Fit``).

Parameters are read through ``getp(i)``: an element of the flat parameter
vector in torch, ``p[i]`` (a register copy of a run-time device array) in
CUDA, so a parameter change never rebuilds the kernel.  Offsets follow the
JAX ``tree_flatten`` order: ``Union(a, b)`` consumes ``a``'s parameters,
then ``b``'s.

Emitters keep the JAX emitters' algebra and operation order: plane
``a·t + b``; sphere in completed-square form ``A·sqrt((t+B)² + C) − r`` with
``C`` clamped ≥ 0 at setup; box and rounded box ``|a + t·d| − h`` per axis;
torus, cylinder and ellipsoid quadratics in ``t`` under their square roots;
capsule the clipped projection ``h(t)``, affine in ``t`` before the clip;
hard CSG as min/max (subtraction ``max(a, −b)``), smooth CSG as the
polynomial mix with ``k`` clamped to ``1e-6``; ``Translate``, ``Rotate``
(Rodrigues on scalars, ``R·q`` written out) and ``Scale`` fold into the
ray's origin and direction at setup; ``Elongate`` and ``RepeatInfinite``
have no ray form and evaluate the point form at ``o + t·d`` per step (JAX's
``_ray_fallback``), as does the ``Mandelbulb`` (its six iterations unrolled,
every intermediate named).  Every binary operation is parenthesised in the C text,
so the compiler keeps the same association (it may still contract ``a*b +
c`` into one FMA).  A run-time parameter decides ``Rotate``'s series branch
(``|w|² < 1e-8``) and ``RepeatInfinite``'s disabled axes (``period > 0``):
they stay selects of the generated code, which never depends on a value.

Derivatives follow lax's rules in every backend, at ties too: ``min`` and
``max`` split the adjoint 0.5/0.5 (a constant operand included), ``abs``
passes ``+g`` at ``x ≥ 0`` and ``−g`` below, ``clip`` is
``min(hi, max(lo, x))``, ``sin``/``cos`` give ``cos``/``−sin``, ``log``
gives ``g/x`` and ``rsqrt`` (``1/sqrt``, no approximate ``rsqrtf``)
``g·(−0.5·r/x)``, ``round``
(to nearest, ties to even: ``rintf``) and the comparisons give none, and
``select(c, a, b)`` sends the adjoint to the chosen operand as a select, a
true 0 to the other.  The torch backend carries them under
``torch.autograd`` (the plain versions differentiate it), the tape in the
generated reverse pass.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable

import numpy as np
import torch

from sdf3d_tpu_torch.sdf import csg, primitives, transforms
from sdf3d_tpu_torch.sdf.neural import NeuralSDF
from sdf3d_tpu_torch.sdf.node import SDFNode, sqrt_rn

GetP = Callable[[int], object]


def leaves(node: SDFNode):
    """Every numeric leaf of the scene, in ``tree_flatten`` order (fields in
    declaration order, depth first; a tuple field's items in order; static
    fields are no leaves)."""
    for name in node.fields:
        v = getattr(node, name)
        if isinstance(v, SDFNode):
            yield from leaves(v)
        elif name in node.tuples:
            yield from v
        elif name not in node.static:
            yield v


def scene_param_vector(scene: SDFNode, device=None, detach: bool = True) -> torch.Tensor:
    """All leaves flattened into one (P,) float32 vector, in the order the
    emitters consume them.  ``detach=False`` keeps the autograd graph, so a
    gradient of the vector reaches the scene's ``nn.Parameter``s (the
    counterpart of ``jax.vjp(scene_param_vector)``)."""
    parts = [l.reshape(-1).to(torch.float32) for l in leaves(scene)]
    if not parts:
        return torch.zeros(0, dtype=torch.float32, device=device)
    vec = torch.cat(parts)
    if detach:
        vec = vec.detach()
    return vec.to(device) if device is not None else vec


def count_params(node: SDFNode) -> int:
    """Number of scalar parameters in a subtree."""
    return sum(int(l.numel()) for l in leaves(node))


def walk_nodes(node: SDFNode):
    yield node
    for name in node.fields:
        v = getattr(node, name)
        if isinstance(v, SDFNode):
            yield from walk_nodes(v)


# ---------------------------------------------------------------------------
# Backends: the math the emitters call besides + - * /.
# ---------------------------------------------------------------------------


def _reduce_to(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``g`` summed over the dimensions ``like`` was broadcast along."""
    if g.shape == like.shape:
        return g
    return g.sum_to_size(like.shape) if like.dim() else g.sum()


class _LaxMinMax(torch.autograd.Function):
    """``max(a, b)`` (``sign = +1``) or ``min(a, b)`` (``-1``) with lax's
    derivative: the adjoint times 1, 0.5 at an exact tie, or 0, multiplied
    in, so a NaN adjoint stays NaN on both operands as in ``jax.vjp``
    (``torch.maximum`` masks it to 0 on the operand not taken, and
    ``torch.clamp`` gives a constant's tie wholly to the tensor)."""

    @staticmethod
    def forward(ctx, a, b, sign):
        ctx.save_for_backward(a, b)
        ctx.sign = sign
        return torch.maximum(a, b) if sign > 0 else torch.minimum(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        wins = (a > b) if ctx.sign > 0 else (a < b)
        w = wins.to(g.dtype) + 0.5 * (a == b).to(g.dtype)
        ga = _reduce_to(g * w, a) if ctx.needs_input_grad[0] else None
        gb = _reduce_to(g * (1.0 - w), b) if ctx.needs_input_grad[1] else None
        return ga, gb, None


def _lax_minmax(a, b, sign: float):
    if not isinstance(a, torch.Tensor):
        a = b.new_tensor(a)
    if not isinstance(b, torch.Tensor):
        b = a.new_tensor(b)
    return _LaxMinMax.apply(a, b, sign)


class _Rsqrt(torch.autograd.Function):
    """``1/sqrt(x)`` (the kernels' form: no approximate ``rsqrtf``) with
    lax's derivative of ``rsqrt``, ``g·(−0.5·(r/x))``."""

    @staticmethod
    def forward(ctx, x):
        r = 1.0 / sqrt_rn(x)
        ctx.save_for_backward(x, r)
        return r

    @staticmethod
    def backward(ctx, g):
        x, r = ctx.saved_tensors
        return g * (-0.5 * (r / x))


class _TorchOps:
    """Numeric backend: tensors (planes or 0-d parameters), with lax's
    derivatives under ``torch.autograd``."""

    @staticmethod
    def sqrt(x):
        return sqrt_rn(x)

    @staticmethod
    def rsqrt(x):
        return _Rsqrt.apply(x)

    @staticmethod
    def log(x):
        # lax's derivative, g / x, as torch.log's.
        return torch.log(x)

    @staticmethod
    def maximum(a, b):
        return _lax_minmax(a, b, 1.0)

    @staticmethod
    def minimum(a, b):
        return _lax_minmax(a, b, -1.0)

    @staticmethod
    def abs(x):
        # torch.abs has derivative 0 at 0; lax's is +1 (x >= 0).
        return torch.where(x >= 0, x, -x)

    @staticmethod
    def clip(x, lo, hi):
        return _TorchOps.minimum(hi, _TorchOps.maximum(lo, x))

    @staticmethod
    def sin(x):
        return torch.sin(x)

    @staticmethod
    def cos(x):
        return torch.cos(x)

    @staticmethod
    def round(x):
        # Half to even, derivative 0 (as lax.round's).
        return torch.round(x)

    @staticmethod
    def less(a, b):
        return a < b

    @staticmethod
    def greater(a, b):
        return a > b

    @staticmethod
    def where(c, a, b):
        # torch.where's adjoint is a select: a true 0 to the operand not taken.
        return torch.where(c, a, b)

    @staticmethod
    def hoist(x):
        return x

    @staticmethod
    def let(x):
        return x


def c_float(x) -> str:
    """A float32 C literal for ``x`` (its float32 rounding, exactly)."""
    v = float(np.float32(x))
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return repr(v) + "f"


class CExpr:
    """A float expression in C, built by Python arithmetic; every binary
    operation is parenthesised so the association is the Python one."""

    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s

    def _bin(self, op, other, reflected=False):
        a, b = (_c(other), self.s) if reflected else (self.s, _c(other))
        return CExpr(f"({a} {op} {b})")

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, True)

    def __neg__(self):
        return CExpr(f"(-({self.s}))")


def _c(x) -> str:
    return x.s if isinstance(x, CExpr) else c_float(x)


class _COps:
    """Symbolic backend: C expressions.  ``hoist`` turns a per-ray setup
    value of the ray form into a field of ``Scene::Ray`` assigned in
    ``setup`` (one field per distinct expression).  ``let`` names a value
    the expression would otherwise repeat (a rotation's entries and rotated
    point, a smooth combination's operands): in the ray form's setup a
    field like ``hoist``; in a function body (``in_eval``: the ray form's
    step, the point form) a ``const float`` of the body (``lets``), one per
    distinct expression; ``body`` is then the statements and the
    ``return``.  A scene without such values gives the one ``return``
    line."""

    def __init__(self, in_eval: bool = False):
        self.fields: list[str] = []
        self.setup: list[str] = []
        self._hoisted: dict[str, str] = {}
        self.in_eval = in_eval
        self.lets: list[str] = []
        self._named: dict[str, str] = {}

    @staticmethod
    def sqrt(x):
        return CExpr(f"sqrtf({_c(x)})")

    @staticmethod
    def rsqrt(x):
        # 1/sqrtf: no approximate rsqrtf on a parity path (ROADMAP Queue 3).
        return CExpr(f"(1.0f / sqrtf({_c(x)}))")

    @staticmethod
    def log(x):
        # The accurate logf, not __logf.
        return CExpr(f"logf({_c(x)})")

    @staticmethod
    def maximum(a, b):
        return CExpr(f"fmaxf({_c(a)}, {_c(b)})")

    @staticmethod
    def minimum(a, b):
        return CExpr(f"fminf({_c(a)}, {_c(b)})")

    @staticmethod
    def abs(x):
        return CExpr(f"fabsf({_c(x)})")

    @staticmethod
    def clip(x, lo, hi):
        return CExpr(f"fminf({_c(hi)}, fmaxf({_c(lo)}, {_c(x)}))")

    @staticmethod
    def sin(x):
        return CExpr(f"sinf({_c(x)})")

    @staticmethod
    def cos(x):
        return CExpr(f"cosf({_c(x)})")

    @staticmethod
    def round(x):
        # rintf rounds half to even in the default rounding mode, as
        # jnp.round; roundf would round half away from zero.
        return CExpr(f"rintf({_c(x)})")

    @staticmethod
    def less(a, b):
        return CExpr(f"({_c(a)} < {_c(b)})")

    @staticmethod
    def greater(a, b):
        return CExpr(f"({_c(a)} > {_c(b)})")

    @staticmethod
    def where(c, a, b):
        return CExpr(f"sdf3d::select({_c(c)}, {_c(a)}, {_c(b)})")

    def hoist(self, x):
        expr = _c(x)
        if expr not in self._hoisted:
            name = f"h{len(self.fields)}"
            self.fields.append(name)
            self.setup.append(f"{name} = {expr};")
            self._hoisted[expr] = name
        return CExpr(self._hoisted[expr])

    def let(self, x):
        if not self.in_eval:
            return self.hoist(x)
        expr = _c(x)
        if expr not in self._named:
            name = f"e{len(self.lets)}"
            self.lets.append(f"const float {name} = {expr};")
            self._named[expr] = name
        return CExpr(self._named[expr])

    def body(self, value, indent: str = "    ") -> str:
        return "\n".join(indent + s for s in self.lets + [f"return {_c(value)};"])


def _c_point_body(scene: SDFNode, indent: str = "    ") -> str:
    """The body of ``Scene::sdf(px, py, pz, p)`` for ``scene``."""
    P = lambda i: CExpr(f"p[{i}]")  # noqa: E731
    pt = _COps(in_eval=True)
    return pt.body(_emit(scene, CExpr("px"), CExpr("py"), CExpr("pz"), P, 0, pt), indent)


# ---------------------------------------------------------------------------
# Point-form emitters: (node, px, py, pz, getp, off, m) -> distance.
# ---------------------------------------------------------------------------


def _len3(x, y, z, m):
    return m.sqrt(x * x + y * y + z * z)


def _len2(x, y, m):
    return m.sqrt(x * x + y * y)


def _smooth_mix(da, db, k, sign: float, m):
    """Quilez polynomial smooth min (``sign = +1``) / max (``-1``) with
    ``k`` already clamped to ``max(k, 1e-6)``; ``0.5 * sign`` folds to one
    constant, as in the JAX emitter."""
    h = m.clip(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)
    return db + (da - db) * h - sign * k * h * (1.0 - h)


def _sphere(n, px, py, pz, getp, off, m):
    cx, cy, cz, r = (getp(off + i) for i in range(4))
    return _len3(px - cx, py - cy, pz - cz, m) - r


def _plane(n, px, py, pz, getp, off, m):
    nx, ny, nz, d = (getp(off + i) for i in range(4))
    return px * nx + py * ny + pz * nz - d


def _box_core(px, py, pz, cx, cy, cz, hx, hy, hz, m):
    qx = m.abs(px - cx) - hx
    qy = m.abs(py - cy) - hy
    qz = m.abs(pz - cz) - hz
    ox = m.maximum(qx, 0.0)
    oy = m.maximum(qy, 0.0)
    oz = m.maximum(qz, 0.0)
    outside = _len3(ox, oy, oz, m)
    inside = m.minimum(m.maximum(qx, m.maximum(qy, qz)), 0.0)
    return outside + inside


def _box(n, px, py, pz, getp, off, m):
    return _box_core(px, py, pz, *(getp(off + i) for i in range(6)), m)


def _round_box(n, px, py, pz, getp, off, m):
    return _box_core(px, py, pz, *(getp(off + i) for i in range(6)), m) - getp(off + 6)


def _torus(n, px, py, pz, getp, off, m):
    cx, cy, cz, major, minor = (getp(off + i) for i in range(5))
    ring = _len2(px - cx, pz - cz, m) - major
    return _len2(ring, py - cy, m) - minor


def _capsule(n, px, py, pz, getp, off, m):
    ax, ay, az, bx, by, bz, r = (getp(off + i) for i in range(7))
    pax, pay, paz = px - ax, py - ay, pz - az
    bax, bay, baz = bx - ax, by - ay, bz - az
    denom = m.maximum(bax * bax + bay * bay + baz * baz, 1e-12)
    h = m.let(m.clip((pax * bax + pay * bay + paz * baz) / denom, 0.0, 1.0))
    return _len3(pax - bax * h, pay - bay * h, paz - baz * h, m) - r


def _cylinder(n, px, py, pz, getp, off, m):
    cx, cy, cz, r, hh = (getp(off + i) for i in range(5))
    radial = _len2(px - cx, pz - cz, m) - r
    axial = m.abs(py - cy) - hh
    # No vlength_safe here, as in JAX's emitter: inside the core both
    # clamps are 0 and the length's derivative is NaN (ROADMAP Queue 3).
    outside = _len2(m.maximum(radial, 0.0), m.maximum(axial, 0.0), m)
    inside = m.minimum(m.maximum(radial, axial), 0.0)
    return outside + inside


def _ellipsoid(n, px, py, pz, getp, off, m):
    cx, cy, cz, rx, ry, rz = (getp(off + i) for i in range(6))
    qx, qy, qz = px - cx, py - cy, pz - cz
    k0 = m.let(_len3(qx / rx, qy / ry, qz / rz, m))
    k1 = _len3(qx / (rx * rx), qy / (ry * ry), qz / (rz * rz), m)
    return k0 * (k0 - 1.0) / m.maximum(k1, 1e-12)


def _mandelbulb(n, px, py, pz, getp, off, m):
    # JAX's emitter: the query scaled by inv = 1/scale, the estimate times
    # scale (the node divides by scale).
    cx, cy, cz, sc = (getp(off + i) for i in range(4))
    inv = m.let(1.0 / sc)
    qx, qy, qz = m.let((px - cx) * inv), m.let((py - cy) * inv), m.let((pz - cz) * inv)
    return primitives.mandelbulb_de(qx, qy, qz, int(n.iterations), m) * sc


def _translate(n, px, py, pz, getp, off, m):
    nc = count_params(n.child)
    ox, oy, oz = (getp(off + nc + i) for i in range(3))
    return _emit(n.child, px - ox, py - oy, pz - oz, getp, off, m)


def _rodrigues_scalars(wx, wy, wz, m):
    """The nine entries of the Rodrigues matrix R = I + sinc·K + cosc·K²,
    row-major, on scalars: the series below |w|² = 1e-8, where the exact
    branch is evaluated at a safe θ = 1 (a double select, so the branch not
    taken gets a true 0 adjoint and the series' gradient survives)."""
    t2 = m.let(wx * wx + wy * wy + wz * wz)
    small = m.less(t2, 1e-8)
    safe2 = m.let(m.where(small, 1.0, t2))
    theta = m.let(m.sqrt(safe2))
    sinc = m.let(m.where(small, 1.0 - t2 / 6.0, m.sin(theta) / theta))
    cosc = m.let(m.where(small, 0.5 - t2 / 24.0, (1.0 - m.cos(theta)) / safe2))
    r00 = 1.0 + cosc * (-(wy * wy + wz * wz))
    r01 = -sinc * wz + cosc * (wx * wy)
    r02 = sinc * wy + cosc * (wx * wz)
    r10 = sinc * wz + cosc * (wx * wy)
    r11 = 1.0 + cosc * (-(wx * wx + wz * wz))
    r12 = -sinc * wx + cosc * (wy * wz)
    r20 = -sinc * wy + cosc * (wx * wz)
    r21 = sinc * wx + cosc * (wy * wz)
    r22 = 1.0 + cosc * (-(wx * wx + wy * wy))
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def _rotate_query(px, py, pz, r):
    """R⁻¹ = Rᵀ applied to the query point (row i of Rᵀ is column i of R),
    written out: no matrix product (ROADMAP Queue 3, reduced precision)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    qx = r00 * px + r10 * py + r20 * pz
    qy = r01 * px + r11 * py + r21 * pz
    qz = r02 * px + r12 * py + r22 * pz
    return qx, qy, qz


def _rotate(n, px, py, pz, getp, off, m):
    nc = count_params(n.child)
    r = tuple(m.let(v) for v in _rodrigues_scalars(*(getp(off + nc + i) for i in range(3)), m))
    qx, qy, qz = (m.let(v) for v in _rotate_query(px, py, pz, r))
    return _emit(n.child, qx, qy, qz, getp, off, m)


def _scale(n, px, py, pz, getp, off, m):
    s = m.maximum(getp(off + count_params(n.child)), 1e-12)
    return _emit(n.child, px / s, py / s, pz / s, getp, off, m) * s


def _round(n, px, py, pz, getp, off, m):
    return _emit(n.child, px, py, pz, getp, off, m) - getp(off + count_params(n.child))


def _onion(n, px, py, pz, getp, off, m):
    return m.abs(_emit(n.child, px, py, pz, getp, off, m)) - getp(off + count_params(n.child))


def _elongate(n, px, py, pz, getp, off, m):
    nc = count_params(n.child)
    ax, ay, az = (getp(off + nc + i) for i in range(3))
    qx = px - m.clip(px, -ax, ax)
    qy = py - m.clip(py, -ay, ay)
    qz = pz - m.clip(pz, -az, az)
    return _emit(n.child, qx, qy, qz, getp, off, m)


def _repeat(n, px, py, pz, getp, off, m):
    nc = count_params(n.child)

    def fold(p, period):
        on = m.greater(period, 0.0)
        safe = m.where(on, period, 1.0)
        return m.where(on, p - period * m.round(p / safe), p)

    qx, qy, qz = (fold(v, getp(off + nc + i)) for i, v in enumerate((px, py, pz)))
    return _emit(n.child, qx, qy, qz, getp, off, m)


def _binary(op):
    def h(n, px, py, pz, getp, off, m):
        da = _emit(n.a, px, py, pz, getp, off, m)
        db = _emit(n.b, px, py, pz, getp, off + count_params(n.a), m)
        return op(m, da, db)

    return h


_PRIMITIVES = (primitives.Sphere, primitives.Plane, primitives.Box, primitives.RoundBox, primitives.Torus,
               primitives.Capsule, primitives.Cylinder, primitives.Ellipsoid, primitives.Mandelbulb)


def _name_operand(node, d, m):
    """``d``, the distance of ``node``, named once (``m.let``) when the node
    is a combination or a transform: the smooth mix reads each operand
    several times, so a chain of smooth unions would otherwise repeat its
    inner terms exponentially in the C text.  A primitive's text is kept
    inline (the flagship's headers stay as they were)."""
    return d if isinstance(node, _PRIMITIVES) else m.let(d)


def _smooth(sign: float, neg_b: bool = False):
    def h(n, px, py, pz, getp, off, m):
        na, nb = count_params(n.a), count_params(n.b)
        da = _name_operand(n.a, _emit(n.a, px, py, pz, getp, off, m), m)
        db = _name_operand(n.b, _emit(n.b, px, py, pz, getp, off + na, m), m)
        if neg_b:
            db = -db
        return _smooth_mix(da, db, m.maximum(getp(off + na + nb), 1e-6), sign, m)

    return h


def _union_op(m, a, b):
    return m.minimum(a, b)


def _intersection_op(m, a, b):
    return m.maximum(a, b)


def _subtraction_op(m, a, b):
    return m.maximum(a, -b)


_HANDLERS = {
    primitives.Sphere: _sphere,
    primitives.Plane: _plane,
    primitives.Box: _box,
    primitives.RoundBox: _round_box,
    primitives.Torus: _torus,
    primitives.Capsule: _capsule,
    primitives.Cylinder: _cylinder,
    primitives.Ellipsoid: _ellipsoid,
    primitives.Mandelbulb: _mandelbulb,
    csg.Union: _binary(_union_op),
    csg.Intersection: _binary(_intersection_op),
    csg.Subtraction: _binary(_subtraction_op),
    csg.SmoothUnion: _smooth(+1.0),
    csg.SmoothIntersection: _smooth(-1.0),
    csg.SmoothSubtraction: _smooth(-1.0, neg_b=True),
    transforms.Translate: _translate,
    transforms.Rotate: _rotate,
    transforms.Scale: _scale,
    transforms.Round: _round,
    transforms.Onion: _onion,
    transforms.Elongate: _elongate,
    transforms.RepeatInfinite: _repeat,
}


def _no_emitter(node):
    if isinstance(node, NeuralSDF):
        return NotImplementedError(
            "NeuralSDF has no emitter of the analytic kernels (render, fit step, render backward): the neural "
            "kernel (ops/neural_kernel.py: render_neural_forward, render_neural, render_batch(engine='kernel')) "
            "serves a bare NeuralSDF or Union(analytic, NeuralSDF); other compositions with a NeuralSDF render "
            "with render, render_banded or render_batch(engine='torch')"
        )
    return NotImplementedError(
        f"no render-kernel emitter for scene node {type(node).__name__}; the port supports the primitives "
        "Sphere, Plane, Box, RoundBox, Torus, Capsule, Cylinder, Ellipsoid and Mandelbulb, the hard and smooth "
        "Union, Intersection and Subtraction, the transforms Translate, Rotate, Scale, Round, Onion, Elongate and "
        "RepeatInfinite, and NeuralSDF so far: VoxelGrid is ROADMAP item 14 "
        "(sdf3d_tpu_torch/ops/scene_program.py)"
    )


def _emit(node, px, py, pz, getp: GetP, off: int, m):
    h = _HANDLERS.get(type(node))
    if h is None:
        raise _no_emitter(node)
    if isinstance(m, _Tape) and isinstance(node, _PRIMITIVES):
        first = len(m.nodes)
        out = h(node, px, py, pz, getp, off, m)
        m.spans.append((first, len(m.nodes)))
        return out
    return h(node, px, py, pz, getp, off, m)


def check_scene(scene: SDFNode) -> None:
    """Raise ``NotImplementedError`` naming the first node without an
    emitter (before anything is built or launched)."""
    for node in walk_nodes(scene):
        if type(node) not in _HANDLERS:
            raise _no_emitter(node)


def compile_scene(scene: SDFNode):
    """``soa(px, py, pz, getp) -> distance`` over tensors (point form)."""
    check_scene(scene)

    def soa(px, py, pz, getp: GetP):
        return _emit(scene, px, py, pz, getp, 0, _TorchOps)

    return soa


# ---------------------------------------------------------------------------
# Reverse mode of the point form, for the CUDA backward kernels.  The same
# point-form emitters run on a tape of symbolic values; each recorded
# operation has an adjoint rule, so the reverse pass of a node is derived
# from its forward emitter and parameter offsets cannot drift.  Adjoint
# rules follow lax's derivatives (min/max split the adjoint 0.5/0.5 at an
# exact tie; sqrt's derivative is 0.5/sqrt(x); abs passes +g at x >= 0;
# clip is recorded as min(hi, max(lo, x)); sin and cos give cos and -sin;
# log gives g/x and rsqrt g*(-0.5*r/x); rint and the comparisons pass
# none; a select passes g to the operand it took and exactly 0 to the
# other), which the JAX package's jax.vjp of the same emitters applies.  Like JAX's emitters, the box's and the cylinder's
# outside lengths have no guard: a tap inside the core (every clamp at 0)
# meets sqrt(0)'s infinite derivative times 0, a NaN.  A comparison is a
# `const bool`, not one of the forward values Scene::bwd_values counts.
# ---------------------------------------------------------------------------


class _Var:
    """A value of straight-line code recorded on a :class:`_Tape`."""

    __slots__ = ("tape", "i")

    def __init__(self, tape: "_Tape", i: int):
        self.tape, self.i = tape, i

    def __add__(self, o):
        return self.tape.op("+", self, o)

    def __radd__(self, o):
        return self.tape.op("+", o, self)

    def __sub__(self, o):
        return self.tape.op("-", self, o)

    def __rsub__(self, o):
        return self.tape.op("-", o, self)

    def __mul__(self, o):
        return self.tape.op("*", self, o)

    def __rmul__(self, o):
        return self.tape.op("*", o, self)

    def __truediv__(self, o):
        return self.tape.op("/", self, o)

    def __rtruediv__(self, o):
        return self.tape.op("/", o, self)

    def __neg__(self):
        return self.tape.op("neg", self)


class _Tape:
    """Symbolic backend that records operations in order: ``nodes[i]`` is
    ``("leaf", c_name)`` or ``(op, *operands)`` with each operand a node
    index or a float constant."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self.named: dict[str, _Var] = {}
        # (first, end) tape indices of each primitive's emitter.
        self.spans: list[tuple[int, int]] = []

    def leaf(self, name: str) -> _Var:
        if name not in self.named:
            self.nodes.append(("leaf", name))
            self.named[name] = _Var(self, len(self.nodes) - 1)
        return self.named[name]

    def op(self, op: str, a, b=None, c=None) -> _Var:
        def ref(x):
            return x.i if isinstance(x, _Var) else float(x)

        args = (a, b) if c is None else (a, b, c)
        self.nodes.append((op,) + tuple(None if x is None else ref(x) for x in args))
        return _Var(self, len(self.nodes) - 1)

    def sqrt(self, x):
        return self.op("sqrt", x)

    def rsqrt(self, x):
        return self.op("rsqrt", x)

    def log(self, x):
        return self.op("log", x)

    def minimum(self, a, b):
        return self.op("min", a, b)

    def maximum(self, a, b):
        return self.op("max", a, b)

    def abs(self, x):
        return self.op("abs", x)

    def clip(self, x, lo, hi):
        return self.minimum(hi, self.maximum(lo, x))

    def sin(self, x):
        return self.op("sin", x)

    def cos(self, x):
        return self.op("cos", x)

    def round(self, x):
        return self.op("rint", x)

    def less(self, a, b):
        return self.op("<", a, b)

    def greater(self, a, b):
        return self.op(">", a, b)

    def where(self, c, a, b):
        return self.op("select", c, a, b)

    @staticmethod
    def let(x):
        return x


# Operations with no adjoint: rint's derivative is 0 (lax.round's), and a
# comparison gives a boolean.  No adjoint flows through them.
_NO_ADJOINT = ("rint", "<", ">")
# C forms of the recorded operations (the forward values of the reverse pass).
_C_CALLS = {"sqrt": "sqrtf", "abs": "fabsf", "sin": "sinf", "cos": "cosf", "rint": "rintf", "log": "logf"}


def _adjoints(op: str, g: str, a: str, b: str, r: str, c: str = None):
    """C terms of the adjoints of the operands ``a``, ``b`` (and ``c``) of
    ``r = op(a, b[, c])`` given the adjoint ``g`` of ``r`` (lax's derivative
    rules); None for an operand that gets none."""
    if op == "+":
        return g, g
    if op == "-":
        return g, f"(-{g})"
    if op == "*":
        return f"({g} * {b})", f"({g} * {a})"
    if op == "/":
        return f"({g} / {b})", f"(-(({g} * {a}) / ({b} * {b})))"
    if op == "sqrt":
        return f"({g} * (0.5f / {r}))", None
    if op == "rsqrt":
        return f"({g} * (-0.5f * ({r} / {a})))", None
    if op == "log":
        return f"({g} / {a})", None
    if op == "abs":
        return f"({g} * sdf3d::abs_adj({a}))", None
    if op == "neg":
        return f"(-{g})", None
    if op == "sin":
        return f"({g} * cosf({a}))", None
    if op == "cos":
        return f"(-({g} * sinf({a})))", None
    if op == "select":
        # A select, not a 0/1 mask: the operand not taken gets exactly 0,
        # even where g is not finite.
        return None, f"sdf3d::select({a}, {g}, 0.0f)", f"sdf3d::select({a}, 0.0f, {g})"
    return f"({g} * sdf3d::{op}_adj({a}, {b}))", f"({g} * sdf3d::{op}_adj({b}, {a}))"


def _reverse_source(scene: SDFNode, with_params: bool) -> tuple[str, int]:
    """C statements for the reverse pass of the point form at (px, py, pz)
    with the output adjoint ``g``: ``dp[k] += g·∂f/∂p_k`` when
    ``with_params``, and ``(dpx, dpy, dpz) = g·∇ₚf``; and the most forward
    values the pass keeps from one primitive (the register caps read it)."""
    tape = _Tape()
    root = _emit(scene, tape.leaf("px"), tape.leaf("py"), tape.leaf("pz"),
                 lambda i: tape.leaf(f"p[{i}]"), 0, tape).i
    nodes = tape.nodes
    wanted = {"px", "py", "pz"}

    def is_var(x):
        return isinstance(x, int)

    def val(x):
        return f"v{x}" if is_var(x) else c_float(x)

    # Nodes whose adjoint matters: those that depend on a wanted leaf.
    reach = []
    for op, *args in nodes:
        if op == "leaf":
            reach.append(args[0] in wanted or (with_params and args[0].startswith("p[")))
        else:
            reach.append(op not in _NO_ADJOINT and any(is_var(x) and reach[x] for x in args))

    rev = []
    for i in range(len(nodes) - 1, -1, -1):
        op, args = nodes[i][0], [x for x in nodes[i][1:] if x is not None]
        if op == "leaf" or not reach[i]:
            continue
        vals = [val(x) for x in args] + [None] * (3 - len(args))
        terms = _adjoints(op, f"a{i}", vals[0], vals[1], f"v{i}", vals[2])
        for x, t in zip(args, terms):
            if t is not None and is_var(x) and reach[x]:
                rev.append(f"a{x} += {t};")
    # The forward values the emitted adjoint terms read.
    needed = {int(k) for k in re.findall(r"\bv(\d+)\b", " ".join(rev))}

    # Forward values: the needed ones and everything they are computed from.
    for i in range(len(nodes) - 1, -1, -1):
        if i in needed and nodes[i][0] != "leaf":
            needed.update(x for x in nodes[i][1:] if is_var(x))
    fwd = []
    for i, (op, *args) in enumerate(nodes):
        if i not in needed:
            continue
        kind = "float"
        if op == "leaf":
            expr = args[0]
        elif op in _C_CALLS:
            expr = f"{_C_CALLS[op]}({val(args[0])})"
        elif op == "rsqrt":
            expr = f"(1.0f / sqrtf({val(args[0])}))"
        elif op == "neg":
            expr = f"(-({val(args[0])}))"
        elif op in ("min", "max"):
            expr = f"f{op}f({val(args[0])}, {val(args[1])})"
        elif op == "select":
            expr = f"sdf3d::select({', '.join(val(x) for x in args)})"
        else:
            expr = f"({val(args[0])} {op} {val(args[1])})"
            kind = "bool" if op in ("<", ">") else kind
        fwd.append(f"const {kind} v{i} = {expr};")

    node_values = max((sum(1 for i in range(a, b) if i in needed and nodes[i][0] not in ("leaf", "<", ">"))
                       for a, b in tape.spans), default=0)
    decl = [f"float a{i} = {'g' if i == root else '0.0f'};" for i in range(len(nodes)) if reach[i]]
    out = []
    for name, var in tape.named.items():
        a = f"a{var.i}" if reach[var.i] else "0.0f"
        if name in wanted:
            out.append(f"d{name} = {a};")
        elif with_params and reach[var.i]:
            out.append(f"dp[{name[2:-1]}] += {a};")
    return "\n".join("    " + s for s in fwd + decl + rev + out), node_values


# ---------------------------------------------------------------------------
# Ray-form emitters: (node, o, d, getp, off, m) -> eval(t), per-ray
# constants hoisted out of the march loop.
# ---------------------------------------------------------------------------


def _quad_coeffs(ax, ay, az, bx, by, bz):
    """Coefficients of |a + t·b|² = qa·t² + 2·qb·t + qc."""
    qa = bx * bx + by * by + bz * bz
    qb = ax * bx + ay * by + az * bz
    qc = ax * ax + ay * ay + az * az
    return qa, qb, qc


def _ray_sphere(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    cx, cy, cz, r = (getp(off + i) for i in range(4))
    qa, qb, qc = _quad_coeffs(ox - cx, oy - cy, oz - cz, dx, dy, dz)
    inv_qa = m.hoist(1.0 / m.maximum(qa, 1e-24))
    A = m.hoist(m.sqrt(qa))
    B = m.hoist(qb * inv_qa)
    C = m.hoist(m.maximum(qc * inv_qa - B * B, 0.0))
    r = m.hoist(r)

    def ev(t):
        u = t + B
        return A * m.sqrt(u * u + C) - r

    return ev


def _ray_plane(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    nx, ny, nz, d = (getp(off + i) for i in range(4))
    a = m.hoist(dx * nx + dy * ny + dz * nz)
    b = m.hoist(ox * nx + oy * ny + oz * nz - d)
    return lambda t: a * t + b


def _ray_box_core(ox, oy, oz, dx, dy, dz, cx, cy, cz, hx, hy, hz, m):
    ax, ay, az = m.hoist(ox - cx), m.hoist(oy - cy), m.hoist(oz - cz)
    dx, dy, dz = m.hoist(dx), m.hoist(dy), m.hoist(dz)
    hx, hy, hz = m.hoist(hx), m.hoist(hy), m.hoist(hz)

    def ev(t):
        qx = m.abs(ax + t * dx) - hx
        qy = m.abs(ay + t * dy) - hy
        qz = m.abs(az + t * dz) - hz
        mx = m.maximum(qx, 0.0)
        my = m.maximum(qy, 0.0)
        mz = m.maximum(qz, 0.0)
        outside = m.sqrt(mx * mx + my * my + mz * mz)
        inside = m.minimum(m.maximum(qx, m.maximum(qy, qz)), 0.0)
        return outside + inside

    return ev


def _ray_box(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    return _ray_box_core(ox, oy, oz, dx, dy, dz, *(getp(off + i) for i in range(6)), m)


def _ray_round_box(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    ev0 = _ray_box_core(ox, oy, oz, dx, dy, dz, *(getp(off + i) for i in range(6)), m)
    r = m.hoist(getp(off + 6))
    return lambda t: ev0(t) - r


def _ray_torus(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    # |(o − c + t·d)_xz|² = t·(qa·t + 2·qb) + qc (JAX's _quad_eval; its y
    # terms are zeros, whose products add exactly 0).
    cx, cy, cz, major, minor = (getp(off + i) for i in range(5))
    ax, az = ox - cx, oz - cz
    qa = m.hoist(dx * dx + dz * dz)
    qb2 = m.hoist(2.0 * (ax * dx + az * dz))
    qc = m.hoist(ax * ax + az * az)
    ay, by = m.hoist(oy - cy), m.hoist(dy)
    major, minor = m.hoist(major), m.hoist(minor)

    def ev(t):
        ring = m.sqrt(m.maximum(t * (qa * t + qb2) + qc, 0.0)) - major
        y = ay + t * by
        return m.sqrt(ring * ring + y * y) - minor

    return ev


def _ray_capsule(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    axp, ayp, azp, bxp, byp, bzp, r = (getp(off + i) for i in range(7))
    bax, bay, baz = bxp - axp, byp - ayp, bzp - azp
    inv = 1.0 / m.maximum(bax * bax + bay * bay + baz * baz, 1e-12)
    # h(t) = clip((o − a + t·d)·(b − a)·inv, 0, 1): affine in t before the clip.
    h0 = m.hoist(((ox - axp) * bax + (oy - ayp) * bay + (oz - azp) * baz) * inv)
    h1 = m.hoist((dx * bax + dy * bay + dz * baz) * inv)
    wx0, wy0, wz0 = m.hoist(ox - axp), m.hoist(oy - ayp), m.hoist(oz - azp)
    dx, dy, dz = m.hoist(dx), m.hoist(dy), m.hoist(dz)
    bax, bay, baz = m.hoist(bax), m.hoist(bay), m.hoist(baz)
    r = m.hoist(r)

    def ev(t):
        h = m.clip(h0 + t * h1, 0.0, 1.0)
        ux = wx0 + t * dx - bax * h
        uy = wy0 + t * dy - bay * h
        uz = wz0 + t * dz - baz * h
        return m.sqrt(ux * ux + uy * uy + uz * uz) - r

    return ev


def _ray_cylinder(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    # The radial length as the torus's: JAX's _quad_coeffs with zero y terms.
    cx, cy, cz, r, hh = (getp(off + i) for i in range(5))
    ax, az = ox - cx, oz - cz
    qa = m.hoist(dx * dx + dz * dz)
    qb2 = m.hoist(2.0 * (ax * dx + az * dz))
    qc = m.hoist(ax * ax + az * az)
    ay, by = m.hoist(oy - cy), m.hoist(dy)
    r, hh = m.hoist(r), m.hoist(hh)

    def ev(t):
        radial = m.sqrt(m.maximum(t * (qa * t + qb2) + qc, 0.0)) - r
        axial = m.abs(ay + t * by) - hh
        mr = m.maximum(radial, 0.0)
        ma = m.maximum(axial, 0.0)
        outside = m.sqrt(mr * mr + ma * ma)
        inside = m.minimum(m.maximum(radial, axial), 0.0)
        return outside + inside

    return ev


def _ray_ellipsoid(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    # k0 reads q/rᵢ, k1 q/rᵢ²: two quadratics in t of the scaled (o − c, d).
    cx, cy, cz, rx, ry, rz = (getp(off + i) for i in range(6))
    qa0, qb0, qc0 = _quad_coeffs((ox - cx) / rx, (oy - cy) / ry, (oz - cz) / rz, dx / rx, dy / ry, dz / rz)
    rx2, ry2, rz2 = rx * rx, ry * ry, rz * rz
    qa1, qb1, qc1 = _quad_coeffs((ox - cx) / rx2, (oy - cy) / ry2, (oz - cz) / rz2, dx / rx2, dy / ry2, dz / rz2)
    qa0, qb0, qc0 = m.hoist(qa0), m.hoist(2.0 * qb0), m.hoist(qc0)
    qa1, qb1, qc1 = m.hoist(qa1), m.hoist(2.0 * qb1), m.hoist(qc1)

    def ev(t):
        k0 = m.sqrt(m.maximum(t * (qa0 * t + qb0) + qc0, 0.0))
        k1 = m.sqrt(m.maximum(t * (qa1 * t + qb1) + qc1, 0.0))
        return k0 * (k0 - 1.0) / m.maximum(k1, 1e-12)

    return ev


def _ray_translate(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    nc = count_params(n.child)
    tx, ty, tz = (getp(off + nc + i) for i in range(3))
    return _ray_emit(n.child, ox - tx, oy - ty, oz - tz, dx, dy, dz, getp, off, m)


def _ray_rotate(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    nc = count_params(n.child)
    r = tuple(m.hoist(v) for v in _rodrigues_scalars(*(getp(off + nc + i) for i in range(3)), m))
    qo = (m.hoist(v) for v in _rotate_query(ox, oy, oz, r))
    qd = (m.hoist(v) for v in _rotate_query(dx, dy, dz, r))
    return _ray_emit(n.child, *qo, *qd, getp, off, m)


def _ray_scale(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    s = m.hoist(m.maximum(getp(off + count_params(n.child)), 1e-12))
    ev = _ray_emit(n.child, ox / s, oy / s, oz / s, dx / s, dy / s, dz / s, getp, off, m)
    return lambda t: ev(t) * s


def _ray_round(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    ev = _ray_emit(n.child, ox, oy, oz, dx, dy, dz, getp, off, m)
    r = m.hoist(getp(off + count_params(n.child)))
    return lambda t: ev(t) - r


def _ray_onion(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    ev = _ray_emit(n.child, ox, oy, oz, dx, dy, dz, getp, off, m)
    r = m.hoist(getp(off + count_params(n.child)))
    return lambda t: m.abs(ev(t)) - r


def _ray_fallback(node, ox, oy, oz, dx, dy, dz, getp, off, m):
    """A node without a ray form (``Elongate``, ``RepeatInfinite``): the
    point form of its subtree at ``o + t·d``, per step; the ray and the
    parameters are hoisted, so the step reads setup values only."""
    ox, oy, oz, dx, dy, dz = (m.hoist(v) for v in (ox, oy, oz, dx, dy, dz))

    def hoisted(i):
        return m.hoist(getp(i))

    return lambda t: _emit(node, ox + t * dx, oy + t * dy, oz + t * dz, hoisted, off, m)


def _ray_binary(op):
    def h(n, ox, oy, oz, dx, dy, dz, getp, off, m):
        ea = _ray_emit(n.a, ox, oy, oz, dx, dy, dz, getp, off, m)
        eb = _ray_emit(n.b, ox, oy, oz, dx, dy, dz, getp, off + count_params(n.a), m)
        return lambda t: op(m, ea(t), eb(t))

    return h


def _ray_smooth(sign: float, neg_b: bool = False):
    def h(n, ox, oy, oz, dx, dy, dz, getp, off, m):
        na, nb = count_params(n.a), count_params(n.b)
        ea = _ray_emit(n.a, ox, oy, oz, dx, dy, dz, getp, off, m)
        eb = _ray_emit(n.b, ox, oy, oz, dx, dy, dz, getp, off + na, m)
        k = m.hoist(m.maximum(getp(off + na + nb), 1e-6))

        def ev(t):
            db = _name_operand(n.b, eb(t), m)
            if neg_b:
                db = -db
            return _smooth_mix(_name_operand(n.a, ea(t), m), db, k, sign, m)

        return ev

    return h


_RAY_HANDLERS = {
    primitives.Sphere: _ray_sphere,
    primitives.Plane: _ray_plane,
    primitives.Box: _ray_box,
    primitives.RoundBox: _ray_round_box,
    primitives.Torus: _ray_torus,
    primitives.Capsule: _ray_capsule,
    primitives.Cylinder: _ray_cylinder,
    primitives.Ellipsoid: _ray_ellipsoid,
    csg.Union: _ray_binary(_union_op),
    csg.Intersection: _ray_binary(_intersection_op),
    csg.Subtraction: _ray_binary(_subtraction_op),
    csg.SmoothUnion: _ray_smooth(+1.0),
    csg.SmoothIntersection: _ray_smooth(-1.0),
    csg.SmoothSubtraction: _ray_smooth(-1.0, neg_b=True),
    transforms.Translate: _ray_translate,
    transforms.Rotate: _ray_rotate,
    transforms.Scale: _ray_scale,
    transforms.Round: _ray_round,
    transforms.Onion: _ray_onion,
}


def _ray_emit(node, ox, oy, oz, dx, dy, dz, getp: GetP, off: int, m):
    h = _RAY_HANDLERS.get(type(node))
    if h is None:
        if type(node) not in _HANDLERS:
            raise _no_emitter(node)
        h = _ray_fallback
    return h(node, ox, oy, oz, dx, dy, dz, getp, off, m)


def compile_scene_ray(scene: SDFNode):
    """``setup(o, d, getp) -> eval(t)`` over tensors (ray form); ``o`` and
    ``d`` are (x, y, z) tuples of planes or scalars."""
    check_scene(scene)

    def setup(o, d, getp: GetP):
        return _ray_emit(scene, o[0], o[1], o[2], d[0], d[1], d[2], getp, 0, _TorchOps)

    return setup


# ---------------------------------------------------------------------------
# CUDA source generation.
# ---------------------------------------------------------------------------


def describe(node: SDFNode) -> str:
    """The scene's structure, e.g. ``Union(Plane, Sphere)``."""
    kids = [describe(getattr(node, f)) for f in node.fields if isinstance(getattr(node, f), SDFNode)]
    return f"{type(node).__name__}({', '.join(kids)})" if kids else type(node).__name__


def _ao_source(cfg, sdf_call: str = "sdf({}, p)") -> str:
    """Unrolled AO taps with the JAX package's constants: tap ``i`` samples
    at ``h = step·i`` with weight ``falloff^(i-1)`` (both rounded to
    float32, as JAX's weak-typed Python scalars are).  ``sdf_call`` is the
    distance call with ``{}`` for the point's three coordinates."""
    if not cfg.ao.enabled:
        return "    return 1.0f;"
    lines = ["    float occ = 0.0f;"]
    weight = 1.0
    for tap in range(1, cfg.ao.samples + 1):
        h = c_float(cfg.ao.step * tap)
        pt = sdf_call.format(f"(hx + ({h} * nx)), (hy + ({h} * ny)), (hz + ({h} * nz))")
        lines.append(f"    occ = (occ + ({c_float(weight)} * ({h} - {pt})));")
        weight *= cfg.ao.falloff
    lines.append(f"    return fminf(fmaxf((1.0f - ({c_float(cfg.ao.strength)} * occ)), 0.0f), 1.0f);")
    return "\n".join(lines)


def _ao_bwd_source(cfg) -> str:
    """The reverse of :func:`_ao_source`'s taps, with the same constants:
    the adjoint ``g`` of the clipped factor goes through the clip and each
    tap's distance to ``dp``, the hit point and the normal."""
    lines = ["    float occ = 0.0f;"]
    taps = []
    weight = 1.0
    for tap in range(1, cfg.ao.samples + 1):
        h = c_float(cfg.ao.step * tap)
        pt = f"(hx + ({h} * nx)), (hy + ({h} * ny)), (hz + ({h} * nz))"
        lines.append(f"    occ = (occ + ({c_float(weight)} * ({h} - sdf({pt}, p))));")
        taps.append(f"    sdf_bwd({pt}, p, (-({c_float(weight)} * g_occ)), dp, qx, qy, qz);\n"
                    f"    ghx += qx; ghy += qy; ghz += qz;\n"
                    f"    gnx += ({h} * qx); gny += ({h} * qy); gnz += ({h} * qz);")
        weight *= cfg.ao.falloff
    strength = c_float(cfg.ao.strength)
    lines.append(f"    const float g_occ = ((g * sdf3d::clip_adj((1.0f - ({strength} * occ)), 0.0f, 1.0f)) * (-{strength}));")
    lines.append("    float qx, qy, qz;")
    return "\n".join(lines + taps)


def _c_bool(v) -> str:
    return "true" if v else "false"


def _cfg_struct(cfg, **launch) -> str:
    """``struct Cfg``: the kernel's launch settings ``launch`` (ints and
    bools) and the static render settings of ``cfg``, as ``constexpr``."""
    mc = cfg.march
    bg = cfg.background or (0.0, 0.0, 0.0)
    normals = {"central": 0, "tetrahedron": 1}[cfg.normals]
    b = _c_bool
    head = "".join(
        f"  static constexpr {'bool' if isinstance(v, bool) else 'int'} {k} = {b(v) if isinstance(v, bool) else v};\n"
        for k, v in launch.items())
    return f"""struct Cfg {{
{head}  static constexpr int ndc_h = {int(cfg.ndc_height or 0)};
  static constexpr int ndc_w = {int(cfg.ndc_width or 0)};
  static constexpr int march_steps = {int(mc.max_steps)};
  static constexpr float max_distance = {c_float(mc.max_distance)};
  static constexpr float epsilon = {c_float(mc.epsilon)};
  static constexpr float relaxation = {c_float(mc.relaxation)};  // 1: the exact march
  static constexpr bool shadow_enabled = {b(cfg.shadow.enabled)};
  static constexpr int shadow_steps = {int(cfg.shadow.max_steps)};
  static constexpr float epsilon2 = {c_float(mc.epsilon * mc.epsilon)};
  static constexpr bool ao_enabled = {b(cfg.ao.enabled)};
  static constexpr int normals = {normals};  // 0 central, 1 tetrahedron
  static constexpr bool blinn_phong = {b(cfg.shading == "blinn_phong")};
  static constexpr bool background = {b(cfg.background is not None)};
  static constexpr float bg_r = {c_float(bg[0])};
  static constexpr float bg_g = {c_float(bg[1])};
  static constexpr float bg_b = {c_float(bg[2])};
}};"""


#: The fit kernel's variants (``struct Fit``'s ``variant``, in the order of
#: ``csrc/fit_kernel.cu``): ``full`` is K3, the others are the benchmark
#: variants of K9 (``ops/fit_kernel.py::fit_step_variant``).
FIT_VARIANTS = ("full", "wrt_p", "primal", "noscatter", "nopow", "shade_only", "empty", "empty_noin")


def cuda_scene_source(scene: SDFNode, cfg, kc, wrt_uniforms: bool = True, frozen_slots: tuple = (),
                      variant: str = "full") -> str:
    """The generated header ``sdf3d_scene.cuh`` for ``scene`` under the
    static settings ``cfg`` (RenderConfig) and ``kc`` (KernelConfig).

    ``wrt_uniforms``, ``frozen_slots`` and ``variant`` are the fit kernel's
    static settings (``struct Fit``): whether it computes the uniform
    gradients, the parameter slots whose gradient it leaves at exactly 0,
    and which of :data:`FIT_VARIANTS` it is (a benchmark variant takes no
    frozen slots)."""
    if variant not in FIT_VARIANTS:
        raise ValueError(f"variant must be one of {FIT_VARIANTS}, not {variant!r}")
    if variant != "full" and frozen_slots:
        raise ValueError(f"the fit kernel's variant {variant!r} takes no frozen slots")
    check_scene(scene)
    P = lambda i: CExpr(f"p[{i}]")  # noqa: E731

    ray = _COps()
    ev = _ray_emit(scene, *(CExpr(v) for v in ("ox", "oy", "oz", "dx", "dy", "dz")), P, 0, ray)
    ray.in_eval = True
    body = ray.body(ev(CExpr("t")), "      ")
    if re.search(r"p\[|\b[od][xyz]\b", body):
        raise AssertionError(f"ray-form eval reads a setup value that was not hoisted: {body}")

    b = _c_bool
    fields = "\n".join(f"    float {f};" for f in ray.fields)
    setup = "\n".join(f"      {s}" for s in ray.setup)
    ao_bwd = ""
    if cfg.ao.enabled:
        ao_bwd = f"""
  // Reverse of ao(): the adjoint g of the AO factor into dp, g_h and g_n.
  static SDF3D_HD void ao_bwd(float hx, float hy, float hz, float nx, float ny, float nz, const float* p,
                              float g, float* dp, float& ghx, float& ghy, float& ghz,
                              float& gnx, float& gny, float& gnz) {{
{_ao_bwd_source(cfg)}
  }}
"""
    n_params = count_params(scene)
    if any(not 0 <= k < n_params for k in frozen_slots):
        raise ValueError(f"frozen_slots {frozen_slots} out of range for {n_params} parameters")
    frozen = " || ".join(f"k == {k}" for k in sorted(set(frozen_slots))) or "false"
    bwd, node_values = _reverse_source(scene, with_params=True)
    return f"""// Generated by sdf3d_tpu_torch/ops/scene_program.py::cuda_scene_source.
// Scene: {describe(scene)}, {count_params(scene)} parameters.
#pragma once

{_cfg_struct(cfg, block_w=int(kc.block_w), block_h=int(kc.block_h), ray_sdf=kc.ray_sdf,
             tile_h=int(kc.tile_h), tile_w=int(kc.tile_w))}

struct Scene {{
  static constexpr int n_params = {count_params(scene)};
  // Forward values sdf_bwd keeps for its adjoints (the register caps of the
  // fit step and the render backward read it).
  static constexpr int bwd_values = {bwd.count("const float v")};
  // The most of them one primitive keeps (a Mandelbulb's iterations).
  static constexpr int bwd_node_values = {node_values};

  // Point form: distance at (px, py, pz).
  static SDF3D_HD float sdf(float px, float py, float pz, const float* p) {{
{_c_point_body(scene)}
  }}

  // Ray form: distance at o + t*d, per-ray constants hoisted in setup().
  struct Ray {{
{fields}

    SDF3D_HD void setup(float ox, float oy, float oz, float dx, float dy, float dz, const float* p) {{
{setup}
    }}
    SDF3D_HD float eval(float t) const {{
{body}
    }}
  }};

  // Ambient occlusion factor at hit point h with normal n.
  static SDF3D_HD float ao(float hx, float hy, float hz, float nx, float ny, float nz, const float* p) {{
{_ao_source(cfg)}
  }}

  // Reverse mode of the point form at (px, py, pz) with output adjoint g:
  // dp[k] += g * df/dp_k, and (dpx, dpy, dpz) = g * grad_p f.
  static SDF3D_HD void sdf_bwd(float px, float py, float pz, const float* p, float g, float* dp,
                               float& dpx, float& dpy, float& dpz) {{
{bwd}
  }}

  // grad_p f at (px, py, pz) (the implicit-function denominator).
  static SDF3D_HD void sdf_grad_p(float px, float py, float pz, const float* p,
                                  float& dpx, float& dpy, float& dpz) {{
    const float g = 1.0f;
{_reverse_source(scene, with_params=False)[0]}
  }}
{ao_bwd}}};

// Static settings of the fit kernel.
struct Fit {{
  static constexpr bool wrt_uniforms = {b(wrt_uniforms)};
  static constexpr int variant = {FIT_VARIANTS.index(variant)};  // {variant}
  // Frozen parameter slots: not reduced, their gradient reads exactly 0.
  static SDF3D_HD constexpr bool is_frozen(int k) {{ return {frozen}; }}
}};
"""


# ---------------------------------------------------------------------------
# Neural scenes: the header of the neural kernel (csrc/neural_kernel.cu).
# ---------------------------------------------------------------------------

#: Shared memory one CUDA block may use on Hopper (227 KB, dynamic).
SMEM_BYTES = 232448


def _neural_parts(scene: SDFNode):
    """``(analytic_subtree | None, NeuralSDF)`` for a bare NeuralSDF or
    ``Union(analytic, NeuralSDF)`` in either order; None for other shapes."""
    if isinstance(scene, NeuralSDF):
        return None, scene
    if isinstance(scene, csg.Union):
        a_n, b_n = isinstance(scene.a, NeuralSDF), isinstance(scene.b, NeuralSDF)
        if a_n and not b_n:
            return scene.b, scene.a
        if b_n and not a_n:
            return scene.a, scene.b
    return None


def split_neural(scene: SDFNode):
    """Decompose ``scene`` into ``(analytic_subtree | None, NeuralSDF)``:
    a bare NeuralSDF, or ``Union(analytic, NeuralSDF)`` in either order.
    Raises ``ValueError`` for other shapes."""
    parts = _neural_parts(scene)
    if parts is None:
        raise ValueError(
            "neural kernel supports a bare NeuralSDF or Union(analytic, NeuralSDF); "
            f"got {type(scene).__name__} (use the banded engine for other compositions)"
        )
    return parts


def is_neural_shape(scene: SDFNode) -> bool:
    """True for the scene shapes :func:`split_neural` accepts: the scenes
    the kernel entry points send to the neural kernel."""
    return _neural_parts(scene) is not None


def has_neural(scene: SDFNode) -> bool:
    """True when a NeuralSDF is anywhere in the scene."""
    return any(isinstance(n, NeuralSDF) for n in walk_nodes(scene))


@dataclasses.dataclass(frozen=True)
class NeuralLayout:
    """Where the neural kernel finds everything in the scene's one flat
    parameter vector (``scene_param_vector``, ``tree_flatten`` order).

    The analytic subtree's parameters start at ``analytic_offset``; the
    MLP's block (W_0 … W_{L-1}, b_0 … b_{L-1}, β, contiguous) at ``offset``,
    ``size`` floats long.  ``w_offsets``/``b_offsets``/``beta_offset`` are
    relative to ``offset``; W_i is row-major (fan_in, fan_out)."""

    analytic: SDFNode | None
    analytic_offset: int
    n_analytic: int
    offset: int
    size: int
    hidden: int
    layers: int
    w_offsets: tuple
    b_offsets: tuple
    beta_offset: int


def neural_layout(scene: SDFNode) -> NeuralLayout:
    """The layout of a scene :func:`split_neural` accepts, after checking the
    shapes the kernel takes: W_0 (3, H), W_i (H, H), W_{L-1} (H, 1), biases
    to match, one β; and an analytic subtree every node of which has an
    emitter."""
    analytic, neural = split_neural(scene)
    if analytic is not None:
        check_scene(analytic)
    n_analytic = count_params(analytic) if analytic is not None else 0
    neural_first = isinstance(scene, csg.Union) and scene.a is neural
    offset = 0 if analytic is None or neural_first else n_analytic
    ws, bs = list(neural.weights), list(neural.biases)
    L = len(ws)
    H = int(ws[0].shape[1]) if ws and ws[0].dim() == 2 else 0
    want = [(3, H)] + [(H, H)] * (L - 2) + [(H, 1)]
    got = [tuple(w.shape) for w in ws]
    if L < 2 or H < 1 or got != want or [tuple(b.shape) for b in bs] != [(w[1],) for w in want] \
            or neural.beta.numel() != 1:
        raise ValueError(f"the neural kernel takes weights {want} with matching biases and one beta; got {got}")
    w_offsets, k = [], 0
    for w in ws:
        w_offsets.append(k)
        k += w.numel()
    b_offsets = []
    for b in bs:
        b_offsets.append(k)
        k += b.numel()
    return NeuralLayout(
        analytic=analytic, analytic_offset=count_params(neural) if neural_first else 0, n_analytic=n_analytic,
        offset=offset, size=k + 1, hidden=H, layers=L, w_offsets=tuple(w_offsets), b_offsets=tuple(b_offsets),
        beta_offset=k,
    )


#: Shared memory the neural kernel may fill with the MLP's H x H matrices
#: (with its other blocks); wider MLPs stream them through a ring of panels.
RESIDENT_BYTES = SMEM_BYTES
#: MLPs up to this padded width cap the neural kernel's registers so that an
#: SM holds TWO_BLOCK_THREADS threads (two blocks of 256: at most 128 registers
#: a thread; measured faster at hidden 64, slower at 128 where it spills).
TWO_BLOCK_WIDTH = 64
TWO_BLOCK_THREADS = 512


@dataclasses.dataclass(frozen=True)
class NeuralTile:
    """How the neural kernel holds an MLP (``csrc/neural_kernel.cu``): the
    width padded to the ``mma`` shape, the row strides of the weights in
    shared memory, the threads an SM should hold, whether the H x H
    matrices are resident in shared memory or stream in panels of
    ``panel_rows`` rows, and the shared-memory layout in floats."""

    hp: int
    stride: int
    qstride: int
    min_threads: int
    panel_rows: int
    resident: bool
    vec4: bool
    sm_w0: int
    sm_b: int
    sm_wo: int
    sm_bo: int
    sm_beta: int
    sm_uni: int
    sm_pa: int
    sm_mats: int
    smem_floats: int


def neural_tile(lay: NeuralLayout) -> NeuralTile:
    """The neural kernel's tile of the MLP of ``lay``: H padded to a multiple
    of 8; W_0, the biases, the output layer, β, the uniforms and the
    analytic parameters first, each block 16-byte aligned; then either the
    H x H matrices split into hi and lo, one 16-byte quad per pair of rows
    and column at a row stride of ``qstride = hp + 2`` quads (resident: a
    quarter warp's quads fall on distinct banks), or two panels of float32
    rows at a stride of ``stride = hp + 4`` floats (streamed: the B
    fragments' rows 2q and 2q + 1 fall on distinct banks)."""
    H, L = lay.hidden, lay.layers
    hp = -(-H // 8) * 8
    stride = hp + 4
    sm_b = 3 * hp
    sm_wo = sm_b + (L - 1) * hp
    sm_bo = sm_wo + hp
    sm_uni = -(-(sm_bo + 2) // 4) * 4
    sm_pa = sm_uni + 32
    sm_mats = -(-(sm_pa + lay.n_analytic) // 4) * 4
    qstride = hp + 2
    resident_floats = sm_mats + (L - 2) * (hp // 2) * qstride * 4
    resident = resident_floats * 4 <= RESIDENT_BYTES
    panel_rows = next(k for k in (32, 16, 8) if hp % k == 0)
    return NeuralTile(
        hp=hp, stride=stride, qstride=qstride,
        min_threads=TWO_BLOCK_THREADS if hp <= TWO_BLOCK_WIDTH else 0, panel_rows=panel_rows, resident=resident,
        vec4=lay.offset % 4 == 0 and H % 4 == 0, sm_w0=0, sm_b=sm_b, sm_wo=sm_wo, sm_bo=sm_bo, sm_beta=sm_bo + 1,
        sm_uni=sm_uni, sm_pa=sm_pa, sm_mats=sm_mats,
        smem_floats=resident_floats if resident else sm_mats + 2 * panel_rows * stride)


def _ao_taps_source(cfg) -> str:
    """The AO taps as the neural kernel's slots take them, with the JAX
    package's constants (:func:`_ao_source`'s): tap ``i`` at
    ``h = step·(i+1)`` with weight ``falloff^i``."""
    n = cfg.ao.samples if cfg.ao.enabled else 0
    hs, ws, weight = [], [], 1.0
    for tap in range(1, n + 1):
        hs.append(c_float(cfg.ao.step * tap))
        ws.append(c_float(weight))
        weight *= cfg.ao.falloff

    def switch(name, vals):
        cases = "".join(f" case {i}: return {v};" for i, v in enumerate(vals))
        return f"  static SDF3D_HD float {name}(int i) {{ switch (i) {{{cases} default: return 0.0f; }} }}"

    return "\n".join([f"  static constexpr int ao_taps = {n};",
                      f"  static constexpr float ao_strength = {c_float(cfg.ao.strength)};",
                      switch("ao_h", hs), switch("ao_w", ws)])


def cuda_neural_source(scene: SDFNode, cfg, nc) -> str:
    """The generated header ``sdf3d_scene.cuh`` of the neural kernel for a
    scene :func:`split_neural` accepts, under ``cfg`` (RenderConfig) and
    ``nc`` (NeuralRenderConfig): the analytic subtree's point form, the MLP's
    sizes and parameter offsets as ``constexpr`` (its values stay run-time
    device memory), the AO taps and the static settings."""
    lay = neural_layout(scene)
    if lay.analytic is not None:
        point, what = _c_point_body(lay.analytic), describe(lay.analytic)
    else:
        point, what = "    return 0.0f;", "none"
    H, L = lay.hidden, lay.layers
    w, b = lay.w_offsets, lay.b_offsets
    w1 = w[1] if L > 2 else 0
    if any(w[i] != w1 + (i - 1) * H * H for i in range(1, L - 1)) or any(b[i] != b[0] + i * H for i in range(L)):
        raise ValueError(f"the neural kernel reads W_i and b_i at regular offsets; got {w}, {b}")
    tile = neural_tile(lay)
    sm = "\n".join(f"  static constexpr int {f} = {getattr(tile, f)};"
                   for f in ("sm_w0", "sm_b", "sm_wo", "sm_bo", "sm_beta", "sm_uni", "sm_pa", "sm_mats", "smem_floats"))
    return f"""// Generated by sdf3d_tpu_torch/ops/scene_program.py::cuda_neural_source.
// Scene: {describe(scene)}, {count_params(scene)} parameters; MLP 3 -> {H} x {L - 1} -> 1.
#pragma once

{_cfg_struct(cfg, block_rays=int(nc.block_rays))}

struct Scene {{
  static constexpr int n_params = {count_params(scene)};
  static constexpr bool has_analytic = {_c_bool(lay.analytic is not None)};
  static constexpr int analytic_offset = {lay.analytic_offset};
  static constexpr int n_analytic = {lay.n_analytic};

  // Point form of the analytic subtree ({what}); p holds its n_analytic parameters.
  static SDF3D_HD float sdf(float px, float py, float pz, const float* p) {{
{point}
  }}

  // Ambient occlusion: tap i at h + ao_h(i) * n, weight ao_w(i).
{_ao_taps_source(cfg)}
}};

// The MLP: its block of the parameter vector starts at `offset` and holds
// `size` floats: W_0 at w0, W_l (l = 1 .. layers - 2) at w1 + (l - 1) * hidden^2,
// the output layer's weights at wo, b_l at b0 + l * hidden, the output bias
// at bo, beta at `beta`.  The kernel's tile (ops/scene_program.py::neural_tile):
// the width padded to hp; the H x H matrices resident in shared memory,
// split, at qstride quads a pair of rows, or streamed in panels of panel_rows
// float32 rows at `stride` floats; the shared layout in floats.
struct Mlp {{
  static constexpr int hidden = {H};
  static constexpr int layers = {L};
  static constexpr int offset = {lay.offset};
  static constexpr int size = {lay.size};
  static constexpr int w0 = {w[0]};
  static constexpr int w1 = {w1};
  static constexpr int wo = {w[L - 1]};
  static constexpr int b0 = {b[0]};
  static constexpr int bo = {b[L - 1]};
  static constexpr int beta = {lay.beta_offset};
  static constexpr int hp = {tile.hp};
  static constexpr int stride = {tile.stride};
  static constexpr int qstride = {tile.qstride};
  static constexpr int min_blocks = {max(1, tile.min_threads // int(nc.block_rays))};  // blocks an SM holds at once
  static constexpr int panel_rows = {tile.panel_rows};
  static constexpr bool resident = {_c_bool(tile.resident)};
  static constexpr bool vec4 = {_c_bool(tile.vec4)};  // 16-byte copies of the H x H rows
{sm}
}};
"""
