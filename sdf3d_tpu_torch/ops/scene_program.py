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
``C`` clamped ≥ 0 at setup.  Every binary operation is parenthesised in the
C text, so the compiler keeps the same association (it may still contract
``a*b + c`` into one FMA).
"""

from __future__ import annotations

import math
import re
from typing import Callable

import numpy as np
import torch

from sdf3d_tpu_torch.sdf import csg, primitives
from sdf3d_tpu_torch.sdf.node import SDFNode

GetP = Callable[[int], object]


def leaves(node: SDFNode):
    """Every numeric leaf of the scene, in ``tree_flatten`` order (fields in
    declaration order, depth first)."""
    for name in node.fields:
        v = getattr(node, name)
        if isinstance(v, SDFNode):
            yield from leaves(v)
        else:
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


class _TorchOps:
    """Numeric backend: tensors (planes or 0-d parameters)."""

    @staticmethod
    def sqrt(x):
        return torch.sqrt(x)

    @staticmethod
    def maximum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, min=b)
        return torch.maximum(a, b)

    minimum = staticmethod(torch.minimum)

    @staticmethod
    def hoist(x):
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


def _c(x) -> str:
    return x.s if isinstance(x, CExpr) else c_float(x)


class _COps:
    """Symbolic backend: C expressions; ``hoist`` turns a per-ray setup
    value into a field of ``Scene::Ray`` assigned in ``setup``."""

    def __init__(self):
        self.fields: list[str] = []
        self.setup: list[str] = []

    @staticmethod
    def sqrt(x):
        return CExpr(f"sqrtf({_c(x)})")

    @staticmethod
    def maximum(a, b):
        return CExpr(f"fmaxf({_c(a)}, {_c(b)})")

    @staticmethod
    def minimum(a, b):
        return CExpr(f"fminf({_c(a)}, {_c(b)})")

    def hoist(self, x):
        name = f"h{len(self.fields)}"
        self.fields.append(name)
        self.setup.append(f"{name} = {_c(x)};")
        return CExpr(name)


# ---------------------------------------------------------------------------
# Point-form emitters: (node, px, py, pz, getp, off, m) -> distance.
# ---------------------------------------------------------------------------


def _len3(x, y, z, m):
    return m.sqrt(x * x + y * y + z * z)


def _sphere(n, px, py, pz, getp, off, m):
    cx, cy, cz, r = (getp(off + i) for i in range(4))
    return _len3(px - cx, py - cy, pz - cz, m) - r


def _plane(n, px, py, pz, getp, off, m):
    nx, ny, nz, d = (getp(off + i) for i in range(4))
    return px * nx + py * ny + pz * nz - d


def _union(n, px, py, pz, getp, off, m):
    da = _emit(n.a, px, py, pz, getp, off, m)
    db = _emit(n.b, px, py, pz, getp, off + count_params(n.a), m)
    return m.minimum(da, db)


_HANDLERS = {
    primitives.Sphere: _sphere,
    primitives.Plane: _plane,
    csg.Union: _union,
}


def _no_emitter(node):
    return NotImplementedError(
        f"no render-kernel emitter for scene node {type(node).__name__}; the port "
        "supports Sphere, Plane and Union so far (sdf3d_tpu_torch/ops/scene_program.py)"
    )


def _emit(node, px, py, pz, getp: GetP, off: int, m):
    h = _HANDLERS.get(type(node))
    if h is None:
        raise _no_emitter(node)
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
# exact tie; sqrt's derivative is 0.5/sqrt(x)), which the JAX package's
# jax.vjp of the same emitters applies.
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


class _Tape:
    """Symbolic backend that records operations in order: ``nodes[i]`` is
    ``("leaf", c_name)`` or ``(op, a, b)`` with operands a node index or a
    float constant."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self.named: dict[str, _Var] = {}

    def leaf(self, name: str) -> _Var:
        if name not in self.named:
            self.nodes.append(("leaf", name))
            self.named[name] = _Var(self, len(self.nodes) - 1)
        return self.named[name]

    def op(self, op: str, a, b=None) -> _Var:
        def ref(x):
            return x.i if isinstance(x, _Var) else float(x)

        self.nodes.append((op, ref(a), None if b is None else ref(b)))
        return _Var(self, len(self.nodes) - 1)

    def sqrt(self, x):
        return self.op("sqrt", x)

    def minimum(self, a, b):
        return self.op("min", a, b)

    def maximum(self, a, b):
        return self.op("max", a, b)


# Forward values each adjoint rule reads: operands, or the result itself.
_NEEDS = {"+": "", "-": "", "*": "ab", "/": "ab", "sqrt": "r", "min": "ab", "max": "ab"}


def _adjoints(op: str, g: str, a: str, b: str, r: str):
    """C terms of the adjoints of the operands ``a``, ``b`` of ``r = op(a, b)``
    given the adjoint ``g`` of ``r`` (lax's derivative rules)."""
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
    return f"({g} * sdf3d::{op}_adj({a}, {b}))", f"({g} * sdf3d::{op}_adj({b}, {a}))"


def _reverse_source(scene: SDFNode, with_params: bool) -> str:
    """C statements for the reverse pass of the point form at (px, py, pz)
    with the output adjoint ``g``: ``dp[k] += g·∂f/∂p_k`` when
    ``with_params``, and ``(dpx, dpy, dpz) = g·∇ₚf``."""
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
            reach.append(any(is_var(x) and reach[x] for x in args))

    rev, needed = [], set()
    for i in range(len(nodes) - 1, -1, -1):
        op, a, b = nodes[i] if nodes[i][0] != "leaf" else (None, None, None)
        if op is None or not reach[i]:
            continue
        needed.update(x for flag, x in zip("ab", (a, b)) if flag in _NEEDS[op] and is_var(x))
        if "r" in _NEEDS[op]:
            needed.add(i)
        terms = _adjoints(op, f"a{i}", val(a), None if b is None else val(b), f"v{i}")
        for x, t in zip((a, b), terms):
            if is_var(x) and reach[x]:
                rev.append(f"a{x} += {t};")

    # Forward values: the needed ones and everything they are computed from.
    for i in range(len(nodes) - 1, -1, -1):
        if i in needed and nodes[i][0] != "leaf":
            needed.update(x for x in nodes[i][1:] if is_var(x))
    fwd = []
    for i, (op, *args) in enumerate(nodes):
        if i not in needed:
            continue
        if op == "leaf":
            expr = args[0]
        elif op == "sqrt":
            expr = f"sqrtf({val(args[0])})"
        elif op in ("min", "max"):
            expr = f"f{op}f({val(args[0])}, {val(args[1])})"
        else:
            expr = f"({val(args[0])} {op} {val(args[1])})"
        fwd.append(f"const float v{i} = {expr};")

    decl = [f"float a{i} = {'g' if i == root else '0.0f'};" for i in range(len(nodes)) if reach[i]]
    out = []
    for name, var in tape.named.items():
        a = f"a{var.i}" if reach[var.i] else "0.0f"
        if name in wanted:
            out.append(f"d{name} = {a};")
        elif with_params and reach[var.i]:
            out.append(f"dp[{name[2:-1]}] += {a};")
    return "\n".join("    " + s for s in fwd + decl + rev + out)


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


def _ray_union(n, ox, oy, oz, dx, dy, dz, getp, off, m):
    ea = _ray_emit(n.a, ox, oy, oz, dx, dy, dz, getp, off, m)
    eb = _ray_emit(n.b, ox, oy, oz, dx, dy, dz, getp, off + count_params(n.a), m)
    return lambda t: m.minimum(ea(t), eb(t))


_RAY_HANDLERS = {
    primitives.Sphere: _ray_sphere,
    primitives.Plane: _ray_plane,
    csg.Union: _ray_union,
}


def _ray_emit(node, ox, oy, oz, dx, dy, dz, getp: GetP, off: int, m):
    h = _RAY_HANDLERS.get(type(node))
    if h is None:
        raise _no_emitter(node)
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


def _ao_source(cfg) -> str:
    """Unrolled AO taps with the JAX package's constants: tap ``i`` samples
    at ``h = step·i`` with weight ``falloff^(i-1)`` (both rounded to
    float32, as JAX's weak-typed Python scalars are)."""
    if not cfg.ao.enabled:
        return "    return 1.0f;"
    lines = ["    float occ = 0.0f;"]
    weight = 1.0
    for tap in range(1, cfg.ao.samples + 1):
        h = c_float(cfg.ao.step * tap)
        lines.append(
            f"    occ = (occ + ({c_float(weight)} * ({h} - "
            f"sdf((hx + ({h} * nx)), (hy + ({h} * ny)), (hz + ({h} * nz)), p))));"
        )
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


def cuda_scene_source(scene: SDFNode, cfg, kc, wrt_uniforms: bool = True, frozen_slots: tuple = ()) -> str:
    """The generated header ``sdf3d_scene.cuh`` for ``scene`` under the
    static settings ``cfg`` (RenderConfig) and ``kc`` (KernelConfig).

    ``wrt_uniforms`` and ``frozen_slots`` are the fit kernel's static
    settings (``struct Fit``): whether it computes the uniform gradients,
    and the parameter slots whose gradient it leaves at exactly 0."""
    check_scene(scene)
    P = lambda i: CExpr(f"p[{i}]")  # noqa: E731
    point = _emit(scene, CExpr("px"), CExpr("py"), CExpr("pz"), P, 0, _COps)

    ray = _COps()
    ev = _ray_emit(scene, *(CExpr(v) for v in ("ox", "oy", "oz", "dx", "dy", "dz")), P, 0, ray)
    body = _c(ev(CExpr("t")))
    if re.search(r"p\[|\b[od][xyz]\b", body):
        raise AssertionError(f"ray-form eval reads a setup value that was not hoisted: {body}")

    mc = cfg.march
    bg = cfg.background or (0.0, 0.0, 0.0)
    normals = {"central": 0, "tetrahedron": 1}[cfg.normals]
    b = lambda v: "true" if v else "false"  # noqa: E731
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
    frozen = "".join(f"\n    dp[{k}] = 0.0f;" for k in sorted(set(frozen_slots)))
    return f"""// Generated by sdf3d_tpu_torch/ops/scene_program.py::cuda_scene_source.
// Scene: {describe(scene)}, {count_params(scene)} parameters.
#pragma once

struct Cfg {{
  static constexpr int block_w = {int(kc.block_w)};
  static constexpr int block_h = {int(kc.block_h)};
  static constexpr bool ray_sdf = {b(kc.ray_sdf)};
  static constexpr int ndc_h = {int(cfg.ndc_height or 0)};
  static constexpr int ndc_w = {int(cfg.ndc_width or 0)};
  static constexpr int march_steps = {int(mc.max_steps)};
  static constexpr float max_distance = {c_float(mc.max_distance)};
  static constexpr float epsilon = {c_float(mc.epsilon)};
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
}};

struct Scene {{
  static constexpr int n_params = {count_params(scene)};

  // Point form: distance at (px, py, pz).
  static SDF3D_HD float sdf(float px, float py, float pz, const float* p) {{
    return {_c(point)};
  }}

  // Ray form: distance at o + t*d, per-ray constants hoisted in setup().
  struct Ray {{
{fields}

    SDF3D_HD void setup(float ox, float oy, float oz, float dx, float dy, float dz, const float* p) {{
{setup}
    }}
    SDF3D_HD float eval(float t) const {{
      return {body};
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
{_reverse_source(scene, with_params=True)}
  }}

  // grad_p f at (px, py, pz) (the implicit-function denominator).
  static SDF3D_HD void sdf_grad_p(float px, float py, float pz, const float* p,
                                  float& dpx, float& dpy, float& dpz) {{
    const float g = 1.0f;
{_reverse_source(scene, with_params=False)}
  }}
{ao_bwd}}};

// Static settings of the fit kernel.
struct Fit {{
  static constexpr bool wrt_uniforms = {b(wrt_uniforms)};
  // Frozen parameter slots read exactly 0.
  static SDF3D_HD void zero_frozen(float* dp) {{{frozen}
  }}
}};
"""
