"""Count the reference's floating-point operations, one ray at a time.

Each torch call of the reference, run on a single ray under a
``TorchFunctionMode``, counts by the elements it computes: an elementwise
operation (arithmetic, compare, select, clamp, min or max) one FP32
operation an element; a reduction one less than the elements it reduces; a
square root, logarithm or tangent one FP32 and one special-function
operation an element; a division one FP32 operation an element and one
special-function operation (the reciprocal) for each element of its
divisor, none for a constant divisor; a power of a constant exponent a
product, of a tensor exponent a product and two special-function operations
(the logarithm and the exponential).  Boolean logic, indexing and tensor
creation count nothing.  The reverse pass of a node is counted by rule: two
FP32 operations for each forward one (a product's two partial products, an
accumulate) and its special-function operations again.

    python -m portbench.work.count     # JSON: the node and phase tables
"""

from __future__ import annotations

import json
import math

import torch
from torch.overrides import TorchFunctionMode

_ELEMENTWISE = {"add", "sub", "mul", "neg", "rsub", "clamp", "clamp_min", "clamp_max", "minimum", "maximum",
                "where", "lt", "le", "gt", "ge", "eq", "ne", "abs", "__add__", "__radd__", "__sub__", "__rsub__",
                "__mul__", "__rmul__", "__neg__", "__lt__", "__le__", "__gt__", "__ge__", "__eq__", "__ne__",
                "add_", "sub_", "mul_", "addcmul_"}
_UNARY_SPECIAL = {"sqrt", "log", "tan", "reciprocal", "rsqrt"}
_DIVIDE = {"div": 1, "__truediv__": 1, "__rtruediv__": 0, "div_": 1}
_POWER = {"pow": 1, "__pow__": 1, "__rpow__": 0}
_REDUCE = {"sum"}


def _name(func) -> str:
    return getattr(func, "__name__", str(func))


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


class OpCounter(TorchFunctionMode):
    """``fp`` and ``sfu``: the operations of the torch calls made under it."""

    def __init__(self):
        super().__init__()
        self.fp = 0
        self.sfu = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not isinstance(out, torch.Tensor) or not (out.is_floating_point() or out.dtype == torch.bool):
            return out
        name, n = _name(func), out.numel()
        if name in _DIVIDE:
            self.fp += n
            self.sfu += _numel(args[_DIVIDE[name]])
        elif name in _POWER:
            self.fp += n
            self.sfu += 2 * n if isinstance(args[_POWER[name]], torch.Tensor) else 0
        elif name in _UNARY_SPECIAL:
            self.fp += n
            self.sfu += n
        elif name in _ELEMENTWISE:
            self.fp += n
        elif name in _REDUCE:
            self.fp += args[0].numel() - n
        return out


def count(fn, *args) -> tuple:
    """``(fp, sfu)`` of ``fn(*args)``."""
    with OpCounter() as c:
        fn(*args)
    return c.fp, c.sfu


def reverse(fp: int, sfu: int) -> tuple:
    """The rule for a reverse pass: ``(2·fp, sfu)``."""
    return 2 * fp, sfu


def node_costs() -> dict:
    """``op -> {"fp", "sfu", "bwd_fp", "bwd_sfu"}`` for the reference's nodes,
    a node's own operations alone (children are costed apart)."""
    from portbench.reference.nodes import mandelbulb, plane, sphere, union

    p = torch.tensor([[0.1, 0.3, -0.2]])
    one = torch.tensor(1.0)
    vec = torch.tensor([0.0, 1.0, 0.0])
    kid = lambda q: q[:, 0] * 0.0  # noqa: E731  (a child, counted apart: its product is taken out below)
    cases = {
        "plane": (plane.distance, (p, {"normal": vec, "offset": one}, [], {})),
        "sphere": (sphere.distance, (p, {"center": vec, "radius": one}, [], {})),
        "union": (union.distance, (p, {}, [kid, kid], {})),
        "mandelbulb": (mandelbulb.distance, (p, {"center": vec, "scale": one}, [], {"iterations": 6})),
    }
    out = {}
    for op, (fn, args) in cases.items():
        fp, sfu = count(fn, *args)
        if op == "union":
            fp -= 2  # the two stand-in children's products
        bf, bs = reverse(fp, sfu)
        out[op] = {"fp": fp, "sfu": sfu, "bwd_fp": bf, "bwd_sfu": bs}
    return out


def phase_costs() -> dict:
    """The shader's operations around its distance evaluations, a pixel or a
    march step at a time (``(fp, sfu)`` each): ray generation; a primary
    step's bookkeeping; a shadow step's; the normal's six taps' offsets and
    its normalisation; the shadow ray's set-up; Blinn-Phong; the fit step's
    residual and square; and the reverse of the shading and the residual
    (by the rule of :func:`reverse`)."""
    from portbench.reference import shader

    cam = {"position": torch.tensor([0.0, 0.2, 2.0]), "c2w": torch.eye(3), "fov_deg": torch.tensor(60.0)}
    light = {"position": torch.tensor([5.0, 5.0, 0.0]), "ambient": torch.tensor(0.1)}
    mat = {"ambient": torch.tensor([0.0, 0.2, 0.8]), "diffuse": torch.tensor([0.0, 0.2, 0.8]),
           "specular": torch.tensor([0.5, 0.5, 0.5]), "shininess": torch.tensor(12.0)}
    zero = lambda q: q[:, 0] * 0.0 + 1.0  # noqa: E731  (a stand-in distance, taken out below)
    zf, _ = count(zero, torch.zeros(1, 3))
    one_step = {"march_steps": 1, "shadow_steps": 2, "max_distance": 100.0, "epsilon": 0.01, "shadow_k": 10.0}
    o, d = torch.zeros(1, 3), torch.tensor([[0.0, 0.0, -1.0]])
    # A pixel's rays less the image's constants: two pixels less one.
    raygen = tuple(a - b for a, b in zip(count(shader.rays, cam, 2, 1), count(shader.rays, cam, 1, 1)))
    prim = count(shader.sphere_trace, zero, o, d, one_step)
    # Two shadow steps minus one: the second step's bookkeeping (the first skips the intersection term).
    sh2 = count(shader.soft_shadow, zero, o, d, one_step)
    sh1 = count(shader.soft_shadow, zero, o, d, dict(one_step, shadow_steps=1))
    p = torch.tensor([[0.1, 0.3, -0.2]])
    n = torch.tensor([[0.0, 1.0, 0.0]])
    nrm = count(shader.normals, zero, p, 0.01)
    setup = count(lambda: (p + n * 0.02, shader.normalize(light["position"] - p)))
    shade = count(shader.blinn_phong, p, n, o, light, mat, torch.ones(1))
    tgt = torch.zeros(1, 3)
    res = shader.blinn_phong(p, n, o, light, mat, torch.ones(1))
    residual = count(lambda: (lambda r: (r * r).sum(-1))(res - tgt))
    out = {
        "raygen": raygen,
        "primary_step": (prim[0] - zf, prim[1]),
        "shadow_step": (sh2[0] - sh1[0] - zf, sh2[1] - sh1[1]),
        "normal": (nrm[0] - 6 * zf, nrm[1]),
        "shadow_setup": setup,
        "shade": shade,
        "residual": residual,
        "shade_bwd": reverse(*shade),
        "residual_bwd": reverse(*residual),
        "normal_bwd": reverse(nrm[0] - 6 * zf, nrm[1]),
    }
    return {k: {"fp": int(v[0]), "sfu": int(v[1])} for k, v in out.items()}


def main() -> int:
    print(json.dumps({"nodes": node_costs(), "phases": phase_costs()}, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
