"""The least time the card could take for a launch's work, from the frozen
tables of ``portbench/work`` and the reference's own march counts; never
from the program's generated code or its counters.

A distance evaluation costs every node of the scene tree, every operand of
every union included, as the shader evaluates them
(``work/nodes/<op>.json``).  Around it the shader's phases
(``work/phases.json``): a pixel's ray, normal (six evaluations), shadow
ray set-up and shading; a primary step's and a shadow step's bookkeeping.
The fit step adds, a pixel, the hit's gradient (one evaluation and one
reverse), the implicit re-attachment's and the six normal taps' reverses,
the shading's and the normal's reverses, the residual and its reverse.

The bound is the larger of the FP32 operations over the FP32 peak, the
special-function operations over the SFU peak and the bytes over the
memory rate; bytes count the inputs once and the outputs once.  A kernel
that skips work the shader does (a union operand that cannot win) reads a
higher share, and that is a real gain: the same pictures for less time.
"""

from __future__ import annotations

import json
import pathlib

from portbench.reference.scene import walk

WORK = pathlib.Path(__file__).resolve().parents[1] / "work"

# The H100 SXM's peaks at its 700 W limit: 67 TFLOP/s of FP32 outside the
# tensor cores (an FMA two operations) and 3.35 TB/s of HBM3 (NVIDIA's data
# sheet); the special-function units 16 results a clock an SM (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0) on 132 SMs
# at the 1.98 GHz boost clock.
FP32_PEAK = 67e12
SFU_PEAK = 132 * 16 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
#: What K1 writes a pixel: the RGB, hit distance, shadow and AO planes.
K1_OUT_BYTES = 6 * 4
#: What the fit step reads a pixel: the target's three channels.
K3_IN_BYTES = 3 * 4


def _load(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def phases() -> dict:
    return {k: (v["fp"], v["sfu"]) for k, v in _load(WORK / "phases.json").items()}


def scene_cost(spec: dict) -> dict:
    """``{"eval": (fp, sfu), "bwd": (fp, sfu)}`` of one evaluation of the tree."""
    fp = sfu = bfp = bsfu = 0
    for _, node in walk(spec):
        c = _load(WORK / "nodes" / f"{node['op']}.json")
        fp, sfu, bfp, bsfu = fp + c["fp"], sfu + c["sfu"], bfp + c["bwd_fp"], bsfu + c["bwd_sfu"]
    return {"eval": (fp, sfu), "bwd": (bfp, bsfu)}


def _add(*terms):
    return tuple(sum(n * x[i] for n, x in terms) for i in range(2))


def render_ops(spec: dict, counts: dict) -> tuple:
    """``(fp, sfu)`` of a forward render with the march ``counts``
    (``pixels``, ``primary``, ``shadow``: evaluations summed over the image)."""
    ph, sc = phases(), scene_cost(spec)
    n = counts["pixels"]
    return _add((n, ph["raygen"]), (n, ph["normal"]), (6 * n, sc["eval"]), (n, ph["shadow_setup"]),
                (n, ph["shade"]), (counts["primary"], sc["eval"]), (counts["primary"], ph["primary_step"]),
                (counts["shadow"], sc["eval"]), (counts["shadow"], ph["shadow_step"]))


def fit_ops(spec: dict, counts: dict) -> tuple:
    """``(fp, sfu)`` of a fit step: the forward render's and the reverse's."""
    ph, sc = phases(), scene_cost(spec)
    n = counts["pixels"]
    rev = _add((n, sc["eval"]), (8 * n, sc["bwd"]), (n, ph["normal_bwd"]), (n, ph["shade_bwd"]),
               (n, ph["residual"]), (n, ph["residual_bwd"]))
    fwd = render_ops(spec, counts)
    return fwd[0] + rev[0], fwd[1] + rev[1]


def bound_s(ops: tuple, nbytes: float) -> float:
    return max(ops[0] / FP32_PEAK, ops[1] / SFU_PEAK, nbytes / HBM_BYTES_PER_S)


def k1_bound_s(spec: dict, counts: dict, n_params: int) -> float:
    """K1's bound for one frame."""
    return bound_s(render_ops(spec, counts), counts["pixels"] * K1_OUT_BYTES + 4 * (30 + n_params))


def k3_bound_s(spec: dict, counts: dict, n_params: int) -> float:
    """K3's bound, with its column total, for one step."""
    return bound_s(fit_ops(spec, counts), counts["pixels"] * K3_IN_BYTES + 4 * (30 + n_params) + 8 * (n_params + 31))
