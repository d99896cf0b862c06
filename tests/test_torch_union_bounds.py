"""The lower bounds by which the ray form's hard unions skip an operand that
cannot win (``sdf3d_tpu_torch/ops/scene_program.py::_ray_union``), held on
the g++ host form of the generated ray program.

For each node kind with a bound, 10⁵ seeded ``(ray, t)`` a kind (near the
surface, grazing, through the centre, far, ``t`` near ``max_distance``,
coordinates up to 100, and along the direction in which the bound is tight)
and a parameter vector a sample:

- the scene ``X`` alone: ``Scene::Ray::lower(t)`` (the bound the union
  reads) is at most ``eval(t)`` bit for bit, or ``eval(t)`` is NaN;
- ``Union(plane, X)`` and ``Union(X, plane)``, the plane placed a sample so
  that its value falls between the bound and ``X``'s value, at ``X``'s
  value and around them: wherever the operand was skipped (the other
  operand's value below the bound) its value is strictly above the kept
  one, and the union's value equals ``fminf`` of the two operands' values
  computed apart (no skip), bit for bit.

The scenes share one shared library, each header in a namespace of its own,
built twice: as the kernels' host forms are (no FMA), and with products and
adds contracted into FMAs (``-mfma -ffp-contract=fast``, where the CPU has
FMA), as nvcc may contract them.  The contracted build holds the first
property alone: the compiler contracts an operand's code in one scene
otherwise than in another (the torus's square root of a quadratic that
cancels moves by 1e-4 then), so operands computed apart are not the union's
there.  No card, no nvcc."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.ops import KernelConfig, cuda_scene_source
from sdf3d_tpu_torch.ops.scene_program import count_params

sdf = tt.sdf
CSRC = pathlib.Path(tt.__file__).parent / "ops" / "csrc"
N = 100_000
MAX_T = float(tt.REFERENCE_CONFIG.march.max_distance)


def _sphere():
    return sdf.sphere((0.0, 0.0, 0.0), 1.0)


def _box():
    return sdf.box(half_extents=(0.5, 0.5, 0.5))


def _round_box():
    return sdf.round_box(half_extents=(0.5, 0.5, 0.5), corner_radius=0.1)


def _torus():
    return sdf.torus(major=0.5, minor=0.1)


def _capsule():
    return sdf.capsule((-0.5, 0.0, 0.0), (0.5, 0.0, 0.0), 0.2)


def _cylinder():
    return sdf.cylinder(radius=0.3, half_height=0.5)


#: Each kind: the scene (its structure; the parameters are drawn a sample)
#: and the draw of its parameters, ``draw(rng, n) -> (params (n, P),
#: centre (n, 3), size (n,), tight (n, 3))``: the centre and size place the
#: rays, and along ``tight`` (a unit vector) from the centre the distance is
#: ``|p − centre| − size``, where the bound has no slack but its margins.
def _unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _centre(rng, n):
    c = rng.uniform(-2.0, 2.0, (n, 3))
    far = rng.random(n) < 0.1
    c[far] = rng.uniform(-100.0, 100.0, (int(far.sum()), 3))
    return c


def _draw_sphere(rng, n):
    c = _centre(rng, n)
    r = rng.uniform(0.01, 2.0, n)
    r[rng.random(n) < 0.05] *= -0.05
    return np.column_stack([c, r]), c, r, _unit(rng.normal(size=(n, 3)))


def _draw_box(rng, n, rounded=False):
    c = _centre(rng, n)
    h = rng.uniform(0.01, 1.5, (n, 3))
    r = rng.uniform(0.0, 0.3, n) if rounded else np.zeros(n)
    corner = h * rng.choice([-1.0, 1.0], (n, 3))
    cols = [c, h] + ([r] if rounded else [])
    return np.column_stack(cols), c, np.linalg.norm(h, axis=1) + r, _unit(corner)


def _draw_torus(rng, n):
    c = _centre(rng, n)
    major, minor = rng.uniform(0.1, 1.5, n), rng.uniform(0.01, 0.5, n)
    major[rng.random(n) < 0.1] *= 1e-3
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    return np.column_stack([c, major, minor]), c, major + minor, np.column_stack(
        [np.cos(phi), np.zeros(n), np.sin(phi)])


def _draw_capsule(rng, n):
    c = _centre(rng, n)
    half = rng.uniform(-1.0, 1.0, (n, 3))
    r = rng.uniform(0.01, 0.5, n)
    return np.column_stack([c - half, c + half, r]), c, np.linalg.norm(half, axis=1) + r, _unit(
        half * rng.choice([-1.0, 1.0], (n, 1)))


def _draw_cylinder(rng, n):
    c = _centre(rng, n)
    r, hh = rng.uniform(0.05, 1.0, n), rng.uniform(0.05, 1.0, n)
    r[rng.random(n) < 0.1] *= 1e-3
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    rim = np.column_stack([r * np.cos(phi), hh * rng.choice([-1.0, 1.0], n), r * np.sin(phi)])
    return np.column_stack([c, r, hh]), c, np.hypot(r, hh), _unit(rim)


def _draw_translate_box(rng, n):
    p, c, size, tight = _draw_box(rng, n)
    shift = rng.uniform(-1.0, 1.0, (n, 3))
    return np.column_stack([p, shift]), c + shift, size, tight


def _draw_smooth(rng, n):
    ps, cs, rs, ts = _draw_sphere(rng, n)
    pb, cb, rb, tb = _draw_box(rng, n, rounded=True)
    pb[:, :3] = cs + rng.uniform(-0.5, 0.5, (n, 3))
    k = rng.uniform(0.0, 0.4, n)
    k[rng.random(n) < 0.3] *= 1e-4
    return np.column_stack([ps, pb, k]), cs, rs, ts


def _draw_union(rng, n):
    pt, ct, rt, tt_ = _draw_torus(rng, n)
    pc, cc, rc, tc = _draw_capsule(rng, n)
    pc[:, :6] += np.tile(ct - cc, 2) + np.tile(rng.uniform(-1.0, 1.0, (n, 3)), 2)
    return np.column_stack([pt, pc]), ct, rt, tt_


def _draw_chain(rng, n):
    parts = [_draw_sphere(rng, n) for _ in range(3)]
    c0 = parts[0][1]
    for p, _, _, _ in parts[1:]:
        p[:, :3] = c0 + rng.uniform(-0.6, 0.6, (n, 3))
    k = rng.uniform(0.0, 0.3, (n, 2))
    return np.column_stack([parts[0][0], parts[1][0], k[:, 0], parts[2][0], k[:, 1]]), c0, parts[0][2], parts[0][3]


KINDS = {
    "sphere": (_sphere, _draw_sphere),
    "box": (_box, _draw_box),
    "round_box": (_round_box, lambda rng, n: _draw_box(rng, n, rounded=True)),
    "torus": (_torus, _draw_torus),
    "capsule": (_capsule, _draw_capsule),
    "cylinder": (_cylinder, _draw_cylinder),
    "translate_box": (lambda: sdf.translate(_box(), (0.1, 0.2, 0.3)), _draw_translate_box),
    "smooth_union": (lambda: sdf.smooth_union(_sphere(), _round_box(), k=0.1), _draw_smooth),
    "union": (lambda: sdf.union(_torus(), _capsule()), _draw_union),
    "smooth_chain": (lambda: sdf.smooth_union(sdf.smooth_union(_sphere(), _sphere(), k=0.1), _sphere(), k=0.1),
                     _draw_chain),
}

SHIM = r"""
#include "render_kernel.cuh"
{includes}

// Scene k of the namespaces above over n samples: rays (n, 7: o, d, t) and
// a parameter row a sample; eval(t) and lower(t).
template <class S>
static void run(const float* rays, const float* prm, int P, int n, float* value, float* lower) {{
  for (int i = 0; i < n; ++i) {{
    const float* r = rays + 7 * i;
    typename S::Ray ray;
    ray.setup(r[0], r[1], r[2], r[3], r[4], r[5], prm + static_cast<long>(i) * P);
    value[i] = ray.eval(r[6]);
    lower[i] = ray.lower(r[6]);
  }}
}}

extern "C" int sdf3d_bounds_host(int k, const float* rays, const float* prm, int P, int n, float* value,
                                 float* lower) {{
  switch (k) {{
{cases}
  }}
  return 1;
}}

// fminf of two value arrays, as the union takes it.
extern "C" void sdf3d_fminf_host(const float* a, const float* b, int n, float* out) {{
  for (int i = 0; i < n; ++i) out[i] = fminf(a[i], b[i]);
}}
"""

_LIB = {}


def _scenes(kind):
    make = KINDS[kind][0]
    plane = sdf.ground_plane()
    return {"x": make(), "plane": plane, "ax": sdf.union(sdf.ground_plane(), make()),
            "xa": sdf.union(make(), sdf.ground_plane())}


def _library(tmp_path_factory, contract: bool):
    if contract in _LIB:
        return _LIB[contract], _LIB["index"]
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    if contract and " fma " not in " " + pathlib.Path("/proc/cpuinfo").read_text().replace("\n", " ") + " ":
        pytest.skip("the CPU has no FMA")
    out = tmp_path_factory.mktemp("bounds")
    # One header a distinct text (``#pragma once`` takes equal files for one).
    index, headers, includes, cases = {}, {}, [], []
    for kind in KINDS:
        for role, scene in _scenes(kind).items():
            header = cuda_scene_source(scene, tt.REFERENCE_CONFIG, KernelConfig())
            if header not in headers:
                k = headers[header] = len(headers)
                (out / f"scene{k}.cuh").write_text(header)
                includes.append(f'namespace s{k} {{\n#include "scene{k}.cuh"\n}}')
                cases.append(f"    case {k}: run<s{k}::Scene>(rays, prm, P, n, value, lower); return 0;")
            index[(kind, role)] = headers[header]
    (out / "shim.cpp").write_text(SHIM.format(includes="\n".join(includes), cases="\n".join(cases)))
    lib = out / "libbounds_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-Wno-unused-parameter",
           "-Wno-unused-function", *(["-mfma", "-ffp-contract=fast"] if contract else []), "-I", str(CSRC), "-I",
           str(out), str(out / "shim.cpp"), "-o", str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    handle = ctypes.CDLL(str(lib))
    handle.sdf3d_bounds_host.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p]
    handle.sdf3d_fminf_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    _LIB.update({contract: handle, "index": index})
    return handle, index


def _run(lib, k, rays, prm):
    rays, prm = np.ascontiguousarray(rays, np.float32), np.ascontiguousarray(prm, np.float32)
    n = rays.shape[0]
    value, lower = np.empty(n, np.float32), np.empty(n, np.float32)
    assert lib.sdf3d_bounds_host(k, rays.ctypes.data, prm.ctypes.data, prm.shape[1], n, value.ctypes.data,
                                 lower.ctypes.data) == 0
    return value, lower


def _rays(rng, centre, size, tight):
    """(n, 7) rays ``(o, d, t)`` in six regimes: near the surface, grazing
    it, through the centre, far (coordinates up to 100), ``t`` near
    ``max_distance``, and along ``tight`` towards the centre from up to 100
    away (the bound's least slack); float64 then rounded."""
    n = centre.shape[0]
    regime = rng.integers(0, 6, n)
    size = np.abs(size) + 0.05
    u = _unit(rng.normal(size=(n, 3)))
    p = centre + u * (size * rng.uniform(0.3, 1.7, n))[:, None]
    d = rng.normal(size=(n, 3))
    graze = regime == 1
    d[graze] = np.cross(u[graze], d[graze])
    through = regime == 2
    p[through] = centre[through]
    d = _unit(d)
    t = rng.uniform(0.0, MAX_T, n)
    t[regime == 4] = rng.uniform(0.99 * MAX_T, MAX_T, int((regime == 4).sum()))
    o = p - t[:, None] * d
    far = regime == 3
    o[far] = rng.uniform(-100.0, 100.0, (int(far.sum()), 3))
    along = regime == 5
    gap = 10.0 ** rng.uniform(-4.0, 2.0, n)
    o[along] = (centre + tight * (size + gap)[:, None])[along]
    d[along] = -tight[along]
    t[along] = (gap * rng.uniform(0.0, 1.2, n))[along]
    return np.column_stack([o, d, t])


@pytest.mark.parametrize("contract", [False, True], ids=["no_fma", "fma"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_union_bound_is_below_the_value_and_keeps_the_union(kind, contract, tmp_path_factory):
    lib, index = _library(tmp_path_factory, contract)
    rng = np.random.default_rng(sorted(KINDS).index(kind) + 2000)
    prm, centre, size, tight = KINDS[kind][1](rng, N)
    assert prm.shape[1] == count_params(KINDS[kind][0]())
    rays = _rays(rng, centre, size, tight)
    value, lower = _run(lib, index[(kind, "x")], rays, prm)

    # The bound is below the value the step computes, bit for bit.
    bad = ~(lower <= value) & ~np.isnan(value)
    assert not bad.any(), f"{kind}: {int(bad.sum())} samples with lower > value, e.g. {rays[bad][:3]}, " \
                          f"{prm[bad][:3]}, {lower[bad][:3]}, {value[bad][:3]}"
    assert np.isfinite(lower).mean() > 0.99

    if contract:
        return
    # The plane (0, 1, 0, off) a sample: its value off the ray's height
    # between the bound and the value, at the value and around both.
    f = rng.uniform(-1.0, 1.3, N)
    target = lower + f * (value - lower)
    at = rng.random(N) < 0.3
    target[at] = value[at] + rng.integers(-4, 5, int(at.sum())) * np.spacing(np.abs(value[at]))
    off = (rays[:, 1] + rays[:, 4] * rays[:, 6]) - target
    plane = np.column_stack([np.zeros(N), np.ones(N), np.zeros(N), off])
    va, _ = _run(lib, index[(kind, "plane")], rays, plane)
    skipped = va < lower
    assert skipped.mean() > 0.2, f"{kind}: only {skipped.mean():.3f} of the samples skip"
    above = (value > va) | np.isnan(value)
    assert above[skipped].all(), f"{kind}: a skipped operand at or below the kept one: {value[skipped & ~above][:3]}"
    for role, cols in (("ax", [plane, prm]), ("xa", [prm, plane])):
        got, _ = _run(lib, index[(kind, role)], rays, np.column_stack(cols))
        want = np.empty(N, np.float32)
        a, b = (va, value) if role == "ax" else (value, va)
        lib.sdf3d_fminf_host(a.ctypes.data, b.ctypes.data, N, want.ctypes.data)
        diff = got.view(np.uint32) != want.view(np.uint32)
        assert not diff.any(), f"{kind} {role}: {int(diff.sum())} unions differ from fminf, e.g. " \
                               f"{got[diff][:3]} against {want[diff][:3]}"
    print(f"\n[measured] {kind}: skipped {skipped.mean():.3f}, value - lower median "
          f"{float(np.median((value - lower)[np.isfinite(value - lower)])):.3g}")
