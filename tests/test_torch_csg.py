"""The flagship scene's nodes (Box, RoundBox, Torus, the hard and smooth
Intersection, Subtraction and Union) against the JAX package: each node's
``distance``, the generated C point and ray forms, and the derivatives of
the point form, both the torch backend's under ``torch.autograd`` and the
generated reverse pass (``Scene::sdf_bwd``, ``sdf_grad_p``, built with g++),
against ``jax.vjp`` of JAX's emitter, at random points and at the ties of
``abs``, ``clip`` and ``max`` with a constant."""

import ctypes
import dataclasses
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.ops.scene_program import compile_scene as jax_compile_scene
from sdf3d_tpu.ops.scene_program import compile_scene_ray as jax_compile_scene_ray
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu_torch import bench, convert
from sdf3d_tpu_torch.ops import KernelConfig, compile_scene, cuda_scene_source, scene_param_vector
from sdf3d_tpu_torch.ops._build import CSRC, SCENE_HEADER
from sdf3d_tpu_torch.ops.scene_program import _TorchOps
from test_torch_scene_program import csg_sampler

torch.set_num_threads(1)

S = s.sdf


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# The nodes' own distance, against JAX's nodes.
# ---------------------------------------------------------------------------


def _random_node(name, r):
    """A JAX node of class ``name`` with parameters drawn from ``r``."""
    def sph():
        return S.sphere(center=r.uniform(-0.5, 0.5, 3), radius=r.uniform(0.2, 0.5))

    def bx():
        return S.box(half_extents=r.uniform(0.1, 0.4, 3), center=r.uniform(-0.5, 0.5, 3))

    return {
        "Box": bx,
        "RoundBox": lambda: S.round_box(r.uniform(0.1, 0.4, 3), r.uniform(0.01, 0.1), r.uniform(-0.5, 0.5, 3)),
        "Torus": lambda: S.torus(r.uniform(0.3, 0.6), r.uniform(0.05, 0.2), r.uniform(-0.5, 0.5, 3)),
        "Intersection": lambda: S.intersection(sph(), bx()),
        "Subtraction": lambda: S.subtraction(bx(), sph()),
        "SmoothUnion": lambda: S.smooth_union(sph(), bx(), k=r.uniform(0.05, 0.3)),
        "SmoothIntersection": lambda: S.smooth_intersection(sph(), bx(), k=r.uniform(0.05, 0.3)),
        "SmoothSubtraction": lambda: S.smooth_subtraction(bx(), sph(), k=r.uniform(0.05, 0.3)),
    }[name]()


NODES = ["Box", "RoundBox", "Torus", "Intersection", "Subtraction", "SmoothUnion", "SmoothIntersection",
         "SmoothSubtraction"]


@pytest.mark.parametrize("name", NODES)
def test_node_distance_matches_jax(name):
    r = _rng(NODES.index(name))
    js = _random_node(name, r)
    ts = convert.from_jax(js)
    assert type(ts).__name__ == name
    pts = r.uniform(-1.0, 1.0, (4096, 3)).astype(np.float32)
    got = ts.distance(torch.from_numpy(pts)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(js.distance(jnp.asarray(pts))), atol=1e-6, rtol=0)


def test_box_distance_gradient_is_finite_inside():
    """``vlength_safe``: the box's gradient at interior points is JAX's
    (finite), where the plain length would give 0·inf."""
    js = S.box(half_extents=(0.3, 0.2, 0.25), center=(0.1, 0.2, 0.0))
    ts = convert.from_jax(js)
    pts = (_rng(3).uniform(-0.15, 0.15, (64, 3)) + np.array([0.1, 0.2, 0.0])).astype(np.float32)
    want = np.asarray(jax.grad(lambda p: js.distance(p).sum())(jnp.asarray(pts)))
    p = torch.from_numpy(pts).requires_grad_(True)
    ts.distance(p).sum().backward()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-6, rtol=0)
    z = torch.zeros(3, requires_grad=True)
    tt.sdf.vlength_safe(z).backward()
    assert float(z.grad.abs().max()) == 0.0


def test_operators_build_the_csg_nodes():
    a, b = tt.sdf.sphere((0.0, 0.0, 0.0), 0.5), tt.sdf.box((0.2, 0.2, 0.2))
    assert type(a | b).__name__ == "Union"
    assert type(a & b).__name__ == "Intersection"
    assert type(a - b).__name__ == "Subtraction"


# ---------------------------------------------------------------------------
# The generated C forms and reverse pass (g++), and the torch backend's
# derivatives, against JAX's emitters.
# ---------------------------------------------------------------------------

SHIM = r"""
#include "render_kernel.cuh"
#include "sdf3d_scene.cuh"

// The generated scene code alone, over n points (or rays), for the tests.
extern "C" int sdf3d_scene_host(const float* pts, const float* dirs, const float* ts, int n, const float* p,
                                float* dist, float* ray, float* dpts, float* dp, float* grad) {
  for (int i = 0; i < n; ++i) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    dist[i] = Scene::sdf(x, y, z, p);
    Scene::Ray r;
    r.setup(x, y, z, dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], p);
    ray[i] = r.eval(ts[i]);
    float* row = dp + (long)i * Scene::n_params;
    for (int k = 0; k < Scene::n_params; ++k) row[k] = 0.0f;
    Scene::sdf_bwd(x, y, z, p, 1.0f, row, dpts[3 * i], dpts[3 * i + 1], dpts[3 * i + 2]);
    Scene::sdf_grad_p(x, y, z, p, grad[3 * i], grad[3 * i + 1], grad[3 * i + 2]);
  }
  return 0;
}
"""


def _scene_library(scene, out_dir):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    (out_dir / SCENE_HEADER).write_text(cuda_scene_source(scene, tt.REFERENCE_CONFIG, KernelConfig()))
    (out_dir / "shim.cpp").write_text(SHIM)
    lib = out_dir / "libscene_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-Wno-unused-parameter",
           "-Wno-unused-function", "-I", str(CSRC), "-I", str(out_dir), str(out_dir / "shim.cpp"), "-o", str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


def _c_scene(lib, pts, dirs, ts, prm):
    n, P = pts.shape[0], prm.size
    out = {"dist": np.empty(n, np.float32), "ray": np.empty(n, np.float32), "dpts": np.empty((n, 3), np.float32),
           "dp": np.empty((n, P), np.float32), "grad": np.empty((n, 3), np.float32)}
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data  # noqa: E731
    fn = lib.sdf3d_scene_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    keep = [np.ascontiguousarray(a, np.float32) for a in (pts, dirs, ts, prm)]
    assert fn(*(ptr(a) for a in keep[:3]), n, ptr(keep[3]), *(ptr(out[k]) for k in
                                                           ("dist", "ray", "dpts", "dp", "grad"))) == 0
    return out


def _jax_scene(js, pts, dirs, ts, prm):
    """JAX's point form, ray form and ``jax.vjp`` of the point form with a
    cotangent of 1, per point: ``(dist, ray, dpts (n, 3), dp (n, P))``."""
    emit, setup = jax_compile_scene(js), jax_compile_scene_ray(js)
    prm = jnp.asarray(prm)

    def point(x, y, z, q):
        return emit(x, y, z, lambda i: q[i])

    def vjp(x, y, z, q):
        _, back = jax.vjp(point, x, y, z, q)
        return back(jnp.float32(1.0))

    x, y, z = (jnp.asarray(pts[:, i]) for i in range(3))
    dist = jax.vmap(point, (0, 0, 0, None))(x, y, z, prm)
    ray = setup((x, y, z), tuple(jnp.asarray(dirs[:, i]) for i in range(3)), lambda i: prm[i])(jnp.asarray(ts))
    gx, gy, gz, gq = jax.vmap(vjp, (0, 0, 0, None))(x, y, z, prm)
    return (np.asarray(dist), np.asarray(ray), np.stack([np.asarray(g) for g in (gx, gy, gz)], 1), np.asarray(gq))


def _torch_grads(ts, pts, prm):
    """The torch backend's point form and its ``torch.autograd`` gradient
    per point (each point with its own copy of the parameters)."""
    q = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(prm, (pts.shape[0], prm.size)))).requires_grad_(True)
    xyz = [torch.from_numpy(pts[:, i].copy()).requires_grad_(True) for i in range(3)]
    d = compile_scene(ts)(*xyz, lambda i: q[:, i])
    d.sum().backward()
    return d.detach().numpy(), np.stack([v.grad.numpy() for v in xyz], 1), q.grad.numpy()


def _random_case(js_fn, seed, lo=-1.0, hi=1.0):
    def make():
        r = _rng(seed)
        pts = r.uniform(lo, hi, (512, 3)).astype(np.float32)
        return js_fn(), pts
    return make


def _tie_case(js_fn, fix):
    """Points whose coordinates ``fix`` sets exactly (a dict axis -> value):
    the ties of the scene's operations."""
    def make():
        pts = _rng(5).uniform(-1.0, 1.0, (64, 3)).astype(np.float32)
        for axis, v in fix.items():
            pts[:, axis] = np.float32(v)
        return js_fn(), pts
    return make


def _tie_box():
    # Center x 0.25, half extent x 0.25: x = 0.25 puts |p - c| at abs(0),
    # x = 0.5 puts q_x at max(q, 0)'s tie; y = 0.9 stays outside the box,
    # so the outside length is positive.
    return S.box(half_extents=(0.25, 0.1, 0.2), center=(0.25, 0.3, -0.1))


def _planes_blend(offsets, k):
    return S.smooth_union(S.plane((0.0, 1.0, 0.0), offsets[0]), S.plane((0.0, 1.0, 0.0), offsets[1]), k=k)


GRAD_CASES = {
    "flagship": _random_case(s.flagship_scene, 11, -0.6, 0.8),
    "sampler": _random_case(csg_sampler, 12, -0.8, 0.8),
    "every_node_random": _random_case(lambda: S.union(
        _random_node("Intersection", _rng(1)), _random_node("SmoothSubtraction", _rng(2)),
        _random_node("SmoothIntersection", _rng(3)), _random_node("Torus", _rng(4)),
        _random_node("RoundBox", _rng(5))), 13, -1.5, 1.5),
    # abs at 0 and max(q, 0) at q = 0 (both +1 and 0.5 as lax gives them).
    "box_abs_at_zero": _tie_case(_tie_box, {0: 0.25, 1: 0.9}),
    "box_max_at_zero": _tie_case(_tie_box, {0: 0.5, 1: 0.9}),
    # clip at its lower (h = 0) and upper (h = 1) bound: db - da = -k or +k.
    "clip_at_lower_bound": _tie_case(lambda: _planes_blend((0.0, 0.25), 0.25), {1: 0.5}),
    "clip_at_upper_bound": _tie_case(lambda: _planes_blend((0.25, 0.0), 0.25), {1: 0.5}),
    # max(k, 1e-6) at k = 1e-6.
    "k_at_its_clamp": _random_case(lambda: S.smooth_union(S.sphere((0.0, 0.2, 0.0), 0.3),
                                                          S.round_box((0.2, 0.2, 0.2), 0.05, (0.3, 0.1, 0.0)),
                                                          k=1e-6), 14),
    # Subtraction's negation, and its max at a tie of a and -b.
    "subtraction": _random_case(lambda: S.subtraction(S.sphere((0.0, 0.0, 0.0), 0.6),
                                                      S.torus(0.4, 0.15, (0.1, 0.1, 0.0))), 15),
    "subtraction_at_tie": _tie_case(lambda: S.subtraction(S.plane((0.0, 1.0, 0.0), 0.25),
                                                          S.plane((0.0, -1.0, 0.0), 0.25)), {1: 0.0}),
    # Inside a box's core every q < 0: sqrt(0)'s infinite derivative times
    # the zero outside vector, NaN in JAX's emitter and so in the port's.
    "box_interior": _random_case(lambda: S.box((0.5, 0.5, 0.5), (0.0, 0.0, 0.0)), 16, -0.4, 0.4),
}


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    cache = {}

    def get(case, scene):
        if case not in cache:
            cache[case] = _scene_library(scene, tmp_path_factory.mktemp(case))
        return cache[case]

    return get


def _assert_grads(got, want, label):
    # Derivatives of order 1 (unit gradients, parameters); float32 in a
    # different operation order: 2e-5 absolute and relative.  NaN where JAX
    # has NaN, and nowhere else.
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=label)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg=label)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_generated_reverse_pass_matches_jax_vjp(case, libraries):
    """The generated C (g++): point form and ray form at 1e-6 / 1e-5, and the
    tape's adjoints (``sdf_bwd``: ∇ₚ and every parameter; ``sdf_grad_p``)
    against ``jax.vjp`` of JAX's emitter."""
    js, pts = GRAD_CASES[case]()
    prm = np.asarray(jax_scene_param_vector(js))
    r = _rng(21)
    dirs = r.normal(size=pts.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ts = r.uniform(0.0, 0.5, pts.shape[0]).astype(np.float32)
    got = _c_scene(libraries(case, convert.from_jax(js)), pts, dirs, ts, prm)
    dist, ray, dpts, dp = _jax_scene(js, pts, dirs, ts, prm)
    np.testing.assert_allclose(got["dist"], dist, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["ray"], ray, atol=1e-5, rtol=0)
    _assert_grads(got["dpts"], dpts, f"{case}: grad_p")
    _assert_grads(got["grad"], dpts, f"{case}: sdf_grad_p")
    _assert_grads(got["dp"], dp, f"{case}: parameters")
    if case == "box_interior":
        assert np.isnan(got["dp"]).all() and np.isnan(dp).all()
    elif case not in ("flagship", "every_node_random", "k_at_its_clamp"):  # random points may fall inside a box
        assert np.isfinite(got["dp"]).all()


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_torch_backend_grads_match_jax_vjp(case):
    """The torch backend under ``torch.autograd`` (what the plain versions
    differentiate) against ``jax.vjp`` of JAX's emitter, ties included."""
    js, pts = GRAD_CASES[case]()
    prm = np.asarray(jax_scene_param_vector(js))
    dist, _, dpts, dp = _jax_scene(js, pts, pts, np.zeros(pts.shape[0], np.float32), prm)
    d, g_pts, g_prm = _torch_grads(convert.from_jax(js), pts, prm)
    np.testing.assert_allclose(d, dist, atol=1e-6, rtol=0)
    _assert_grads(g_pts, dpts, f"{case}: grad_p")
    _assert_grads(g_prm, dp, f"{case}: parameters")


@pytest.mark.parametrize("op", ["maximum", "minimum"])
@pytest.mark.parametrize("side", ["constant_second", "constant_first"])
def test_torch_min_max_with_a_constant_split_ties(op, side):
    """``max(x, c)`` and ``min(x, c)`` with a Python constant: the adjoint
    splits 0.5/0.5 at a tie, as ``jax.vjp`` of ``jnp.maximum`` gives it
    (``torch.clamp`` would pass all of it)."""
    x = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    c = 0.0
    jfn = getattr(jnp, op)
    f = (lambda v: jfn(v, c)) if side == "constant_second" else (lambda v: jfn(c, v))
    val, back = jax.vjp(f, jnp.asarray(x))
    want = np.asarray(back(jnp.ones(4, jnp.float32))[0])
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    tfn = getattr(_TorchOps, op)
    y = tfn(xt, c) if side == "constant_second" else tfn(c, xt)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(val))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert want[1] == 0.5


def test_torch_abs_and_clip_follow_lax_at_ties():
    x = np.array([-0.5, 0.0, 0.0, 1.0, 0.3], np.float32)
    for jf, tf in ((jnp.abs, _TorchOps.abs), (lambda v: jnp.clip(v, 0.0, 1.0), lambda v: _TorchOps.clip(v, 0.0, 1.0))):
        val, back = jax.vjp(jf, jnp.asarray(x))
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = tf(xt)
        y.sum().backward()
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(val))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(back(jnp.ones(5, jnp.float32))[0]))


def test_generated_ray_form_hoists_every_setup_value():
    """The ray form's per-step code reads hoisted fields only, and a value
    hoisted twice (a box's direction, a repeated parameter) is one field."""
    src = cuda_scene_source(convert.from_jax(csg_sampler()), tt.REFERENCE_CONFIG, KernelConfig())
    setup = src[src.index("void setup("):src.index("float eval(float t)")]
    lines = [ln.strip() for ln in setup.splitlines() if ln.strip().startswith("h")]
    values = [ln.split(" = ", 1)[1] for ln in lines]
    assert len(values) == len(set(values)) > 0


# ---------------------------------------------------------------------------
# Setup files and the bench on the flagship.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_flagship_setup_file_carries_over_bit_exact(direction, tmp_path):
    js = s.flagship_scene()
    path = tmp_path / "flagship.json"
    if direction == "jax_to_port":
        S.save_setup(path, js, s.Camera.reference())
        back = tt.sdf.load_setup(path)["scene"]
        np.testing.assert_array_equal(scene_param_vector(back).numpy(), np.asarray(jax_scene_param_vector(js)))
        assert tt.ops.scene_program.describe(back) == tt.ops.scene_program.describe(convert.from_jax(js))
    else:
        tt.sdf.save_setup(path, tt.flagship_scene())
        back = S.load_setup(path)["scene"]
        np.testing.assert_array_equal(np.asarray(jax_scene_param_vector(back)), np.asarray(jax_scene_param_vector(js)))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(js)


def test_flagship_scene_matches_jax():
    ts, js = tt.flagship_scene(), s.flagship_scene()
    np.testing.assert_array_equal(scene_param_vector(ts).numpy(), np.asarray(jax_scene_param_vector(js)))
    assert scene_param_vector(ts).numel() == 21
    np.testing.assert_array_equal(scene_param_vector(convert.from_jax(js)).numpy(), scene_param_vector(ts).numpy())


@pytest.mark.parametrize("mode", ["fwd", "fwd_bwd"])
def test_bench_flagship_cell_runs_on_cpu(mode):
    out = bench.run_benchmark(width=32, height=24, scene_name="flagship", mode=mode, iters=1,
                              frames_per_dispatch=1, device="cpu")
    assert out["value"] > 0.0 and np.isfinite(out["value"])


def test_cli_renders_the_flagship(tmp_path):
    from sdf3d_tpu_torch import cli

    png = tmp_path / "flagship.png"
    assert cli.main(["render", "--scene", "flagship", "--device", "cpu", "--width", "48", "--height", "32",
                     "--out", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"



# ---------------------------------------------------------------------------
# The render bars' razor-edge rays (utils/parity.py).
# ---------------------------------------------------------------------------


def test_check_planes_holds_the_hard_limit_off_razor_edge_rays():
    """With ``razor``, a pixel past the hard limit passes only on a razor-edge
    ray; the budget still counts it."""
    from sdf3d_tpu_torch.utils.parity import check_planes

    want = [np.zeros((3, 8, 8), np.float32)] + [np.zeros((8, 8), np.float32) for _ in range(3)]
    got = [w.copy() for w in want]
    got[0][:, 2, 3] = 0.6
    razor = np.zeros((8, 8), bool)
    with pytest.raises(AssertionError, match="not razor-edge"):
        check_planes(got, want, 100.0, razor=razor, edge_frac=0.05)
    razor[2, 3] = True
    st = check_planes(got, want, 100.0, razor=razor, edge_frac=0.05)
    assert st["rgb"]["over_hard"] == 1 and st["rgb"]["over_atol"] == 1
    with pytest.raises(AssertionError, match="budget"):
        check_planes(got, want, 100.0, razor=razor)  # 1 of 64 pixels is over the 0.05% budget
    with pytest.raises(AssertionError, match="hard limit"):
        check_planes(got, want, 100.0, edge_frac=0.05)  # no razor mask: the hard limit everywhere


def test_check_planes_calls_a_razor_callable_only_past_the_hard_limit():
    """``razor`` may be a callable (the 13b scenes' witness, which costs
    renders): called once when a pixel passes the hard limit, never
    otherwise, with the same verdicts as its mask."""
    from sdf3d_tpu_torch.utils.parity import check_planes

    want = [np.zeros((3, 8, 8), np.float32)] + [np.zeros((8, 8), np.float32) for _ in range(3)]
    calls = []

    def razor(mask):
        def build():
            calls.append(1)
            return mask
        return build

    close = [w.copy() for w in want]
    close[0][:, 2, 3] = 0.01
    check_planes(close, want, 100.0, razor=razor(np.zeros((8, 8), bool)), edge_frac=0.05)
    assert not calls
    far = [w.copy() for w in want]
    far[0][:, 2, 3] = 0.6
    far[2][2, 3] = 0.6
    with pytest.raises(AssertionError, match="not razor-edge"):
        check_planes(far, want, 100.0, razor=razor(np.zeros((8, 8), bool)), edge_frac=0.05)
    edge = np.zeros((8, 8), bool)
    edge[2, 3] = True
    calls.clear()
    st = check_planes(far, want, 100.0, razor=razor(edge), edge_frac=0.05)
    assert calls == [1] and st["rgb"]["over_hard"] == 1 and st["shadow"]["over_hard"] == 1


def test_razor_edge_rays_are_few_and_are_the_rays_that_move():
    """On the flagship the razor-edge rays are a few of the image, and a ray
    whose march ends more than 4ε apart when ε moves by 1% is one of them
    (a ray that converges on a surface is not)."""
    from sdf3d_tpu_torch.ops import pack_uniforms
    from sdf3d_tpu_torch.utils.parity import razor_edge

    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=96, height=72)
    scene = tt.flagship_scene()
    uni = pack_uniforms(tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), tt.reference_light(),
                        tt.reference_material(), cfg.ray_mode)
    prm = scene_param_vector(scene)
    mask = razor_edge(scene, prm, uni, cfg)
    assert mask.shape == (72, 96) and 0 < int(mask.sum()) < 0.01 * mask.numel()
    wide = razor_edge(scene, prm, uni, cfg, margin=0.2)
    assert bool((wide | ~mask).all()) and int(wide.sum()) > int(mask.sum())
