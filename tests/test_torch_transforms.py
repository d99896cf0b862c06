"""The nodes of ROADMAP item 13b (Capsule, Cylinder, Ellipsoid and the
transforms Translate, Rotate, Scale, Round, Onion, Elongate, RepeatInfinite)
against the JAX package: each node's ``distance``, the generated C point and
ray forms (the ray form of Elongate and RepeatInfinite through the point
form at ``o + t·d``), and the derivatives of the point form, both the torch
backend's under ``torch.autograd`` and the generated reverse pass
(``Scene::sdf_bwd``, ``sdf_grad_p``, built with g++), against ``jax.vjp`` of
JAX's emitters, at random points and at the ties of the new operations:
``rotvec = 0`` and ``|w|²`` on either side of 1e-8, ``p / period`` at ±0.5
(round half to even), a period of 0, ``p = ±amount``, the shell at ``d =
0``, a scale factor at and below 1e-12, the capsule's clip at 0 and 1, the
cylinder's ``max(·, 0)`` at 0 and the ellipsoid's ``max(k1, 1e-12)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.ops import KernelConfig, cuda_scene_source, scene_param_vector
from sdf3d_tpu_torch.ops.scene_program import _TorchOps
from test_torch_csg import _assert_grads, _c_scene, _jax_scene, _random_case, _rng, _scene_library, _tie_case, _torch_grads
from test_torch_scene_program import transform_sampler

torch.set_num_threads(1)

S = s.sdf


# ---------------------------------------------------------------------------
# The nodes' own distance, against JAX's nodes.
# ---------------------------------------------------------------------------


def _random_node(name, r):
    """A JAX node of class ``name`` with parameters drawn from ``r``."""
    def sph():
        return S.sphere(center=r.uniform(-0.3, 0.3, 3), radius=r.uniform(0.2, 0.4))

    def rnd(lo, hi, n=3):
        return r.uniform(lo, hi, n)

    return {
        "Capsule": lambda: S.capsule(rnd(-0.5, 0.5), rnd(-0.5, 0.5), r.uniform(0.05, 0.2)),
        "Cylinder": lambda: S.cylinder(r.uniform(0.1, 0.4), r.uniform(0.1, 0.4), rnd(-0.3, 0.3)),
        "Ellipsoid": lambda: S.ellipsoid(rnd(0.1, 0.5), rnd(-0.3, 0.3)),
        "Translate": lambda: S.translate(sph(), rnd(-0.4, 0.4)),
        "Rotate": lambda: S.rotate(S.capsule(rnd(-0.5, 0.5), rnd(-0.5, 0.5), 0.1), rnd(-2.0, 2.0)),
        "Scale": lambda: S.scale(S.ellipsoid(rnd(0.2, 0.5), rnd(-0.3, 0.3)), r.uniform(0.5, 2.0)),
        "Round": lambda: S.round_edges(S.cylinder(0.2, 0.3, rnd(-0.3, 0.3)), r.uniform(0.02, 0.1)),
        "Onion": lambda: S.onion(sph(), r.uniform(0.01, 0.05)),
        "Elongate": lambda: S.elongate(S.torus(0.3, 0.1, rnd(-0.2, 0.2)), rnd(0.0, 0.3)),
        "RepeatInfinite": lambda: S.repeat_infinite(S.sphere(rnd(-0.1, 0.1), 0.15),
                                                    np.array([r.uniform(0.4, 0.8), 0.0, r.uniform(0.4, 0.8)])),
    }[name]()


NODES = ["Capsule", "Cylinder", "Ellipsoid", "Translate", "Rotate", "Scale", "Round", "Onion", "Elongate",
         "RepeatInfinite"]


@pytest.mark.parametrize("name", NODES)
def test_node_distance_matches_jax(name):
    r = _rng(100 + NODES.index(name))
    js = _random_node(name, r)
    ts = convert.from_jax(js)
    assert type(ts).__name__ == name
    pts = r.uniform(-1.0, 1.0, (4096, 3)).astype(np.float32)
    got = ts.distance(torch.from_numpy(pts)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(js.distance(jnp.asarray(pts))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("rotvec", [(0.0, 0.0, 0.0), (1e-4, 0.0, 0.0), (1.00000005e-4, 0.0, 0.0), (0.3, -1.2, 0.7)],
                         ids=["zero", "series_edge", "exact_edge", "large"])
def test_rotvec_to_matrix_matches_jax(rotvec):
    """The rotation matrix and its gradient (the double where: finite at 0)
    against JAX's, on either side of the series' threshold."""
    w = np.asarray(rotvec, np.float32)
    want = np.asarray(S.rotvec_to_matrix(jnp.asarray(w)))
    g_want = np.asarray(jax.grad(lambda v: jnp.sum(S.rotvec_to_matrix(v) * jnp.arange(9.0).reshape(3, 3)))(
        jnp.asarray(w)))
    wt = torch.from_numpy(w.copy()).requires_grad_(True)
    got = tt.sdf.rotvec_to_matrix(wt)
    (got * torch.arange(9.0).reshape(3, 3)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    assert np.isfinite(wt.grad.numpy()).all()
    np.testing.assert_allclose(wt.grad.numpy(), g_want, atol=2e-5, rtol=2e-5)


def test_methods_build_the_transforms():
    a = tt.sdf.sphere((0.0, 0.0, 0.0), 0.5)
    for got, name, field in ((a.translate((1, 0, 0)), "Translate", "offset"), (a.rotate((0, 1, 0)), "Rotate", "rotvec"),
                             (a.scale(2.0), "Scale", "factor"), (a.round(0.1), "Round", "radius"),
                             (a.shell(0.05), "Onion", "thickness"),
                             (a.smooth_union(tt.sdf.box((0.2, 0.2, 0.2)), 0.1), "SmoothUnion", "k")):
        assert type(got).__name__ == name and hasattr(got, field)
    assert got.a is a


def test_cylinder_distance_gradient_is_finite_inside():
    """The node's own distance keeps JAX's ``vlength_safe`` (finite inside);
    the emitters do not (the NaN case below)."""
    js = S.cylinder(0.3, 0.25, (0.1, 0.2, 0.0))
    ts = convert.from_jax(js)
    pts = (_rng(3).uniform(-0.1, 0.1, (64, 3)) + np.array([0.1, 0.2, 0.0])).astype(np.float32)
    want = np.asarray(jax.grad(lambda p: js.distance(p).sum())(jnp.asarray(pts)))
    p = torch.from_numpy(pts).requires_grad_(True)
    ts.distance(p).sum().backward()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The generated C forms and reverse pass (g++), and the torch backend's
# derivatives, against JAX's emitters.
# ---------------------------------------------------------------------------


def _rot_capsule(rotvec):
    return S.rotate(S.capsule((-0.3, 0.1, 0.0), (0.3, -0.1, 0.2), 0.12), rotvec)


GRAD_CASES = {
    "transform_sampler": _random_case(transform_sampler, 31, -0.8, 0.8),
    "capsule_chain": _random_case(s.capsule_chain, 32, -0.8, 0.8),
    "random_blobs": _random_case(lambda: s.random_blobs(n=3), 33, -0.8, 0.8),
    "lattice_scene": _random_case(s.lattice_scene, 34, -2.0, 2.0),
    "every_node_random": _random_case(lambda: S.union(*(_random_node(n, _rng(40 + i)) for i, n in enumerate(
        ["Capsule", "Ellipsoid", "Translate", "Rotate", "Scale", "Round", "Onion", "Elongate", "RepeatInfinite"]))),
        35, -1.5, 1.5),
    # Rotate at rotvec = 0 (the series), and |w|² just below and at/above 1e-8.
    "rotate_zero": _random_case(lambda: _rot_capsule((0.0, 0.0, 0.0)), 36),
    "rotate_series_edge": _random_case(lambda: _rot_capsule((1e-4, 0.0, 0.0)), 37),
    "rotate_exact_edge": _random_case(lambda: _rot_capsule((1.00000005e-4, 0.0, 0.0)), 38),
    # p / period at exactly +0.5 and -0.5 (round half to even: 0), and 1.5
    # (2); the y period is 0, so y is not folded.
    "repeat_half_period": _tie_case(lambda: S.repeat_infinite(S.sphere((0.05, 0.1, 0.0), 0.2), (0.5, 0.0, 0.5)),
                                    {0: 0.25, 2: -0.25}),
    "repeat_one_and_a_half": _tie_case(lambda: S.repeat_infinite(S.sphere((0.05, 0.1, 0.0), 0.2), (0.5, 0.0, 0.5)),
                                       {0: 0.75, 2: -0.75}),
    # Elongate at p = +amount and p = -amount (clip's ties).
    "elongate_at_amount": _tie_case(lambda: S.elongate(S.torus(0.3, 0.1, (0.1, 0.0, 0.0)), (0.2, 0.1, 0.3)),
                                    {0: 0.2, 1: -0.1}),
    # The shell at d = 0 (abs at 0: +1): points on the child's surface.
    "onion_on_surface": _tie_case(lambda: S.onion(S.plane((0.0, 1.0, 0.0), 0.25), 0.05), {1: 0.25}),
    # The scale factor at its clamp 1e-12 (a tie) and below it, at points
    # 1e-12 across (where the child sees points of order 1).
    "scale_at_clamp": _random_case(lambda: S.scale(S.sphere((0.1, 0.0, 0.0), 0.3), 1e-12), 39, -1e-12, 1e-12),
    "scale_below_clamp": _random_case(lambda: S.scale(S.sphere((0.1, 0.0, 0.0), 0.3), 1e-13), 40, -1e-12, 1e-12),
    # The capsule's h clipped at exactly 0 (p_x = 0) and at exactly 1 (p_x = 0.5).
    "capsule_h_at_0": _tie_case(lambda: S.capsule((0.0, 0.1, 0.0), (0.5, 0.1, 0.0), 0.1), {0: 0.0}),
    "capsule_h_at_1": _tie_case(lambda: S.capsule((0.0, 0.1, 0.0), (0.5, 0.1, 0.0), 0.1), {0: 0.5}),
    # The cylinder's max(radial, 0) at radial = 0 (on its side), and max(axial, 0)
    # at axial = 0 (on its cap plane); where the other clamp is 0 too, NaN in both.
    "cylinder_radial_at_0": _tie_case(lambda: S.cylinder(0.5, 0.2, (0.0, 0.0, 0.0)), {0: 0.5, 2: 0.0}),
    "cylinder_axial_at_0": _tie_case(lambda: S.cylinder(0.1, 0.2, (0.0, 0.0, 0.0)), {1: 0.2}),
    # The ellipsoid's max(k1, 1e-12) at its center (k1 = 0), where both give
    # JAX's derivative (not finite).
    "ellipsoid_center": _tie_case(lambda: S.ellipsoid((0.3, 0.2, 0.25), (0.0, 0.0, 0.0)), {0: 0.0, 1: 0.0, 2: 0.0}),
    # Inside a bare cylinder's core both clamps are 0: sqrt(0)'s infinite
    # derivative times 0, NaN in JAX's emitter and so in the port's.
    "cylinder_interior": _random_case(lambda: S.cylinder(0.5, 0.5, (0.0, 0.0, 0.0)), 41, -0.3, 0.3),
    "csg_showcase": _random_case(s.csg_showcase, 42, -0.8, 0.8),
}

#: Cases whose points may all fall where JAX's derivative is finite.
FINITE = ("transform_sampler", "capsule_chain", "random_blobs", "lattice_scene", "rotate_zero", "rotate_series_edge",
          "rotate_exact_edge", "repeat_half_period", "repeat_one_and_a_half", "elongate_at_amount",
          "onion_on_surface", "scale_at_clamp", "scale_below_clamp", "capsule_h_at_0", "capsule_h_at_1")


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    cache = {}

    def get(case, scene):
        if case not in cache:
            cache[case] = _scene_library(scene, tmp_path_factory.mktemp(case))
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_generated_reverse_pass_matches_jax_vjp(case, libraries):
    """The generated C (g++): point form and ray form at 1e-6 / 1e-5, and the
    tape's adjoints (``sdf_bwd``: ∇ₚ and every parameter; ``sdf_grad_p``)
    against ``jax.vjp`` of JAX's emitter."""
    js, pts = GRAD_CASES[case]()
    prm = np.asarray(jax_scene_param_vector(js))
    r = _rng(51)
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
    if case == "cylinder_interior":
        assert np.isnan(got["dp"]).all() and np.isnan(dp).all()
    elif case in FINITE:
        assert np.isfinite(got["dp"]).all() and np.isfinite(got["dpts"]).all()


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
    if case == "cylinder_interior":
        assert np.isnan(g_prm).all()


@pytest.mark.parametrize("op", ["sin", "cos", "round"])
def test_torch_ops_follow_lax(op):
    """sin, cos and round (half to even, derivative 0) with jax.vjp's values
    and adjoints, at the halves of round."""
    x = np.array([-2.5, -1.5, -0.5, 0.0, 0.5, 1.5, 2.5, 0.3, -1.7], np.float32)
    val, back = jax.vjp(getattr(jnp, op), jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = getattr(_TorchOps, op)(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(val), atol=1e-7, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(back(jnp.ones_like(jnp.asarray(x)))[0]), atol=1e-7, rtol=0)


def test_torch_where_gives_the_branch_not_taken_a_true_zero():
    """``where``'s adjoint is a select: a NaN adjoint on the branch not taken
    leaves the other operand's gradient exactly 0, as in jax.vjp."""
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor([3.0, 4.0], requires_grad=True)
    y = _TorchOps.where(torch.tensor([True, False]), a, b)
    y.backward(torch.tensor([float("nan"), 1.0]))
    assert a.grad.tolist()[1] == 0.0 and b.grad.tolist()[0] == 0.0


def test_generated_header_keeps_run_time_selects():
    """The rotation's series test and the repetition's disabled axes read
    run-time parameters: one header for any values (a changed rotation or
    period reuses the library), the comparisons as selects and ``bool``s
    (not counted in ``Scene::bwd_values``), round as ``rintf``, accurate
    ``sinf``/``cosf``."""
    cfg, kc = tt.REFERENCE_CONFIG, KernelConfig()
    a = cuda_scene_source(tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.rotate(tt.sdf.sphere((0.1, 0.2, 0.0), 0.2),
                                                                            (0.0, 0.0, 0.0))), cfg, kc)
    b = cuda_scene_source(tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.rotate(tt.sdf.sphere((0.3, 0.1, 0.2), 0.1),
                                                                            (0.4, 1.0, -2.0))), cfg, kc)
    assert a == b
    assert "sdf3d::select(" in a and "const bool v" in a and "sinf(" in a and "cosf(" in a
    assert "__sinf" not in a and "__cosf" not in a
    rep = cuda_scene_source(tt.lattice_scene(), cfg, kc)
    assert rep == cuda_scene_source(tt.lattice_scene(period=0.7, radius=0.1), cfg, kc)
    assert "rintf(" in rep and "roundf(" not in rep
    bwd = rep[rep.index("void sdf_bwd("):rep.index("void sdf_grad_p(")]
    assert int(rep.split("bwd_values = ")[1].split(";")[0]) == bwd.count("const float v")
    assert bwd.count("const bool v") > 0


def test_point_form_names_the_rotation_once():
    """The point form's rotation entries and rotated point are ``const
    float`` values of ``Scene::sdf`` (no copy of the Rodrigues expression per
    use); a scene without a rotation keeps its one ``return`` line."""
    src = cuda_scene_source(convert.from_jax(transform_sampler()), tt.REFERENCE_CONFIG, KernelConfig())
    body = src[src.index("float sdf(float px"):src.index("// Ray form")]
    assert body.count("sinf(") == body.count("cosf(") == 2 and body.count("const float e") >= 2 * 17
    ref = cuda_scene_source(tt.flagship_scene(), tt.REFERENCE_CONFIG, KernelConfig())
    assert "const float e" not in ref[ref.index("float sdf(float px"):ref.index("// Ray form")]


def test_ray_form_of_elongate_and_repeat_reads_hoisted_values():
    """Elongate and RepeatInfinite take JAX's ray fallback: the step reads the
    ray and the parameters from hoisted fields only."""
    src = cuda_scene_source(tt.lattice_scene(), tt.REFERENCE_CONFIG, KernelConfig())
    ev = src[src.index("float eval(float t)"):src.index("// Ambient occlusion")]
    assert "rintf(" in ev and "p[" not in ev


# ---------------------------------------------------------------------------
# Setup files and the scenes.
# ---------------------------------------------------------------------------


def _every_13b_node():
    return S.union(transform_sampler(), S.ellipsoid((0.1, 0.2, 0.1), (0.5, 0.5, 0.5)),
                   S.cylinder(0.1, 0.2, (0.3, 0.1, -0.4)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_setup_file_carries_every_13b_node_bit_exact(direction, tmp_path):
    js = _every_13b_node()
    names = {type(n).__name__ for n in jax.tree_util.tree_flatten(js, is_leaf=lambda x: isinstance(x, S.SDFNode))[0]}
    path = tmp_path / "setup.json"
    if direction == "jax_to_port":
        S.save_setup(path, js, s.Camera.reference())
        back = tt.sdf.load_setup(path)["scene"]
        np.testing.assert_array_equal(scene_param_vector(back).numpy(), np.asarray(jax_scene_param_vector(js)))
        assert tt.ops.scene_program.describe(back) == tt.ops.scene_program.describe(convert.from_jax(js))
        kinds = {type(m).__name__ for m in back.modules()}
        assert {"Capsule", "Cylinder", "Ellipsoid", "Translate", "Rotate", "Scale", "Round", "Onion", "Elongate",
                "RepeatInfinite"} <= kinds
    else:
        tt.sdf.save_setup(path, convert.from_jax(js))
        back = S.load_setup(path)["scene"]
        np.testing.assert_array_equal(np.asarray(jax_scene_param_vector(back)), np.asarray(jax_scene_param_vector(js)))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(js)
    assert names  # the tree is not empty


@pytest.mark.parametrize("name", ["csg_showcase", "lattice_scene", "capsule_chain"])
def test_scenes_match_jax(name):
    ts, js = getattr(tt, name)(), getattr(s, name)()
    np.testing.assert_array_equal(scene_param_vector(ts).numpy(), np.asarray(jax_scene_param_vector(js)))
    assert tt.ops.scene_program.describe(ts) == tt.ops.scene_program.describe(convert.from_jax(js))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_random_blobs_takes_jax_spheres_and_keeps_its_structure(n):
    """The port's ``random_blobs`` builds JAX's scene from JAX's centers and
    radii bit for bit; from its own generator it has the same structure and
    its spheres inside JAX's ranges."""
    want = convert.from_jax(s.random_blobs(n=n, seed=5))
    spheres = [m for m in want.modules() if type(m).__name__ == "Sphere"]
    centers = torch.stack([m.center.detach() for m in spheres])
    radii = torch.stack([m.radius.detach() for m in spheres])
    got = tt.random_blobs(n=n, centers=centers, radii=radii)
    assert torch.equal(scene_param_vector(got), scene_param_vector(want))
    own = tt.random_blobs(n=n, seed=5)
    assert tt.ops.scene_program.describe(own) == tt.ops.scene_program.describe(want)
    assert torch.equal(scene_param_vector(own), scene_param_vector(tt.random_blobs(n=n, seed=5)))
    c = torch.stack([m.center.detach() for m in own.modules() if type(m).__name__ == "Sphere"])
    assert bool(((c[:, 0].abs() <= 0.6) & ((c[:, 1] - 0.45).abs() <= 0.24) & (c[:, 2].abs() <= 0.6)).all())


def test_rounding_decided_marks_the_pixels_a_one_ulp_camera_moves():
    """``utils/parity.py::rounding_decided``, the second witness the 13b
    scenes' image checks excuse a pixel on: nothing on the reference scene;
    on the capsule chain's fit start under orbit 30/15 at 256x192 a few
    pixels, each of which moves by ``HARD`` or more in the plain version
    when every entry of the camera moves by one ulp in one of the draws
    (recomputed here)."""
    import dataclasses

    from sdf3d_tpu_torch.ops.render_kernel import pack_uniforms, render_kernel_forward_plain
    from sdf3d_tpu_torch.utils.parity import HARD, ROUNDING_DRAWS, capsule_chain_fit_start, rounding_decided

    def inputs(scene, cam, cfg):
        uni = pack_uniforms(cam, tt.reference_light(), tt.reference_material(), cfg.ray_mode)
        uni[27] = cfg.shadow.k
        return scene_param_vector(scene), uni

    small = dataclasses.replace(tt.REFERENCE_CONFIG, width=128, height=96)
    scene = tt.reference_scene()
    assert not bool(rounding_decided(scene, *inputs(scene, tt.Camera.reference(), small), small).any())

    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=256, height=192)
    scene = capsule_chain_fit_start()
    prm, uni = inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg)
    mask = rounding_decided(scene, prm, uni, cfg)
    assert 0 < int(mask.sum()) <= 5e-4 * mask.numel()
    rgb, _, shadow, _ = render_kernel_forward_plain(scene, prm, uni, cfg)
    moved = torch.zeros_like(mask)
    gen = torch.Generator().manual_seed(0)
    for _ in range(ROUNDING_DRAWS):
        up = torch.rand(12, generator=gen) < 0.5
        shifted = uni.clone()
        shifted[:12] = torch.nextafter(uni[:12], torch.where(up, torch.inf, -torch.inf))
        s_rgb, _, s_shadow, _ = render_kernel_forward_plain(scene, prm, shifted, cfg)
        moved |= ((s_rgb - rgb).abs().amax(0) >= HARD) | ((s_shadow - shadow).abs() >= HARD)
    assert bool(moved[mask].all())
