"""Per-object materials (``Shaded``, the material program) on the CPU: the
port's ``material_at`` and the torch backend's material program against the
JAX package's ``material_at`` and ``jax.vjp`` of its ``_emit_mat``, the g++
forward and reverse forms of the generated program against the same, the
plain K1, K3 and K5 on material scenes against JAX's interpret-mode kernels,
the g++ K2 and K4 against K1 and K3 bit for bit, and scenes whose tags
change nothing.

Tolerances, each beside the error measured here: the fold and the program
at 2048 seeded points (around the hard ties, where a union takes ``a``'s
material and an intersection too, and inside the smooth blends) at the
other emitters' bar, ``rtol`` 2e-5 and 2e-5 of the largest value (measured:
the channels equal JAX's bit for bit in all three forms, the gradients within
8.4e-7 of the largest; inside a bare box's core the position and parameter
gradients are NaN in JAX's ``jax.vjp`` and the port's alike, ROADMAP Queue
3); images at the flagship's budget (0.05% of pixels over 1e-4, no pixel over
0.05 but razor-edge rays; measured: ``materials_scene`` one pixel of 12288
over 1e-4, at most 1.35e-4; the two spheres 1.6e-5 at most); gradients by
``check_grads`` at the flagship's bars, 1e-4 of the mass on the same planes
(K5: 5.3e-5 and 8.6e-7 measured) and 1e-3 where each side marches its own
(K3: 2.5e-4 and 8.0e-6).  About 110 s on one worker."""

import ctypes
import dataclasses
import hashlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import fit_step_kernel as jax_fit_step_kernel
from sdf3d_tpu.ops.render_bwd_kernel import render_kernel_backward as jax_render_kernel_backward
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu.ops.scene_program import compile_scene_material as jax_compile_scene_material
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu.sdf.materials import material_at as jax_material_at
from sdf3d_tpu.sdf.materials import shaded as jax_shaded
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.ops import KernelConfig, cuda_scene_source
from sdf3d_tpu_torch.ops.fit_kernel import fit_columns, fit_step_kernel_plain
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward_plain
from sdf3d_tpu_torch.ops.render_kernel import pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import compile_scene_material, count_params, scene_param_vector
from sdf3d_tpu_torch.sdf import material_at, scene_has_materials
from sdf3d_tpu_torch.utils.parity import (
    FLAGSHIP_OWN,
    FLAGSHIP_SAME,
    check_grads,
    check_planes,
    conditioned,
    gradient_mass,
    primals_agree,
    razor_edge,
    shaded_slots,
)
from test_torch_csg import CSRC, SCENE_HEADER
from test_torch_fit_losses import _ptr

torch.set_num_threads(1)

PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
RED = s.material(ambient=(0.3, 0.0, 0.0), diffuse=(0.9, 0.1, 0.1))
BLUE = s.material(ambient=(0.0, 0.0, 0.3), diffuse=(0.1, 0.1, 0.9))


def _two_spheres():
    """``tests/test_materials.py::_two_sphere_scene``: an untagged plane (the
    uniform material) and two tagged spheres, symmetric about x = 0."""
    return s.sdf.union(s.sdf.ground_plane(), jax_shaded(s.sdf.sphere(center=(-0.4, 0.3, 0.0), radius=0.25), RED),
                       jax_shaded(s.sdf.sphere(center=(0.4, 0.3, 0.0), radius=0.25), BLUE))


def _sampler():
    """Every branch of the fold: hard and smooth union, intersection and
    subtraction of tagged operands, an untagged operand, a nested tag, and
    each transform over a tagged child (JAX's nodes)."""
    sd, m = s.sdf, s.material
    sh = jax_shaded
    pair = sd.intersection(sh(sd.sphere(center=(0.0, 0.3, 0.0), radius=0.3), m(diffuse=(0.9, 0.2, 0.1))),
                           sh(sd.sphere(center=(0.2, 0.3, 0.0), radius=0.3), m(diffuse=(0.1, 0.8, 0.3), shininess=30.0)))
    carve = sd.subtraction(sh(sd.box(half_extents=(0.2, 0.2, 0.2), center=(-0.9, 0.3, 0.0)), m(specular=(0.9, 0.1, 0.1))),
                           sd.sphere(center=(-0.9, 0.45, 0.1), radius=0.2))
    blend = sd.smooth_union(sh(sd.sphere(center=(0.9, 0.3, 0.0), radius=0.2), m(ambient=(0.3, 0.2, 0.1))),
                            sh(sd.round_box(half_extents=(0.15, 0.15, 0.15), corner_radius=0.03,
                                            center=(1.15, 0.3, 0.0)), m(diffuse=(0.2, 0.2, 0.9), shininess=40.0)),
                            k=0.15)
    smooth_i = sd.smooth_intersection(sh(sd.sphere(center=(0.0, 0.3, 0.9), radius=0.3), m(diffuse=(0.5, 0.5, 0.1))),
                                      sd.sphere(center=(0.15, 0.3, 0.9), radius=0.3), k=0.1)
    smooth_s = sd.smooth_subtraction(sh(sd.sphere(center=(0.9, 0.3, 0.9), radius=0.3), m(diffuse=(0.3, 0.7, 0.7))),
                                     sd.sphere(center=(1.05, 0.4, 0.9), radius=0.15), k=0.1)
    nested = sh(sd.union(sh(sd.capsule(a=(-0.9, 0.2, 0.9), b=(-0.6, 0.5, 0.9), radius=0.08), m(diffuse=(0.9, 0.9, 0.1))),
                         sd.cylinder(radius=0.1, half_height=0.2, center=(-0.4, 0.3, 0.9))), m(diffuse=(0.6, 0.1, 0.6)))
    moved = sd.translate(sd.rotate(sd.scale(sh(sd.torus(major=0.2, minor=0.05), m(specular=(0.2, 0.9, 0.2))), 1.3),
                                   (0.3, 0.2, 0.1)), (0.0, 0.3, -0.9))
    grown = sd.onion(sd.round_edges(sd.elongate(sh(sd.ellipsoid(radii=(0.1, 0.15, 0.12)), m(shininess=20.0)),
                                                (0.1, 0.0, 0.05)), 0.02), 0.03)
    rows = sd.repeat_infinite(sh(sd.sphere(center=(0.0, 0.3, 0.0), radius=0.1), m(diffuse=(0.9, 0.6, 0.6))),
                              (0.7, 0.0, 0.0))
    return sd.union(sd.ground_plane(), pair, carve, blend, smooth_i, smooth_s, nested, moved,
                    sd.translate(grown, (0.9, 0.3, -0.9)), sd.translate(rows, (0.0, 0.0, -1.6)))


SCENES = {"sampler": _sampler, "materials": s.scenes.materials_scene, "two_spheres": _two_spheres}
DEFAULT = s.material(ambient=(0.05, 0.1, 0.2), diffuse=(0.3, 0.4, 0.5), specular=(0.6, 0.5, 0.4), shininess=10.0)


def _points(name, n=2048):
    """Seeded points over the scene, a quarter on the x = 0 plane (the two
    spheres' tie, where the union takes ``a``'s material) and a quarter
    inside the sampler's blend and its intersection's tie plane x = 0.1."""
    rng = np.random.default_rng(1500 + len(name))
    p = rng.uniform((-1.4, -0.1, -1.2), (1.4, 0.9, 1.2), (n, 3)).astype(np.float32)
    q = n // 4
    p[:q, 0] = 0.0
    p[q:2 * q] = rng.uniform((0.95, 0.15, -0.2), (1.15, 0.45, 0.2), (q, 3)).astype(np.float32)
    p[2 * q:2 * q + q // 2, 0] = 0.1
    return p


def _flat_mat(m):
    return np.concatenate([np.asarray(m.ambient), np.asarray(m.diffuse), np.asarray(m.specular),
                           np.asarray(m.shininess)[..., None]], axis=-1)


def _close(got, want, label, tol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=label)
    print(f"{label}: {float(np.nanmax(np.abs(got - want))) / scale:.2e} of the largest, "
          f"{int(np.isnan(want).sum())} NaN in both")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_material_at_matches_jax(name):
    """The port's fold (``sdf/materials.py::material_at``) against JAX's."""
    js = SCENES[name]()
    pts = _points(name)
    want = _flat_mat(jax_material_at(js, jnp.asarray(pts), DEFAULT))
    got = material_at(convert.from_jax(js), torch.from_numpy(pts), convert.from_jax(DEFAULT))
    got = torch.cat([got.ambient, got.diffuse, got.specular, got.shininess[..., None]], -1).detach().numpy()
    _close(got, want, name)
    assert scene_has_materials(convert.from_jax(js)) and not scene_has_materials(tt.flagship_scene())
    if name == "two_spheres":  # on the tie plane x = 0 a sphere is a's (red), never b's (blue)
        dif = got[:512, 3:6]
        red, blue = np.isclose(dif, [0.9, 0.1, 0.1]).all(1), np.isclose(dif, [0.1, 0.1, 0.9]).all(1)
        assert red.sum() > 50 and not blue.any()


def _jax_program(js, pts, prm, default, g):
    """JAX's material program (``_emit_mat``) per point: the channels (n, 10)
    and ``jax.vjp`` with the cotangent rows ``g`` (n, 10) with respect to
    the point, the parameters and the default channels."""
    fn = jax_compile_scene_material(js)

    def one(x, y, z, q, d):
        return jnp.stack(fn(x, y, z, lambda i: q[i], tuple(d[k] for k in range(10)))[1])

    def vjp(x, y, z, q, d, gg):
        _, back = jax.vjp(one, x, y, z, q, d)
        return back(gg)

    x, y, z = (jnp.asarray(pts[:, i]) for i in range(3))
    ch = jax.vmap(one, (0, 0, 0, None, None))(x, y, z, jnp.asarray(prm), jnp.asarray(default))
    gx, gy, gz, gq, gd = jax.vmap(vjp, (0, 0, 0, None, None, 0))(x, y, z, jnp.asarray(prm), jnp.asarray(default),
                                                                 jnp.asarray(g))
    return (np.asarray(ch), np.stack([np.asarray(gx), np.asarray(gy), np.asarray(gz)], 1), np.asarray(gq).sum(0),
            np.asarray(gd).sum(0))


def _inputs(name):
    js = SCENES[name]()
    pts = _points(name)
    prm = np.asarray(jax_scene_param_vector(js))
    default = _flat_mat(DEFAULT).astype(np.float32)
    g = np.random.default_rng(7).normal(size=(pts.shape[0], 10)).astype(np.float32)
    return js, pts, prm, default, g


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_program_matches_jax_vjp(name):
    """The torch backend's material program (``compile_scene_material``) and
    its autograd against JAX's ``_emit_mat`` and ``jax.vjp`` of it."""
    js, pts, prm, default, g = _inputs(name)
    want = _jax_program(js, pts, prm, default, g)
    x, y, z = (torch.from_numpy(pts[:, i].copy()).requires_grad_(True) for i in range(3))
    q = torch.from_numpy(prm).requires_grad_(True)
    d = torch.from_numpy(default).requires_grad_(True)
    ch = torch.stack(compile_scene_material(convert.from_jax(js))(x, y, z, lambda i: q[i], tuple(d[k] for k in range(10)))[1],
                     -1).expand(pts.shape[0], 10)
    grads = torch.autograd.grad(ch, (x, y, z, q, d), grad_outputs=torch.from_numpy(g), allow_unused=True)
    grads = [torch.zeros_like(v) if gr is None else gr for gr, v in zip(grads, (x, y, z, q, d))]
    _close(ch.detach().numpy(), want[0], "channels")
    _close(torch.stack(grads[:3], 1).numpy(), want[1], "position")
    _close(grads[3].numpy(), want[2], "parameters")
    _close(grads[4].numpy(), want[3], "default")


MAT_SHIM = r"""
#include "render_kernel.cuh"
#include "sdf3d_scene.cuh"

// The generated material program over n points, for the tests: its channels
// and its reverse with the cotangent rows g (n, 10).
extern "C" int sdf3d_material_host(const float* pts, int n, const float* p, const float* u, const float* g,
                                   float* ch, float* dpts, float* dp, float* dd) {
  for (int i = 0; i < n; ++i) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    Scene::material(x, y, z, p, u, ch + 10 * i);
    float* row = dp + (long)i * Scene::n_params;
    for (int k = 0; k < Scene::n_params; ++k) row[k] = 0.0f;
    for (int k = 0; k < 10; ++k) dd[10 * i + k] = 0.0f;
    Scene::material_bwd(x, y, z, p, u, g + 10 * i, row, dd + 10 * i, dpts[3 * i], dpts[3 * i + 1], dpts[3 * i + 2]);
  }
  return 0;
}
"""


def _material_library(scene, out_dir):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    (out_dir / SCENE_HEADER).write_text(cuda_scene_source(scene, tt.REFERENCE_CONFIG, KernelConfig()))
    (out_dir / "shim.cpp").write_text(MAT_SHIM)
    lib = out_dir / "libmaterial_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-Wno-unused-parameter",
           "-Wno-unused-function", "-I", str(CSRC), "-I", str(out_dir), str(out_dir / "shim.cpp"), "-o", str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_program_matches_jax(name, tmp_path):
    """The generated ``Scene::material`` and ``Scene::material_bwd`` (g++)
    against JAX's ``_emit_mat`` and its ``jax.vjp``."""
    js, pts, prm, default, g = _inputs(name)
    want = _jax_program(js, pts, prm, default, g)
    lib = _material_library(convert.from_jax(js), tmp_path)
    n, P = pts.shape[0], prm.size
    u = np.zeros(30, np.float32)
    u[17:27] = default
    out = [np.zeros((n, 10), np.float32), np.zeros((n, 3), np.float32), np.zeros((n, P), np.float32),
           np.zeros((n, 10), np.float32)]
    fn = lib.sdf3d_material_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    ins = [np.ascontiguousarray(a, np.float32) for a in (pts, prm, u, g)]
    assert fn(_ptr(ins[0]), n, *(_ptr(a) for a in ins[1:]), *(_ptr(a) for a in out)) == 0
    _close(out[0], want[0], "channels")
    _close(out[1], want[1], "position")
    _close(out[2].sum(0), want[2], "parameters")
    _close(out[3].sum(0), want[3], "default")


def _setup(name, W, H, cam):
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    js, jlight, jmat = SCENES[name](), s.reference_light(), s.reference_material()
    scene, c, light, mat, cfg = (convert.from_jax(o) for o in (js, cam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(c, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    juni = jax_pack_uniforms(cam, jlight, jmat, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    return js, jcfg, juni, scene, cfg, prm, uni


CAMS = {"materials": lambda: s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), "two_spheres": s.Camera.reference}


@pytest.mark.parametrize("name", sorted(CAMS))
def test_plain_k1_matches_jax(name):
    """The plain K1 against JAX's interpret-mode ``render_kernel_forward`` at
    128×96, at the flagship's image bar (the hard limit off razor-edge
    rays)."""
    js, jcfg, _, scene, cfg, prm, uni = _setup(name, 128, 96, CAMS[name]())
    cam = CAMS[name]()
    want = jax_render_kernel_forward(js, cam, s.reference_light(), s.reference_material(), jcfg, PC, planar=True)
    got = render_kernel_forward_plain(scene, prm, uni, cfg)
    st = check_planes(got, [np.asarray(w) for w in want], cfg.march.max_distance,
                      razor=razor_edge(scene, prm, uni, cfg))
    print(f"\n{name}: {st}")
    if name == "two_spheres":  # the red sphere on the left, the blue on the right
        rgb = got[0].numpy()
        assert rgb[0, :48, :64].max() > 0.5 and rgb[2, :48, 64:].max() > 0.5


@pytest.mark.parametrize("name", sorted(CAMS))
def test_plain_k5_matches_jax(name):
    """The plain K5 (with the uniforms' gradient) against JAX's
    interpret-mode backward on JAX's forward planes and one seeded
    cotangent, at ``FLAGSHIP_SAME``; the material slots' gradients are not
    zero."""
    W, H = 96, 72
    js, jcfg, juni, scene, cfg, prm, uni = _setup(name, W, H, CAMS[name]())
    cam = CAMS[name]()
    _, t, sh, ao = (np.asarray(x) for x in jax_render_kernel_forward(
        js, cam, s.reference_light(), s.reference_material(), jcfg, PC, planar=True))
    planes = [torch.from_numpy(x.copy()) for x in (t, sh, ao)]
    keep = conditioned(scene, prm, uni, planes[0], cfg).numpy()
    g_rgb = np.random.default_rng(5).normal(size=(3, H, W)).astype(np.float32) * keep
    leaves, treedef = jax.tree_util.tree_flatten(js)
    want = jax_render_kernel_backward(treedef, tuple(jnp.shape(x) for x in leaves), jax_scene_param_vector(js), juni,
                                      jnp.asarray(g_rgb), *(jnp.asarray(x) for x in (t, sh, ao)), jcfg, PC)
    got = render_kernel_backward_plain(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg)
    mass = gradient_mass(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg)
    st = check_grads(torch.cat(got), np.concatenate([np.asarray(w) for w in want]), mass, rtol=1e-4,
                     mass_tol=FLAGSHIP_SAME)
    print(f"\n{name}: {st}")
    assert float(got[0][shaded_slots(scene)].abs().max()) > 0.0


@pytest.mark.parametrize("name", sorted(CAMS))
def test_plain_k3_matches_jax(name):
    """The plain K3 with the uniforms' gradient against JAX's interpret-mode
    fit step at 96×72, each side marching its own primal (the target JAX's
    render plus seeded noise where the gradient is well conditioned and the
    primals agree, each side's own render elsewhere), at ``FLAGSHIP_OWN``;
    the loss to 1e-5."""
    W, H = 96, 72
    js, jcfg, juni, scene, cfg, prm, uni = _setup(name, W, H, CAMS[name]())
    cam = CAMS[name]()
    want = [torch.from_numpy(np.asarray(x).copy()) for x in jax_render_kernel_forward(
        js, cam, s.reference_light(), s.reference_material(), jcfg, PC, planar=True)]
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    keep = conditioned(scene, prm, uni, want[1], cfg) & primals_agree(own, want, cfg.march.max_distance)
    noise = torch.from_numpy(np.random.default_rng(2).uniform(-0.1, 0.1, (3, H, W)).astype(np.float32))
    target = torch.where(keep, want[0] + noise, want[0]).contiguous()
    p_target = torch.where(keep, want[0] + noise, own[0]).contiguous()
    leaves, treedef = jax.tree_util.tree_flatten(js)
    j_loss, j_gp, j_gu = jax_fit_step_kernel(treedef, tuple(jnp.shape(x) for x in leaves),
                                             jax_scene_param_vector(js), juni, jnp.asarray(target.numpy()), jcfg, PC,
                                             wrt_uniforms=True)
    loss, g_prm, g_uni = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, wrt_uniforms=True)
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (own[0] - p_target), *own[1:], cfg)
    st = check_grads(torch.cat([g_prm, g_uni]), np.concatenate([np.asarray(j_gp), np.asarray(j_gu)]), mass,
                     rtol=1e-4, mass_tol=FLAGSHIP_OWN, max_tol=FLAGSHIP_OWN)
    print(f"\n{name}: {st}")
    assert float(g_prm[shaded_slots(scene)].abs().max()) > 0.0


#: SHA-256 of the reference scene's generated header under the reference
#: configuration (the uniforms' gradient, nothing frozen): a scene without
#: tags emits no material code.  (Since its ray form's step skips the sphere
#: where it cannot win, ``ops/scene_program.py::_ray_union``, with
#: ``Ray::unroll`` and ``Ray::lower``; before, the digest began
#: 0a63aa5221353a74.)
REFERENCE_HEADER_SHA256 = "58f7220e5e1bc06f"


def test_tags_equal_to_the_default_change_nothing(tmp_path):
    """The reference scene's header is what it was before materials (no
    material code: its digest), and with its sphere tagged by the uniform
    material its g++ K1 planes and K3 loss and geometry gradients equal the
    untagged scene's bit for bit."""
    plain = tt.reference_scene()
    header = cuda_scene_source(plain, tt.REFERENCE_CONFIG, KernelConfig())
    assert hashlib.sha256(header.encode()).hexdigest().startswith(REFERENCE_HEADER_SHA256)
    assert "material" not in header
    mat = tt.reference_material()
    tagged = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.shaded(tt.sdf.sphere((0.0, 0.4, 0.0), 0.2), mat))
    H, W = 40, 64
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    uni = pack_uniforms(tt.Camera.orbit(azimuth_deg=20.0, elevation_deg=10.0), tt.reference_light(), mat,
                        cfg.ray_mode)
    uni[27] = cfg.shadow.k
    target = torch.from_numpy(np.random.default_rng(9).uniform(0, 1, (3, H, W)).astype(np.float32))
    from sdf3d_tpu_torch.ops import _build

    libs = _build.KernelLibraries(tmp_path / "libs", host=True)
    outs = []
    for scene in (plain, tagged):
        prm = scene_param_vector(scene)
        lib = libs.load(cuda_scene_source(scene, cfg, KernelConfig(), False, ()))
        planes = [np.zeros((3, H, W), np.float32)] + [np.zeros((H, W), np.float32) for _ in range(3)]
        assert lib.sdf3d_render_fwd_host(_ptr(uni), _ptr(prm), *(_ptr(x) for x in planes), H, W) == 0
        cols, live = fit_columns(lib)
        partials = np.zeros((-(-W // 32) * -(-H // 8), live), np.float32)
        totals = np.zeros(cols, np.float64)
        tg = [target[c].contiguous() for c in range(3)]
        assert lib.sdf3d_fit_step_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in tg), None, 0.0, 0.0,
                                       _ptr(partials), _ptr(totals), H, W, 1) == 0
        outs.append((planes, totals, count_params(scene)))
    (pa, ta, Pa), (pb, tb, Pb) = outs
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(a, b)
    assert ta[-1] == tb[-1] and Pb == Pa + 10
    np.testing.assert_array_equal(ta[:Pa], tb[:Pa])


def test_host_tiles_equal_the_grid_on_materials(tmp_path):
    """On ``materials_scene`` the g++ host forms of K2 and K4 over a
    balanced plan of 8×128 tiles, out of image order, give K1's planes and
    K3's partial rows bit for bit for the same blocks (one kernel function
    each, the material program in both)."""
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles

    H, W = 48, 256
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    kc = KernelConfig(tile_h=8, tile_w=128)
    scene = tt.materials_scene()
    prm = scene_param_vector(scene)
    uni = pack_uniforms(tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), tt.reference_light(),
                        tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    lib = _build.KernelLibraries(tmp_path / "libs", host=True).load(cuda_scene_source(scene, cfg, kc, True, ()))
    planes = [np.zeros((3, H, W), np.float32)] + [np.zeros((H, W), np.float32) for _ in range(3)]
    assert lib.sdf3d_render_fwd_host(_ptr(uni), _ptr(prm), *(_ptr(x) for x in planes), H, W) == 0
    target = torch.from_numpy(planes[0] * 0.95).contiguous()
    cols, live = fit_columns(lib)
    rows3 = np.zeros(((W // kc.block_w) * (H // kc.block_h), live), np.float32)
    totals3 = np.zeros(cols, np.float64)
    assert lib.sdf3d_fit_step_host(_ptr(uni), _ptr(prm), *(_ptr(target[c].contiguous()) for c in range(3)), None,
                                   0.0, 0.0, _ptr(rows3), _ptr(totals3), H, W, 1) == 0
    work = np.random.default_rng(5).exponential(size=(H // kc.tile_h, W // kc.tile_w))
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1, "balanced", work)
    trow, tcol = plan.tables(0, "cpu")
    T = int(trow.shape[0])
    k2 = [np.zeros((3, T * kc.tile_h, kc.tile_w), np.float32)] + [np.zeros((T * kc.tile_h, kc.tile_w), np.float32)
                                                                  for _ in range(3)]
    assert lib.sdf3d_render_tiles_host(_ptr(uni), _ptr(prm), _ptr(trow), _ptr(tcol), *(_ptr(x) for x in k2),
                                       T, H, W) == 0
    whole = gather_target_tiles(torch.from_numpy(np.concatenate([planes[0]] + [p[None] for p in planes[1:]])), plan)[0]
    np.testing.assert_array_equal(np.concatenate([k2[0]] + [p[None] for p in k2[1:]]), whole.numpy())
    stack = gather_target_tiles(target, plan)[0].contiguous()
    bx4, by4 = kc.tile_w // kc.block_w, kc.tile_h // kc.block_h
    rows4 = np.zeros((T * bx4 * by4, live), np.float32)
    totals4 = np.zeros_like(totals3)
    assert lib.sdf3d_fit_step_tiles_host(_ptr(uni), _ptr(prm), _ptr(trow), _ptr(tcol),
                                         *(_ptr(stack[k].contiguous()) for k in range(3)), None, 0.0, 0.0,
                                         _ptr(rows4), _ptr(totals4), T, H, W) == 0
    for z in range(T):
        for by in range(by4):
            for bx in range(bx4):
                k3 = (int(trow[z]) // kc.block_h + by) * (W // kc.block_w) + int(tcol[z]) // kc.block_w + bx
                np.testing.assert_array_equal(rows3[k3].view(np.uint32), rows4[(z * by4 + by) * bx4 + bx].view(np.uint32))
    assert np.array_equal(totals3.astype(np.float32), totals4.astype(np.float32))
    assert np.abs(totals3[shaded_slots(scene)]).max() > 0.0
