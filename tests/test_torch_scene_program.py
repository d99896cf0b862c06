"""The scene compiler: torch evaluators against the JAX package's compiled scene
programs, and the generated CUDA source compiled by a C++ compiler for the
CPU and held to the render kernel's plain PyTorch version."""

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.ops.scene_program import compile_scene as jax_compile_scene
from sdf3d_tpu.ops.scene_program import compile_scene_ray as jax_compile_scene_ray
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.ops import (
    KernelConfig,
    compile_scene,
    compile_scene_ray,
    cuda_scene_source,
    pack_uniforms,
    render_kernel_forward_plain,
    scene_param_vector,
)
from sdf3d_tpu_torch.ops._build import CSRC, SCENE_HEADER
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel_plain
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward_plain
from sdf3d_tpu_torch.utils import parity
from sdf3d_tpu_torch.utils.parity import check_grads, check_planes, conditioned, fixed_order_total, gradient_mass

torch.set_num_threads(1)

RNG = np.random.default_rng(7)


def _nested_jax_scene():
    """Union(Union(Plane, Sphere), Sphere) with random parameters: offsets
    past the first subtree."""
    r = RNG.uniform(-1.0, 1.0, 12).astype(np.float32)
    n = r[0:3] / np.linalg.norm(r[0:3])
    return s.sdf.union(
        s.sdf.plane(normal=n, offset=r[3] * 0.3),
        s.sdf.sphere(center=r[4:7], radius=abs(r[7]) * 0.5 + 0.1),
        s.sdf.sphere(center=r[8:11], radius=abs(r[11]) * 0.5 + 0.1),
    )


def csg_sampler():
    """Every node of the flagship's family in one scene: a hard Subtraction
    and Intersection, a SmoothIntersection and SmoothSubtraction, a bare Box
    blended into a sphere by a SmoothUnion, a RoundBox and two tori on the
    ground plane: the JAX twin of ``utils/parity.py::csg_sampler`` (which
    says why its numbers are these)."""
    S = s.sdf
    return S.union(
        S.ground_plane(),
        S.subtraction(S.sphere((-0.55, 0.3, 0.0), 0.2), S.sphere((-0.45, 0.42, 0.12), 0.12)),
        S.intersection(S.sphere((0.0, 0.3, -0.5), 0.22), S.torus(0.2, 0.1, (0.0, 0.3, -0.5))),
        S.smooth_intersection(S.sphere((0.55, 0.3, 0.0), 0.22), S.sphere((0.65, 0.3, 0.05), 0.2), k=0.06),
        S.smooth_subtraction(S.torus(0.25, 0.07, (0.0, 0.1, 0.45)), S.sphere((0.2, 0.12, 0.5), 0.1), k=0.05),
        S.smooth_union(S.sphere((0.0, 0.38, 0.0), 0.2), S.box((0.095, 0.095, 0.095), (0.0, 0.38, 0.0)), k=0.1),
        S.round_box((0.12, 0.08, 0.12), 0.03, (0.45, 0.11, -0.45)),
    )


def transform_sampler():
    """Every node of ROADMAP item 13b with finite gradients: the JAX twin of
    ``utils/parity.py::transform_sampler`` (which says why its numbers are
    these)."""
    S = s.sdf
    return S.union(
        S.ground_plane(),
        S.translate(S.rotate(S.capsule((-0.12, 0.0, 0.0), (0.12, 0.0, 0.0), 0.07), (0.3, 0.5, 0.4)),
                    (-0.55, 0.25, 0.05)),
        S.rotate(S.ellipsoid((0.18, 0.1, 0.12), (-0.15, 0.22, -0.35)), (0.0, 0.0, 0.0)),
        S.round_edges(S.cylinder(0.1, 0.12, (0.55, 0.22, 0.0)), 0.04),
        S.scale(S.sphere((0.0, 0.62, 0.0), 0.18), 0.5),
        S.onion(S.sphere((0.22, 0.25, 0.35), 0.14), 0.02),
        S.translate(S.elongate(S.torus(0.07, 0.035, (0.0, 0.0, 0.0)), (0.1, 0.03, 0.0)), (-0.2, 0.13, 0.4)),
        S.repeat_infinite(S.sphere((0.0, 0.12, -0.6), 0.07), (1.1, 0.0, 0.0)),
    )


def jax_capsule_chain_fit_start():
    """The JAX twin of ``utils/parity.py::capsule_chain_fit_start``."""
    S = s.sdf
    out = None
    for i in range(5):
        sign = -1.0 if i % 2 else 1.0
        a = (-0.6 + 0.3 * i + 0.02 * sign, 0.235 + 0.12 * (i % 2), 0.01)
        b = (-0.6 + 0.3 * (i + 0.7), 0.3 + 0.01 * sign, 0.085)
        link = S.capsule(a, b, 0.09)
        out = link if out is None else S.smooth_union(out, link, k=0.07)
    return S.union(S.ground_plane(), out)


def jax_flagship_fit_start():
    """The flagship with its sphere, rounded box, k and torus moved: the JAX
    twin of ``utils/parity.py::flagship_fit_start``."""
    S = s.sdf
    blob = S.smooth_union(
        S.sphere(center=(-0.22, 0.42, 0.02), radius=0.2),
        S.round_box(half_extents=(0.19, 0.21, 0.2), corner_radius=0.035, center=(0.27, 0.31, 0.0)),
        k=0.13,
    )
    return S.union(S.ground_plane(), blob, S.torus(major=0.47, minor=0.065, center=(0.02, 0.12, 0.33)))


@pytest.mark.parametrize("name", ["sampler", "flagship_fit_start", "transform_sampler", "capsule_chain_fit_start"])
def test_shared_scenes_match_their_jax_twins(name):
    """``utils/parity.py``'s scenes, which the smoke and the card tests use,
    are the JAX scenes these tests build: the same generated header (the
    nodes and their order) and the same parameters, bit for bit."""
    jax_twin, shared = {"sampler": (csg_sampler, parity.csg_sampler),
                        "flagship_fit_start": (jax_flagship_fit_start, parity.flagship_fit_start),
                        "transform_sampler": (transform_sampler, parity.transform_sampler),
                        "capsule_chain_fit_start": (jax_capsule_chain_fit_start,
                                                    parity.capsule_chain_fit_start)}[name]
    twin, port = convert.from_jax(jax_twin()), shared()
    assert [type(m).__name__ for m in twin.modules()] == [type(m).__name__ for m in port.modules()]
    assert cuda_scene_source(twin, tt.REFERENCE_CONFIG, KernelConfig()) == cuda_scene_source(
        port, tt.REFERENCE_CONFIG, KernelConfig())
    assert torch.equal(scene_param_vector(twin), scene_param_vector(port))


SCENES = {"reference": s.reference_scene, "sphere": s.sphere_scene, "nested": _nested_jax_scene,
          "flagship": s.flagship_scene, "sampler": csg_sampler, "csg_showcase": s.csg_showcase,
          "lattice_scene": s.lattice_scene, "capsule_chain": s.capsule_chain,
          "random_blobs": lambda: s.random_blobs(n=8), "transform_sampler": transform_sampler}


def _both(scene_name):
    js = SCENES[scene_name]()
    ts = convert.from_jax(js)
    jvec = jax_scene_param_vector(js)
    tvec = scene_param_vector(ts)
    return js, ts, (lambda i: jvec[i]), (lambda i: tvec[i])


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_point_form_matches_jax(scene_name):
    js, ts, jgetp, tgetp = _both(scene_name)
    pts = RNG.uniform(-2.0, 2.0, (16, 128, 3)).astype(np.float32)
    d_jax = jax_compile_scene(js)(*(jnp.asarray(pts[..., i]) for i in range(3)), jgetp)
    d_t = compile_scene(ts)(*(torch.from_numpy(pts[..., i].copy()) for i in range(3)), tgetp)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_jax), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_ray_form_matches_jax(scene_name):
    js, ts, jgetp, tgetp = _both(scene_name)
    o = RNG.uniform(-2.0, 2.0, (3, 16, 128)).astype(np.float32)
    d = RNG.normal(size=(3, 16, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t = RNG.uniform(0.0, 4.0, (16, 128)).astype(np.float32)
    ev_j = jax_compile_scene_ray(js)(tuple(jnp.asarray(x) for x in o), tuple(jnp.asarray(x) for x in d), jgetp)
    ev_t = compile_scene_ray(ts)(tuple(torch.from_numpy(x.copy()) for x in o),
                                 tuple(torch.from_numpy(x.copy()) for x in d), tgetp)
    np.testing.assert_allclose(ev_t(torch.from_numpy(t)).numpy(), np.asarray(ev_j(jnp.asarray(t))), atol=1e-5, rtol=0)
    # The ray form is the point form along the ray, up to rounding.
    p = o + t[None] * d
    pt = compile_scene(ts)(*(torch.from_numpy(x.copy()) for x in p), tgetp)
    np.testing.assert_allclose(ev_t(torch.from_numpy(t)).numpy(), pt.numpy(), atol=1e-5, rtol=0)


def test_generated_source_reads_parameters_at_run_time():
    """Parameter values never enter the source: two scenes of one structure
    give the same text; another structure or setting gives another."""
    cfg, kc = tt.REFERENCE_CONFIG, KernelConfig()
    a = cuda_scene_source(tt.reference_scene(), cfg, kc)
    other = tt.sdf.union(tt.sdf.plane((0.0, 0.8, 0.6), 0.1), tt.sdf.sphere((0.3, 0.5, -0.2), 0.33))
    assert cuda_scene_source(other, cfg, kc) == a
    assert "n_params = 8" in a and "p[7]" in a
    assert cuda_scene_source(tt.sphere_scene(), cfg, kc) != a
    assert cuda_scene_source(tt.reference_scene(), cfg, KernelConfig(ray_sdf=False)) != a
    assert cuda_scene_source(tt.reference_scene(), dataclasses.replace(cfg, width=64, height=48), kc) == a


def _build_host_library(header: str, out_dir: pathlib.Path, source: str = "render_kernel.cu") -> ctypes.CDLL:
    """Compile a kernel source of csrc/ with the generated header as C++ for
    the CPU (no __CUDACC__: the qualifiers expand to nothing)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    (out_dir / SCENE_HEADER).write_text(header)
    lib = out_dir / f"lib{source.split('.')[0]}_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror", "-Wno-unused-parameter",
           "-I", str(CSRC), "-I", str(out_dir), str(CSRC / source), "-o", str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


HOST_CASES = {
    "reference": (tt.reference_scene, {}, KernelConfig()),
    "point_form": (tt.reference_scene, {}, KernelConfig(ray_sdf=False)),
    "tetra_ao_bg_lambert": (
        tt.reference_scene,
        dict(normals="tetrahedron", shading="lambert", background=(0.2, 0.3, 0.4),
             ao=dataclasses.replace(tt.REFERENCE_CONFIG.ao, enabled=True)),
        KernelConfig(),
    ),
    "nested": (lambda: convert.from_jax(_nested_jax_scene()), {}, KernelConfig()),
    "flagship": (tt.flagship_scene, {}, KernelConfig()),
    "flagship_point_form": (tt.flagship_scene, {}, KernelConfig(ray_sdf=False)),
    "sampler": (lambda: convert.from_jax(csg_sampler()), {}, KernelConfig()),
    "csg_showcase": (lambda: convert.from_jax(s.csg_showcase()), {}, KernelConfig()),
    "lattice_scene": (lambda: convert.from_jax(s.lattice_scene()), {}, KernelConfig()),
    "capsule_chain": (lambda: convert.from_jax(s.capsule_chain()), {}, KernelConfig()),
    "random_blobs": (lambda: convert.from_jax(s.random_blobs(n=8)), {}, KernelConfig()),
    "transform_sampler": (lambda: convert.from_jax(transform_sampler()), {}, KernelConfig()),
    "transform_sampler_point_form": (lambda: convert.from_jax(transform_sampler()), {}, KernelConfig(ray_sdf=False)),
    "fractal": (lambda: tt.fractal_scene(4), {}, KernelConfig()),
    "fractal_relaxed": (lambda: tt.fractal_scene(4), dict(march=dataclasses.replace(tt.REFERENCE_CONFIG.march,
                                                                                    relaxation=1.6)), KernelConfig()),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_generated_source_on_cpu_matches_plain(case, tmp_path):
    scene_fn, overrides, kc = HOST_CASES[case]
    scene = scene_fn()
    H, W = 48, 64
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H, **overrides)
    lib = _build_host_library(cuda_scene_source(scene, cfg, kc), tmp_path)
    fn = lib.sdf3d_render_fwd_host
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int

    cam = tt.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    out = [np.empty((3, H, W), np.float32)] + [np.empty((H, W), np.float32) for _ in range(3)]
    assert fn(uni.numpy().ctypes.data, prm.numpy().ctypes.data, *(o.ctypes.data for o in out), H, W) == 0

    ref = render_kernel_forward_plain(scene, prm, uni, cfg, kc)
    check_planes(out, ref, cfg.march.max_distance)


GRAD_CASES = {
    "reference": (tt.reference_scene, {}),
    "tetra_ao_bg_lambert": (
        tt.reference_scene,
        dict(normals="tetrahedron", shading="lambert", background=(0.2, 0.3, 0.4),
             ao=dataclasses.replace(tt.REFERENCE_CONFIG.ao, enabled=True)),
    ),
    "three_leaves_ao": (
        lambda: tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.0, 0.4, 0.0), 0.2),
                             tt.sdf.sphere((0.35, 0.15, 0.1), 0.15)),
        dict(ao=dataclasses.replace(tt.REFERENCE_CONFIG.ao, enabled=True)),
    ),
    "flagship": (tt.flagship_scene, {}),
    "sampler": (lambda: convert.from_jax(csg_sampler()), {}),
    "fractal": (lambda: tt.fractal_scene(4), {}),
}


def _grad_setup(case):
    scene_fn, overrides = GRAD_CASES[case]
    scene = scene_fn()
    H, W = 48, 64
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H, **overrides)
    cam = tt.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    return scene, cfg, prm, uni, render_kernel_forward_plain(scene, prm, uni, cfg)


def _ptr(x):
    return x.numpy().ctypes.data


def _render_bwd_host(lib, prm, uni, g_rgb, t, sh, ao, wrt_uniforms):
    """The host form of the render backward: ``(partial rows (blocks, G),
    float64 totals (G,))``, G = P + 30 with ``wrt_uniforms``, else P."""
    fn = lib.sdf3d_render_bwd_host
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    kc = KernelConfig()
    cols = prm.numel() + (30 if wrt_uniforms else 0)
    partials = torch.empty((-(-t.shape[1] // kc.block_w) * -(-t.shape[0] // kc.block_h), cols))
    totals = torch.empty(cols, dtype=torch.float64)
    assert fn(_ptr(uni), _ptr(prm), *(_ptr(g) for g in g_rgb), _ptr(t), _ptr(sh), _ptr(ao), _ptr(partials),
              _ptr(totals), *t.shape, int(wrt_uniforms)) == 0
    return partials, totals


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_generated_render_bwd_on_cpu_matches_plain(case, tmp_path):
    """The hand-written reverse pass (csrc/shade_vjp.cuh, render_bwd_kernel.cu)
    built with g++, against autograd through the plain version; its float64
    totals are its partial rows in the fixed order of ``fixed_order_total``."""
    scene, cfg, prm, uni, (_, t, sh, ao) = _grad_setup(case)
    lib = _build_host_library(cuda_scene_source(scene, cfg, KernelConfig()), tmp_path, "render_bwd_kernel.cu")
    keep = conditioned(scene, prm, uni, t, cfg)
    g_rgb = torch.from_numpy(np.random.default_rng(3).normal(size=(3,) + t.shape).astype(np.float32)) * keep
    partials, totals = _render_bwd_host(lib, prm, uni, g_rgb, t, sh, ao, True)
    assert np.array_equal(totals.numpy().view(np.uint64), fixed_order_total(partials.numpy()).view(np.uint64))
    want = torch.cat(render_kernel_backward_plain(scene, prm, uni, g_rgb, t, sh, ao, cfg))
    assert float(want[:prm.numel()].abs().min()) > 0.0
    check_grads(totals.to(torch.float32), want, gradient_mass(scene, prm, uni, g_rgb, t, sh, ao, cfg), rtol=1e-4,
                mass_tol=1e-5)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_generated_render_bwd_params_alone_keeps_bits(case, tmp_path):
    """The host form without the uniforms' gradient (``WRT_U = false``: P
    columns) gives the parameters' partial rows and totals of the form with
    it bit for bit: the same arithmetic per pixel, the same sums."""
    scene, cfg, prm, uni, (_, t, sh, ao) = _grad_setup(case)
    lib = _build_host_library(cuda_scene_source(scene, cfg, KernelConfig()), tmp_path, "render_bwd_kernel.cu")
    g_rgb = torch.from_numpy(np.random.default_rng(7).normal(size=(3,) + t.shape).astype(np.float32))
    rows_u, totals_u = _render_bwd_host(lib, prm, uni, g_rgb, t, sh, ao, True)
    rows_p, totals_p = _render_bwd_host(lib, prm, uni, g_rgb, t, sh, ao, False)
    P = prm.numel()
    assert rows_p.shape == (rows_u.shape[0], P)
    assert float(rows_p.abs().max()) > 0.0
    assert np.array_equal(rows_p.numpy().view(np.uint32), rows_u[:, :P].contiguous().numpy().view(np.uint32))
    assert np.array_equal(totals_p.numpy().view(np.uint64), totals_u[:P].numpy().view(np.uint64))


@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, ()), (True, (0, 1, 2, 3))], ids=["scene", "uniforms-frozen"])
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_generated_fit_step_on_cpu_matches_plain(case, wrt_uniforms, frozen, tmp_path):
    """The fused fit step (fit_kernel.cu: primal, residual, reverse pass)
    built with g++, against the plain version."""
    scene, cfg, prm, uni, (rgb, t, sh, ao) = _grad_setup(case)
    header = cuda_scene_source(scene, cfg, KernelConfig(), wrt_uniforms, frozen)
    lib = _build_host_library(header, tmp_path, "fit_kernel.cu")
    fn = lib.sdf3d_fit_step_host
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    keep = conditioned(scene, prm, uni, t, cfg)
    noise = torch.from_numpy(np.random.default_rng(4).uniform(-0.1, 0.1, rgb.shape).astype(np.float32))
    target = (rgb + noise * keep).contiguous()
    P = prm.numel()
    kc = KernelConfig()
    partials = torch.empty((-(-t.shape[1] // kc.block_w) * -(-t.shape[0] // kc.block_h), P + 31))
    totals = torch.empty(P + 31, dtype=torch.float64)
    assert fn(_ptr(uni), _ptr(prm), *(_ptr(c) for c in target), _ptr(partials), _ptr(totals), *t.shape) == 0
    out = totals.to(torch.float32)

    loss, g_prm, g_uni = fit_step_kernel_plain(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen)
    assert float(out[-1]) == pytest.approx(float(loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    check_grads(out[:-1], torch.cat([g_prm, g_uni]), mass, rtol=1e-4, mass_tol=1e-4, max_tol=1e-3)
    assert all(float(out[k]) == 0.0 for k in frozen)
    assert float(out[P - 1].abs()) > 0.0
    if not wrt_uniforms:
        assert float(out[P:-1].abs().max()) == 0.0
