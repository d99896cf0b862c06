"""The render modes of ROADMAP item 13c against the JAX package: the
over-relaxed march (``march.relaxation``) in the torch engine, in the
render kernel's plain version and in the g++ host forms of K1 and K3;
autodiff normals (``normals="autodiff"``, the torch engine; the kernels
raise as JAX's Pallas path does); ``render_aa`` and ``render_depth``.  Also
the square root of the plain versions (``sdf.node.sqrt_rn``): rounded to
nearest, as the kernels' ``sqrtf``, so that the host forms keep the plain
version's bits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.march import normal_autodiff as jax_normal_autodiff
from sdf3d_tpu.march import sphere_trace as jax_sphere_trace
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.march import normal_autodiff, sphere_trace
from sdf3d_tpu_torch.ops import KernelConfig, _build, cuda_scene_source, pack_uniforms, render_kernel_forward
from sdf3d_tpu_torch.ops import render_kernel_forward_plain, scene_param_vector
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel, fit_step_kernel_plain
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
from sdf3d_tpu_torch.ops.scene_program import leaves
from sdf3d_tpu_torch.sdf.node import sqrt_rn
from sdf3d_tpu_torch.utils.parity import check_grads, check_pixel_budget, check_planes, conditioned, gradient_mass

torch.set_num_threads(1)

W, H = 64, 48
OMEGA = 1.6
SCENES = {"reference": s.reference_scene, "fractal": lambda: s.fractal_scene(4), "flagship": s.flagship_scene}


def _cfg(omega=OMEGA, **kw):
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H, **kw)
    return dataclasses.replace(cfg, march=dataclasses.replace(cfg.march, relaxation=omega))


def _t_budget(got, want, label):
    """The t plane's measure of ``check_planes``: clamped to
    ``max_distance``, relative to ``max(1, t)``, at the image budget."""
    return check_pixel_budget(np.minimum(got, 100.0), np.minimum(want, 100.0), label, relative=True)


@pytest.mark.parametrize("scene_name", ["reference", "fractal", "flagship"])
def test_relaxed_sphere_trace_matches_jax(scene_name):
    """``sphere_trace`` at ω = 1.6 against JAX's ``_sphere_trace_relaxed``
    per ray, camera rays at 64×48 (reference camera): the budget of the t
    plane (measured 5.5e-7 relative on the reference scene, 1.1e-6 on the
    fractal)."""
    js = SCENES[scene_name]()
    jcfg = _cfg()
    o, d = s.camera_rays(s.Camera.reference(), W, H, jcfg.ray_mode)
    want = np.asarray(jax_sphere_trace(js.distance, o, d, jcfg.march))
    with torch.no_grad():
        got = sphere_trace(convert.from_jax(js).distance, torch.from_numpy(np.asarray(o).copy()),
                           torch.from_numpy(np.asarray(d).copy()), convert.from_jax(jcfg.march)).numpy()
    _t_budget(got, want, scene_name)
    # Over-relaxed, and not the exact march: some rays end elsewhere.
    exact = np.asarray(jax_sphere_trace(js.distance, o, d, dataclasses.replace(jcfg.march, relaxation=1.0)))
    assert not np.array_equal(exact, want)


def _port_inputs(jscene, jcam, jcfg):
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, s.reference_light(),
                                                                  s.reference_material(), jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    return scene, cfg, prm, uni


@pytest.mark.parametrize("ray_sdf", [True, False], ids=["ray", "point"])
@pytest.mark.parametrize("scene_name", ["reference", "flagship"])
def test_relaxed_plain_kernel_matches_jax_kernel(scene_name, ray_sdf):
    """The render kernel's plain version at ω = 1.6 against JAX's
    interpret-mode kernel (its ``relaxed_body``) at 64×48 under orbit
    30/15: all four planes at JAX's own kernel bar (under 0.05% of pixels
    over 1e-4, ``tests/test_pallas.py``)."""
    jcfg = _cfg()
    jscene, jcam = SCENES[scene_name](), s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    pc = PallasRenderConfig(tile_h=8, tile_w=64, interpret=True, ray_sdf=ray_sdf)
    want = [torch.from_numpy(np.asarray(x).copy()) for x in jax_render_kernel_forward(
        jscene, jcam, s.reference_light(), s.reference_material(), jcfg, pc, planar=True)]
    scene, cfg, prm, uni = _port_inputs(jscene, jcam, jcfg)
    got = render_kernel_forward_plain(scene, prm, uni, cfg, KernelConfig(ray_sdf=ray_sdf))
    check_planes(got, want, cfg.march.max_distance)
    exact = render_kernel_forward_plain(scene, prm, uni, dataclasses.replace(cfg, march=dataclasses.replace(
        cfg.march, relaxation=1.0)), KernelConfig(ray_sdf=ray_sdf))
    assert not torch.equal(exact[1], got[1])


_HOST = {}


def _host(header):
    import shutil
    import tempfile

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if "libs" not in _HOST:
        _HOST["libs"] = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_modes_"), host=True)
    return _HOST["libs"].load(header)


def _ptr(x):
    return x.numpy().ctypes.data


@pytest.mark.parametrize("scene_name", ["reference", "fractal"])
def test_relaxed_host_forms_match_plain(scene_name):
    """The g++ builds of K1 and K3 at ω = 1.6 (the relaxed branch of
    ``render_kernel.cuh::march_primary``, which K1-K4 share) against their
    plain versions: K1's planes at the pixel budget (the t, shadow and AO
    planes of the reference scene bit for bit), K3's loss and gradient at
    the fit step's host bar (``test_torch_scene_program.py``)."""
    js = SCENES[scene_name]()
    scene, cfg, prm, uni = _port_inputs(js, s.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0), _cfg())
    lib = _host(cuda_scene_source(scene, cfg, KernelConfig(), False, (0, 1, 2, 3)))
    out = [torch.empty((3, H, W))] + [torch.empty((H, W)) for _ in range(3)]
    assert lib.sdf3d_render_fwd_host(_ptr(uni), _ptr(prm), *(_ptr(o) for o in out), H, W) == 0
    plain = render_kernel_forward_plain(scene, prm, uni, cfg)
    check_planes(out, plain, cfg.march.max_distance)
    if scene_name == "reference":
        for a, b in zip(out[1:], plain[1:]):
            assert torch.equal(a, b)

    rgb, t, sh, ao = plain
    keep = conditioned(scene, prm, uni, t, cfg)
    noise = torch.from_numpy(np.random.default_rng(4).uniform(-0.1, 0.1, rgb.shape).astype(np.float32))
    target = (rgb + noise * keep).contiguous()
    P = prm.numel()
    partials = torch.empty((-(-W // 32) * -(-H // 8), P + 31))
    totals = torch.empty(P + 31, dtype=torch.float64)
    assert lib.sdf3d_fit_step_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in target), _ptr(partials), _ptr(totals),
                                   H, W) == 0
    loss, g_prm, _ = fit_step_kernel_plain(scene, prm, uni, target, cfg, KernelConfig(), False, (0, 1, 2, 3))
    got = totals.to(torch.float32)
    assert float(got[-1]) == pytest.approx(float(loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)[:P]
    check_grads(got[:P], g_prm, mass, rtol=1e-4, mass_tol=1e-4, max_tol=1e-3)
    assert float(got[:4].abs().max()) == 0.0 and float(got[P:-1].abs().max()) == 0.0


@pytest.mark.parametrize("scene_name", ["reference", "fractal", "flagship"])
def test_normal_autodiff_matches_jax(scene_name):
    """``normal_autodiff`` (``torch.autograd.grad`` of the distance,
    normalised) against JAX's ``jax.grad`` normals at seeded points (the
    fractal's measured 1.9e-5: JAX's CPU ``rsqrt``), and differentiable: the
    gradient of a sum of the normals reaches the scene's parameters as
    ``jax.grad`` of JAX's."""
    js = SCENES[scene_name]()
    pts = (np.random.default_rng(5).uniform(-0.6, 0.6, (256, 3)) + np.array([0.0, 0.4, 0.0])).astype(np.float32)
    want = np.asarray(jax_normal_autodiff(js.distance, jnp.asarray(pts)))
    ts = convert.from_jax(js)
    with torch.no_grad():
        got = normal_autodiff(ts.distance, torch.from_numpy(pts))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 if scene_name == "fractal" else 1e-5, rtol=0)

    w = np.random.default_rng(6).normal(size=pts.shape).astype(np.float32)
    g_want = jax.grad(lambda sc: jnp.sum(jax_normal_autodiff(sc.distance, jnp.asarray(pts)) * w))(js)
    n = normal_autodiff(ts.distance, torch.from_numpy(pts))
    (n * torch.from_numpy(w)).sum().backward()
    got_g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in leaves(ts)]).numpy()
    want_g = np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(g_want)])
    # NaN in the same slots as JAX's: on the fractal one point's second
    # derivative meets the escape selects' overflow (ROADMAP Queue 3).
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3, atol=1e-3 * np.nanmax(np.abs(want_g)))


def test_autodiff_normals_render_and_kernels_raise():
    """The torch engine renders with autodiff normals as JAX's XLA render
    does (the image budget); K1, K3 and K5 raise ``ValueError``, as JAX's
    Pallas path."""
    jcfg = _cfg(1.0, normals="autodiff")
    js, jcam = s.reference_scene(), s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    want = np.asarray(s.render(js, jcam, s.reference_light(), s.reference_material(), jcfg))
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (js, jcam, s.reference_light(),
                                                                  s.reference_material(), jcfg))
    got = tt.render(scene, cam, light, mat, cfg)
    check_pixel_budget(got, want, "rgb", channel_axis=-1)
    with pytest.raises(ValueError, match="autodiff"):
        render_kernel_forward(scene, cam, light, mat, cfg)
    prm, uni = scene_param_vector(scene), pack_uniforms(cam, light, mat, cfg.ray_mode)
    with pytest.raises(ValueError, match="autodiff"):
        fit_step_kernel(scene, prm, uni, torch.zeros((3, H, W)), cfg)
    with pytest.raises(ValueError, match="autodiff"):
        render_kernel_backward(scene, prm, uni, torch.zeros((3, H, W)), torch.ones((H, W)), torch.ones((H, W)),
                               torch.ones((H, W)), cfg)


@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_render_aa_matches_jax(engine):
    """``render_aa`` (factor 2, 32×24 out of 64×48) in both engines against
    JAX's ``render_aa`` (its XLA engine; its Pallas engine runs compiled
    only), at the image budget; JAX's ``"diff"`` engine raises naming item
    5."""
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=32, height=24)
    js, jcam = s.flagship_scene(), s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    want = np.asarray(s.render_aa(js, jcam, s.reference_light(), s.reference_material(), jcfg, factor=2))
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (js, jcam, s.reference_light(),
                                                                  s.reference_material(), jcfg))
    got = tt.render_aa(scene, cam, light, mat, cfg, factor=2, engine=engine, device="cpu")
    assert got.shape == (24, 32, 3)
    check_pixel_budget(got, want, "rgb", channel_axis=-1)
    with pytest.raises(NotImplementedError, match="item 5"):
        tt.render_aa(scene, cam, light, mat, cfg, engine="diff", device="cpu")


@pytest.mark.parametrize("omega", [1.0, OMEGA])
def test_render_depth_matches_jax(omega):
    """``render_depth`` against JAX's on the fractal (four iterations), the
    exact and the relaxed march, at the t plane's budget."""
    jcfg = _cfg(omega)
    js = s.fractal_scene(4)
    want = np.asarray(s.render_depth(js, s.Camera.reference(), jcfg))
    got = tt.render_depth(convert.from_jax(js), tt.Camera.reference(), convert.from_jax(jcfg))
    assert got.shape == (H, W) and not got.requires_grad
    _t_budget(got.numpy(), want, f"depth at {omega}")


def test_plain_sqrt_is_rounded_to_nearest():
    """``sqrt_rn`` equals IEEE ``sqrtf`` (numpy's float32 square root) bit
    for bit on a million seeded values across exponents, zeros and
    infinities included, and has lax's derivative ``g·(0.5/r)``.  (torch's
    own float32 ``sqrt`` on the CPU misses by an ulp on some inputs, and
    on which depends on the machine.)"""
    r = np.random.default_rng(12)
    x = (r.uniform(0.0, 1.0, 1_000_000) * 10.0 ** r.integers(-30, 30, 1_000_000)).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, np.float32(0.99999994)]
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), np.sqrt(x).view(np.uint32))
    xt = torch.from_numpy(x[4:1000].copy()).requires_grad_(True)
    y = sqrt_rn(xt)
    y.backward(torch.ones_like(y))
    assert torch.equal(xt.grad, 0.5 / y.detach())


@pytest.mark.parametrize("scene_name", ["reference", "flagship"])
def test_host_render_keeps_the_plain_bits(scene_name):
    """With the square root rounded to nearest on both sides, the g++ build
    of K1 gives the plain version's t, shadow and AO planes bit for bit (the
    shading's ``powf`` moves rgb by an ulp), the exact march included."""
    scene, cfg, prm, uni = _port_inputs(SCENES[scene_name](), s.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0),
                                        _cfg(1.0))
    lib = _host(cuda_scene_source(scene, cfg, KernelConfig()))
    out = [torch.empty((3, H, W))] + [torch.empty((H, W)) for _ in range(3)]
    assert lib.sdf3d_render_fwd_host(_ptr(uni), _ptr(prm), *(_ptr(o) for o in out), H, W) == 0
    plain = render_kernel_forward_plain(scene, prm, uni, cfg)
    for a, b in zip(out[1:], plain[1:]):
        assert torch.equal(a, b)
    assert float((out[0] - plain[0]).abs().max()) < 1e-6
