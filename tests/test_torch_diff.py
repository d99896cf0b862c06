"""``sdf3d_tpu_torch/diff.py`` (the implicit-function gradients through the
march) against the JAX package's ``diff.py``, class for class as
``tests/test_diff.py``: the primal is the port's march bit for bit; the
gradients of ``sphere_trace_implicit``, ``ray_min_sdf_diff``, ``coverage``
and ``render_diff`` match ``jax.vjp``/``jax.grad`` of JAX's on seeded numpy
inputs; the torch engine matches the C++ oracle's finite differences
(``oracle/native.py::native_fd_gradient``) on silhouette-free pixels.

Bars, each beside the error measured here: the rays' gradients 1e-4 of the
gradient mass on conditioned rays (``|∇f·d| ≥ 1e-2`` or a miss; grazing rays
get a zero cotangent, ROADMAP Queue 3), misses exactly 0; ``render_diff``
at ``check_grads``' own-march bar, 1e-3 of the mass (each package marches
its own primal); the finite differences 5e-2 relative (``test_diff.py``'s
bar; measured ≤ 3.4e-2, the camera's height).  The mass of a component is
the sum over pixels of the magnitude of each pixel's term (JAX's pullback
of each pixel's cotangent alone, ``jax.vmap``).  About 40 s on one worker."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.config import MarchConfig, ShadowConfig
from sdf3d_tpu.diff import coverage as jax_coverage
from sdf3d_tpu.diff import ray_min_sdf_diff as jax_ray_min_sdf_diff
from sdf3d_tpu.diff import sphere_trace_implicit as jax_sphere_trace_implicit
from sdf3d_tpu.oracle import native_available, native_fd_gradient
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert, diff
from sdf3d_tpu_torch.march import sphere_trace
from sdf3d_tpu_torch.ops.scene_program import leaves
from sdf3d_tpu_torch.utils.parity import COND_FLOOR, check_grads, check_pixel_budget

torch.set_num_threads(1)

W, H = 32, 24
JCFG = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H, march=MarchConfig(max_steps=100, early_exit=True))
JCAM = s.Camera.reference()


def _jscene(radius=0.2, cx=0.0):
    return s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(cx, 0.4, 0.0), radius=radius))


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _conditioned(scene, o, d, cfg) -> np.ndarray:
    """Rays (H, W) that miss or meet the surface at ``|∇f·d| ≥ COND_FLOOR``."""
    t = sphere_trace(scene.distance, o, d, cfg.march)
    with torch.enable_grad():
        p = (o + t[..., None] * d).detach().requires_grad_(True)
        (g,) = torch.autograd.grad(scene.distance(p).sum(), p)
    den = (g * d).sum(-1)
    return ((den.abs() >= COND_FLOOR) | (t > cfg.march.max_distance)).numpy()


def _jax_grads_and_mass(fn, primals, g):
    """``jax.vjp`` of ``fn`` at ``primals`` pulled back from ``g``, and each
    input component's mass: the sum over pixels of |the pullback of that
    pixel's cotangent alone|.  Both as flat numpy vectors, inputs in order,
    each input's leaves in ``tree_flatten`` order."""
    out, pull = jax.vjp(fn, *primals)
    n = H * W
    g_px = jnp.asarray(g).reshape(n, -1)
    cots = (jnp.eye(n)[:, :, None] * g_px[None]).reshape((n,) + out.shape)
    per_px = jax.vmap(pull)(cots)

    def flat(tree, reduce=None):
        parts = [np.asarray(reduce(x) if reduce else x, np.float32).ravel() for x in jax.tree_util.tree_leaves(tree)]
        return np.concatenate(parts)

    return flat(pull(jnp.asarray(g))), flat(per_px, lambda x: jnp.abs(x).sum(0))


def _port_flat(*objs):
    """The gradients of the port's objects (a scene's leaves, then each
    dataclass's fields, or tensors), flattened in the JAX order."""
    parts = []
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            tensors = [obj]
        elif isinstance(obj, tt.sdf.SDFNode):
            tensors = list(leaves(obj))
        else:
            tensors = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
        parts += [(x.grad if x.grad is not None else torch.zeros_like(x)).reshape(-1).numpy() for x in tensors]
    return np.concatenate(parts)


def _rays():
    o, d = s.camera_rays(JCAM, W, H, JCFG.ray_mode)
    o = jnp.broadcast_to(o, d.shape)
    return np.asarray(o), np.asarray(d)


def _leaf(x):
    return torch.from_numpy(np.array(x)).requires_grad_(True)


class TestImplicitDepth:
    def test_primal_matches_plain_march(self):
        cfg, scene, cam = convert.from_jax(JCFG), convert.from_jax(_jscene()), convert.from_jax(JCAM)
        got = diff.depth_implicit(scene, cam, cfg)
        torch.testing.assert_close(got.detach(), tt.render_depth(scene, cam, cfg), rtol=0, atol=0)
        want = np.asarray(s.depth_implicit(_jscene(), JCAM, JCFG))
        check_pixel_budget(got.detach().clamp(max=100.0), np.minimum(want, 100.0), "t", relative=True)

    def test_head_on_radius_gradient_is_minus_one(self):
        """A ray aimed at the sphere's center: t = |c − o| − r, dt/dr = −1."""
        cfg = convert.from_jax(JCFG)
        sphere = tt.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
        t = diff.sphere_trace_implicit(cfg.march, sphere, torch.tensor([0.0, 0.4, 2.0]), torch.tensor([0.0, 0.0, -1.0]))
        t.backward()
        assert float(sphere.radius.grad) == pytest.approx(-1.0, abs=1e-3)

    def test_miss_rays_zero_gradient(self):
        cfg = convert.from_jax(JCFG)
        sphere = tt.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
        o, d = _leaf([0.0, 5.0, 2.0]), _leaf([0.0, 1.0, 0.0])
        diff.sphere_trace_implicit(cfg.march, sphere, o, d).backward()
        assert float(sphere.radius.grad) == 0.0 and not o.grad.any() and not d.grad.any()

    @pytest.mark.parametrize("fn", ["sphere_trace_implicit", "ray_min_sdf_diff", "coverage"])
    def test_ray_gradients_match_jax_vjp(self, fn):
        """The scene's, the origins' and the directions' gradients of a
        seeded cotangent, ray by ray (64 misses among them), against
        ``jax.vjp`` of JAX's function: 1e-4 of the mass on conditioned rays;
        for the march, the misses' ray gradients exactly 0."""
        jfns = {"sphere_trace_implicit": jax_sphere_trace_implicit, "ray_min_sdf_diff": jax_ray_min_sdf_diff,
                "coverage": lambda c, sc, o, d: jax_coverage(c, sc, o, d, None)}
        jscene, (o_np, d_np) = _jscene(), _rays()
        cfg, scene = convert.from_jax(JCFG), convert.from_jax(jscene)
        o, d = _leaf(o_np), _leaf(d_np)
        g = _cotangent((H, W), 3) * _conditioned(scene, o.detach(), d.detach(), cfg)
        want, mass = _jax_grads_and_mass(lambda sc, oo, dd: jfns[fn](JCFG.march, sc, oo, dd), (jscene, o_np, d_np), g)
        out = getattr(diff, fn)(cfg.march, scene, o, d)
        (out * torch.from_numpy(g)).sum().backward()
        check_grads(_port_flat(scene, o, d), want, mass, rtol=1e-4, mass_tol=1e-4, label=fn)
        if fn == "sphere_trace_implicit":
            miss = out.detach() > cfg.march.max_distance
            assert int(miss.sum()) > 0 and not o.grad[miss].any() and not d.grad[miss].any()


class TestRenderDiff:
    def test_primal_matches_render(self):
        cfg, scene = convert.from_jax(JCFG), convert.from_jax(_jscene())
        view = [convert.from_jax(x) for x in (JCAM, s.reference_light(), s.reference_material())]
        got = diff.render_diff(scene, *view, cfg)
        torch.testing.assert_close(got.detach(), tt.render(scene, *view, cfg), rtol=0, atol=0)
        want = np.asarray(s.render_diff(_jscene(), JCAM, s.reference_light(), s.reference_material(), JCFG))
        check_pixel_budget(got.detach(), want, "rgb", channel_axis=-1)

    @pytest.mark.parametrize("normals", ["central", "autodiff"])
    def test_gradients_match_jax_grad(self, normals):
        """The scene's, the camera's, the light's and the material's
        gradients of a seeded cotangent through ``render_diff`` against
        ``jax.grad`` of JAX's, orbit 30/15 (the plane seen at a slant), at
        the own-march bar of ``check_grads``."""
        jcfg = dataclasses.replace(JCFG, normals=normals)
        jcam = s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
        jscene, jlight, jmat = _jscene(), s.point_light(position=(3.0, 4.0, 2.0)), s.material(shininess=9.0)
        cfg, scene = convert.from_jax(jcfg), convert.from_jax(jscene)
        cam, light, mat = (convert.from_jax(x) for x in (jcam, jlight, jmat))
        for obj in (cam, light, mat):
            for f in dataclasses.fields(obj):
                getattr(obj, f.name).requires_grad_(True)
        o, d = tt.camera_rays(cam, W, H, cfg.ray_mode)
        g = _cotangent((H, W, 3), 5) * _conditioned(scene, o.detach(), d.detach(), cfg)[..., None]
        want, mass = _jax_grads_and_mass(lambda *a: s.render_diff(*a, jcfg), (jscene, jcam, jlight, jmat), g)
        (diff.render_diff(scene, cam, light, mat, cfg) * torch.from_numpy(g)).sum().backward()
        got = _port_flat(scene, cam, light, mat)
        check_grads(got, want, mass, rtol=1e-4, mass_tol=1e-3, label=f"render_diff {normals}")
        assert np.abs(got[:len(list(leaves(scene)))]).max() > 0.0

    @pytest.mark.parametrize("grad", ["detach", "ad"])
    def test_shadow_grad_mode_matches_jax(self, grad):
        """The light position's gradient through ``render_diff`` under each
        ``shadow.grad`` (the march unrolled, as JAX's ``"ad"`` needs): under
        ``"detach"`` the shadow is a constant factor, under ``"ad"`` its
        march is differentiated (measured: 7.2e-7 and 6.5e-5 absolute, of
        components up to 0.72 and 3.08).  Before the shadow honoured
        ``"detach"`` (ROADMAP Queue 3) the port's ``"detach"`` gradient was
        the ``"ad"`` one, 3.2 off."""
        jcfg = dataclasses.replace(JCFG, march=MarchConfig(max_steps=100, early_exit=False),
                                   shadow=ShadowConfig(grad=grad))
        g = _cotangent((H, W, 3), 7)
        jscene = _jscene()

        def loss(lp):
            light = s.point_light(position=lp)
            return jnp.sum(s.render_diff(jscene, JCAM, light, s.reference_material(), jcfg) * g)

        want = np.asarray(jax.grad(loss)(jnp.asarray([5.0, 5.0, 0.0])))
        light = tt.reference_light()
        light.position.requires_grad_(True)
        img = diff.render_diff(convert.from_jax(jscene), tt.Camera.reference(), light, tt.reference_material(),
                               convert.from_jax(jcfg))
        (img * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(light.position.grad.numpy(), want, rtol=1e-4, atol=1e-5)

    def test_render_aa_diff_matches_jax(self):
        jcfg = dataclasses.replace(JCFG, width=16, height=12)
        view = (s.reference_light(), s.reference_material())
        want = np.asarray(s.render_aa(_jscene(), JCAM, *view, jcfg, factor=2, engine="diff"))
        scene, cam, light, mat = (convert.from_jax(x) for x in (_jscene(), JCAM, *view))
        got = tt.render_aa(scene, cam, light, mat, convert.from_jax(jcfg), factor=2, engine="diff", device="cpu")
        assert got.shape == (12, 16, 3) and got.requires_grad
        check_pixel_budget(got.detach(), want, "rgb", channel_axis=-1)

    @pytest.mark.skipif(not native_available(), reason="g++ oracle unavailable")
    @pytest.mark.parametrize("index,name", [(1, "sphere center y"), (3, "sphere radius"), (5, "camera y"),
                                            (9, "light y"), (11, "light ambient"), (21, "shininess")])
    def test_torch_engine_matches_native_fd(self, index, name):
        """The torch engine's gradient of a patch inside the sphere (no
        silhouette) against the C++ oracle's central differences at the
        reference constants, 64×48."""
        cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=64, height=48)
        scene, cam, light, mat = tt.reference_scene(), tt.Camera.reference(), tt.reference_light(), tt.reference_material()
        for obj in (cam, light, mat):
            for f in dataclasses.fields(obj):
                getattr(obj, f.name).requires_grad_(True)
        patch = (slice(19, 23), slice(30, 34))
        diff.render_diff(scene, cam, light, mat, cfg)[patch].sum().backward()
        got = {1: scene.b.center.grad[1], 3: scene.b.radius.grad, 5: cam.position.grad[1],
               9: light.position.grad[1], 11: light.ambient.grad, 21: mat.shininess.grad}[index]
        fd = float(native_fd_gradient(index, 64, 48, eps=1e-3)[patch].sum())
        assert float(got) == pytest.approx(fd, rel=5e-2), name


class TestCoverage:
    def test_coverage_near_one_on_hits_near_zero_on_misses(self):
        cfg, scene = convert.from_jax(JCFG), convert.from_jax(_jscene())
        o, d = tt.camera_rays(tt.Camera.reference(), W, H, cfg.ray_mode)
        cov = diff.coverage(cfg.march, scene, o, d)
        assert cov[10, 16] > 0.9 and cov[20, 16] > 0.9 and cov[1, 16] < 0.1

    def test_min_sdf_gradient_sees_silhouettes(self):
        """A ray that misses the sphere by 0.05: d(closest approach)/dr = −1,
        where the hit distance's gradient is 0."""
        cfg = convert.from_jax(JCFG)
        sphere = tt.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
        diff.ray_min_sdf_diff(cfg.march, sphere, torch.tensor([0.25, 0.4, 2.0]), torch.tensor([0.0, 0.0, -1.0])).backward()
        assert float(sphere.radius.grad) == pytest.approx(-1.0, abs=0.05)
