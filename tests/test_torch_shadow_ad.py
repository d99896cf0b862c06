"""``shadow.grad == "ad"`` on the port's kernel engine against the JAX package:
``render_kernel_diff`` (K1 forward, the planar re-trace with the shadow ray
re-marched as backward; JAX's ``render_pallas`` sends the mode to
``_planar_shade``), ``render_neural`` under the same mode, and the fits that
take the route (``fit_scene``, ``fit_view``, ``fit_scene_multiview`` on the
kernel engine).  JAX's side runs its Pallas kernels in interpret mode.

Bars, each beside the error measured here (32×24, seeded cotangents; the
tests print their ``[measured]`` errors under ``pytest -s``):
- the primal equals the ``"detach"`` render's bit for bit;
- gradients (``check_grads``, rtol 1e-4): each side marching its own
  primal, 1e-3 of the gradient mass (the own-march bar of ROADMAP Queue 3),
  the cotangent zero where the primals disagree or the gradient is
  ill-conditioned; the mass counts the re-marched shadow's terms.
  Measured 3.6e-6 and 1.5e-5 of the mass (the two cases), 1.5e-5 for
  ``render_neural``;
- the penumbra gradient within 10% of central finite differences of the
  ``"detach"`` render (JAX's ``test_penumbra_gradient_matches_fd``);
- three Adam steps of the fits: losses 1e-4 relative (measured 2.4e-6,
  4.3e-5, 2.8e-6), parameters 15% of their move plus 1e-6 (the trajectory
  bars of ``test_torch_fit.py``).
"""

import dataclasses

import jax
import jax.flatten_util as fu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu.fit import fit_scene as jax_fit_scene
from sdf3d_tpu.fit import fit_scene_multiview as jax_fit_scene_multiview
from sdf3d_tpu.fit import fit_view as jax_fit_view
from sdf3d_tpu.ops import PallasRenderConfig, render_pallas
from sdf3d_tpu.ops.neural_kernel import NeuralRenderConfig as JaxNeuralRenderConfig
from sdf3d_tpu.ops.neural_kernel import render_neural as jax_render_neural
from sdf3d_tpu.ops.neural_kernel import render_neural_forward as jax_render_neural_forward
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu.sdf import neural_sdf as jax_neural_sdf
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.camera import focal_z
from sdf3d_tpu_torch.fit import fit_scene, fit_scene_multiview, fit_view
from sdf3d_tpu_torch.ops import KernelConfig, pack_uniforms, render_kernel_forward, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, neural_distance, render_neural, \
    render_neural_forward_plain
from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
from sdf3d_tpu_torch.utils.parity import check_grads, conditioned, gradient_mass, primals_agree

torch.set_num_threads(1)

W, H = 32, 24
PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True, ray_sdf=False)
KC = KernelConfig(ray_sdf=False)
BASE = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)


def _ad(cfg):
    return dataclasses.replace(cfg, shadow=dataclasses.replace(cfg.shadow, grad="ad"))


def _view_tensors(cam, light, mat):
    """The camera's, light's and material's tensors in field order, each a
    leaf that takes a gradient."""
    tensors = [getattr(o, f.name) for o in (cam, light, mat) for f in dataclasses.fields(o)]
    for x in tensors:
        x.requires_grad_(True)
    return tensors


def _port_grads(scene, tensors):
    return torch.cat([leaf.grad.reshape(-1) for leaf in leaves(scene)]
                     + [(x.grad if x.grad is not None else torch.zeros_like(x)).reshape(-1) for x in tensors])


def _jax_grads(jg):
    return np.concatenate([np.asarray(fu.ravel_pytree(jg[0])[0])] + [
        np.asarray(getattr(jv, f.name), np.float32).ravel() for jv in jg[1:] for f in dataclasses.fields(jv)])


def _mass_to_leaves(mass, P, cam, cfg):
    """From the (P + 30) slots of the parameter vector and the uniforms to
    the leaves' order: the scene's slots, the camera's (the field of view
    through |d focal_z / d fov|), the light's (its colour in no uniform: 0),
    the material's."""
    fov = cam.fov_deg.detach().clone().requires_grad_(True)
    (dfz,) = torch.autograd.grad(focal_z(fov, cfg.ray_mode), fov)
    u = mass[P:]
    return torch.cat([mass[:P], u[0:12], (u[12] * dfz.abs()).reshape(1), u[13:16], torch.zeros(3), u[16:27]])


CASES = {
    # (normals, AO, camera)
    "central-reference": ("central", False, s.Camera.reference),
    "tetrahedron-ao-orbit": ("tetrahedron", True, lambda: s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)),
}


def test_ad_primal_is_bit_exact_with_detach():
    """The primal under "ad" is the kernel's plane: the "detach" render's and
    ``render_kernel_forward``'s bit for bit (JAX's
    ``test_ad_mode_primal_is_bit_exact_with_detach``)."""
    cfg = convert.from_jax(BASE)
    view = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())
    a = render_kernel_diff(cfg, KC, tt.reference_scene(), *view)
    b = render_kernel_diff(_ad(cfg), KC, tt.reference_scene(), *view)
    assert b.requires_grad
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(b.detach(), render_kernel_forward(tt.reference_scene(), *view, cfg, KC)[0], rtol=0,
                               atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ad_gradient_matches_jax(case):
    """The gradient of ⟨render, g⟩ for every scene leaf and every camera,
    light and material tensor through ``render_kernel_diff`` under "ad"
    against ``jax.grad`` through JAX's ``render_pallas`` under "ad"; the
    light's gradient differs from the "detach" one (the re-march's share)."""
    normals, ao, cam_fn = CASES[case]
    jcfg = _ad(dataclasses.replace(BASE, normals=normals, ao=dataclasses.replace(BASE.ao, enabled=ao)))
    jscene, jcam, jlight, jmat = s.reference_scene(), cam_fn(), s.reference_light(), s.reference_material()
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    own = render_kernel_forward_plain(scene, prm, uni, cfg, KC)
    jax_planes = [torch.from_numpy(np.array(x)) for x in jax_render_kernel_forward(jscene, jcam, jlight, jmat, jcfg,
                                                                                   PC, planar=True)]
    keep = (conditioned(scene, prm, uni, own[1], cfg) & primals_agree(own, jax_planes, cfg.march.max_distance)).numpy()
    assert keep.mean() > 0.9
    g = np.random.default_rng(7).normal(size=(3, H, W)).astype(np.float32) * keep
    g_img = np.ascontiguousarray(np.transpose(g, (1, 2, 0)))

    tensors = _view_tensors(cam, light, mat)
    (render_kernel_diff(cfg, KC, scene, cam, light, mat) * torch.from_numpy(g_img)).sum().backward()
    got = _port_grads(scene, tensors)

    def loss(sc, c, l, m):
        return jnp.sum(render_pallas(jcfg, PC, sc, c, l, m) * jnp.asarray(g_img))

    want = _jax_grads(jax.grad(loss, argnums=(0, 1, 2, 3))(jscene, jcam, jlight, jmat))
    mass = _mass_to_leaves(gradient_mass(scene, prm, uni, torch.from_numpy(g), *own[1:], cfg, remarch_shadow=True),
                           prm.numel(), cam, cfg)
    print(f"[measured] 'ad' {case}:", check_grads(got, want, mass, rtol=1e-4, mass_tol=1e-3,
                                                  label=f"render_kernel_diff under 'ad' ({case})"))

    # The re-march's share: the light's gradient moves against "detach"'s.
    scene_d, cam_d, light_d, mat_d = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat))
    light_d.position.requires_grad_(True)
    (render_kernel_diff(convert.from_jax(dataclasses.replace(jcfg, shadow=BASE.shadow)), KC, scene_d, cam_d, light_d,
                        mat_d) * torch.from_numpy(g_img)).sum().backward()
    assert float((light_d.position.grad - light.position.grad).abs().max()) > 1e-2 * float(
        light.position.grad.abs().max())


def test_ad_gradient_is_finite_where_a_shadow_ray_leaves_a_plane():
    """A shadow ray that marches straight away from the plane doubles its
    distance each step, so ``d2 = s² − inter²`` is exactly 0 and the
    closest-approach ``sqrt`` has an infinite derivative there.  JAX's
    ``march._sqrt_grad_safe`` gives it 0; the port's ``march.soft_shadow``
    does the same (ROADMAP Queue 3).  At 64×48 under the reference camera
    with a cotangent of ones (of 32×24, 40×30, 48×36 and 64×48 the size
    where the plain square root made every scene gradient NaN), against
    ``jax.grad`` through JAX's ``render_pallas`` at the own-march bar."""
    w, h = 64, 48
    jcfg = _ad(dataclasses.replace(BASE, width=w, height=h))
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (s.reference_scene(), s.Camera.reference(),
                                                                 s.reference_light(), s.reference_material(), jcfg))
    (render_kernel_diff(cfg, KC, scene, cam, light, mat)).sum().backward()
    got = torch.cat([leaf.grad.reshape(-1) for leaf in leaves(scene)])
    assert bool(torch.isfinite(got).all())
    want = np.asarray(fu.ravel_pytree(jax.grad(lambda sc: jnp.sum(render_pallas(
        jcfg, PC, sc, s.Camera.reference(), s.reference_light(), s.reference_material())))(s.reference_scene()))[0])
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    _, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg, KC)
    mass = gradient_mass(scene, prm, uni, torch.ones((3, h, w)), t, sh, ao, cfg, remarch_shadow=True)
    print(f"[measured] 'ad' at {w}x{h}:", check_grads(got, want, mass[:prm.numel()], rtol=1e-4, mass_tol=1e-3,
                                                    label=f"'ad' at {w}x{h}"))


def test_penumbra_gradient_matches_fd():
    """On the penumbra pixels (plane hits with a shadow in (0.05, 0.8)) the
    sphere radius's gradient under "ad" is within 10% of the central finite
    difference of the "detach" render, as JAX's test on its engine."""
    cfg = convert.from_jax(BASE)
    view = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())

    def scene_of(r):
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.0, 0.4, 0.0), r))

    _, t, sh, _ = render_kernel_forward(scene_of(0.2), *view, cfg, KC)
    mask = ((sh > 0.05) & (sh < 0.8) & (t < 50.0)).to(torch.float32)
    assert int(mask.sum()) > 10, "no penumbra pixels at this resolution"
    scene = scene_of(0.2)
    (render_kernel_diff(_ad(cfg), KC, scene, *view) * mask[..., None]).sum().backward()
    g_ad = float(scene.b.radius.grad)

    def loss(r):
        return float((render_kernel_forward(scene_of(r), *view, cfg, KC)[0].double() * mask[..., None]).sum())

    e = 1e-3
    fd = (loss(0.2 + e) - loss(0.2 - e)) / (2 * e)
    assert g_ad == pytest.approx(fd, rel=0.1)
    scene_d = scene_of(0.2)
    (render_kernel_diff(cfg, KC, scene_d, *view) * mask[..., None]).sum().backward()
    assert abs(float(scene_d.b.radius.grad) - fd) > 0.1 * abs(fd)  # "detach" drops most of it


def test_render_backward_keeps_detached_semantics():
    """K5's wrapper raises for "ad" (its semantics is the detached factor's),
    and its plain version gives the "detach" gradient whatever ``cfg`` says."""
    cfg = convert.from_jax(BASE)
    scene = tt.reference_scene()
    view = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())
    prm = scene_param_vector(scene)
    uni = pack_uniforms(*view, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    _, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(3, H, W)).astype(np.float32))
    with pytest.raises(ValueError, match="detached factor"):
        render_kernel_backward(scene, prm, uni, g, t, sh, ao, _ad(cfg))
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward_plain

    a = render_kernel_backward_plain(scene, prm, uni, g, t, sh, ao, cfg)
    b = render_kernel_backward_plain(scene, prm, uni, g, t, sh, ao, _ad(cfg))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_render_neural_ad_gradients_match_jax():
    """``render_neural`` under "ad" (the MLP re-evaluated at every step of the
    re-marched shadow ray) against ``jax.grad`` of JAX's ``render_neural``
    under "ad", each side's own forward (the neural kernel's plain version,
    JAX's in interpret mode), at the own-march bar."""
    jn = jax_neural_sdf(key=3, hidden=8, depth=2, radius=0.3)
    jscene = s.sdf.union(s.sdf.ground_plane(), jn)
    jcam = s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    jlight, jmat = s.reference_light(), s.reference_material()
    jcfg = _ad(dataclasses.replace(BASE, march=dataclasses.replace(BASE.march, max_steps=48),
                                   shadow=dataclasses.replace(BASE.shadow, max_steps=24)))
    jnc = JaxNeuralRenderConfig(interpret=True)
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    own = render_neural_forward_plain(scene, prm, uni, cfg)
    jrgb, jt, jsh, jao = jax_render_neural_forward(jscene, jcam, jlight, jmat, jcfg, jnc)
    jax_planes = [torch.from_numpy(np.array(x)) for x in (jnp.transpose(jrgb, (2, 0, 1)), jt, jsh, jao)]
    dist = neural_distance(scene)
    keep = (conditioned(dist, prm, uni, own[1], cfg) & primals_agree(own, jax_planes, cfg.march.max_distance,
                                                                     atol=1e-3)).numpy()
    assert keep.mean() > 0.9
    g = np.random.default_rng(5).normal(size=(3, H, W)).astype(np.float32) * keep
    g_img = np.ascontiguousarray(np.transpose(g, (1, 2, 0)))

    tensors = _view_tensors(cam, light, mat)
    (render_neural(cfg, NeuralRenderConfig(), scene, cam, light, mat) * torch.from_numpy(g_img)).sum().backward()
    got = _port_grads(scene, tensors)

    def loss(sc, c, l, m):
        return jnp.sum(jax_render_neural(jcfg, jnc, sc, c, l, m) * jnp.asarray(g_img))

    want = _jax_grads(jax.grad(loss, argnums=(0, 1, 2, 3))(jscene, jcam, jlight, jmat))
    mass = _mass_to_leaves(gradient_mass(dist, prm, uni, torch.from_numpy(g), *own[1:], cfg, remarch_shadow=True),
                           prm.numel(), cam, cfg)
    print("[measured] render_neural 'ad':", check_grads(got, want, mass, rtol=1e-4, mass_tol=1e-3,
                                                        label="render_neural under 'ad'"))


def _fit_setup():
    jcfg = _ad(BASE)
    jcam, jlight, jmat = s.Camera.reference(), s.reference_light(), s.reference_material()
    target = np.asarray(s.render(s.reference_scene(), jcam, jlight, jmat, jcfg))
    jscene0 = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))
    flags = iter((False, False, True, True))
    return jcfg, (jcam, jlight, jmat), target, jscene0, jax.tree_util.tree_map(lambda _: next(flags), jscene0)


def _held(got_p, want_p, start_p):
    moved = want_p - start_p
    diff = got_p - start_p - moved
    assert np.all(np.abs(diff) <= 0.15 * np.abs(moved) + 1e-6), (diff, moved)


@pytest.mark.parametrize("fit", ["fit_scene", "fit_view", "fit_scene_multiview"])
def test_fits_under_ad_match_jax(fit, monkeypatch):
    """Three Adam steps of the kernel engine's fits under "ad" against JAX's
    pallas-engine fits (interpret mode): the scene fit (the sphere, the
    plane frozen), the view fit (the light) and the two-view scene fit.  Each
    step renders once through ``render_kernel_diff`` and never through the
    fused fit step or the render backward kernel's wrapper."""
    from sdf3d_tpu_torch import fit as fit_module
    from sdf3d_tpu_torch.ops import render_autograd

    calls = []
    monkeypatch.setattr(render_autograd, "render_kernel_backward",
                        lambda *a, **k: calls.append("render_kernel_backward"))
    monkeypatch.setattr(fit_module, "fit_step_kernel", lambda *a, **k: calls.append("fit_step_kernel"))
    jcfg, (jcam, jlight, jmat), target, jscene0, jmask = _fit_setup()
    jfc = JaxFitConfig(steps=3, learning_rate=1e-2, log_every=1, engine="pallas", pallas_interpret=True,
                       pallas_tile=(8, 128))
    fc = convert.from_jax(jfc)
    cfg, cam, light, mat = (convert.from_jax(o) for o in (jcfg, jcam, jlight, jmat))
    if fit == "fit_scene":
        want = jax_fit_scene(target, jscene0, jcam, jlight, jmat, jcfg, jfc, trainable=jmask)
        got = fit_scene(target, convert.from_jax(jscene0), cam, light, mat, cfg, fc,
                        trainable=(False, False, True, True), device="cpu")
        _held(scene_param_vector(got.scene).numpy(), np.asarray(jax_scene_param_vector(want.scene)),
              np.asarray(jax_scene_param_vector(jscene0)))
    elif fit == "fit_view":
        jlight0 = dataclasses.replace(jlight, position=jlight.position + jnp.asarray([0.3, -0.2, 0.1]))
        want = jax_fit_view(target, s.reference_scene(), jcam, jlight0, jmat, jcfg, jfc, optimize=("light",))
        got = fit_view(target, tt.reference_scene(), cam, convert.from_jax(jlight0), mat, cfg, fc, optimize=("light",),
                       device="cpu")
        _held(got.light.position.detach().numpy(), np.asarray(want.light.position), np.asarray(jlight0.position))
    else:
        jcams = [jcam, s.Camera.orbit(azimuth_deg=40.0, elevation_deg=10.0)]
        targets = [target, np.asarray(s.render(s.reference_scene(), jcams[1], jlight, jmat, jcfg))]
        want = jax_fit_scene_multiview(targets, jscene0, jcams, jlight, jmat, jcfg, jfc, trainable=jmask)
        got = fit_scene_multiview(targets, convert.from_jax(jscene0), [convert.from_jax(c) for c in jcams], light, mat,
                                  cfg, fc, trainable=(False, False, True, True), device="cpu")
        _held(scene_param_vector(got.scene).numpy(), np.asarray(jax_scene_param_vector(want.scene)),
              np.asarray(jax_scene_param_vector(jscene0)))
    assert got.steps_run == want.steps_run == 3 and calls == []
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    print(f"[measured] {fit} losses:", float(np.max(np.abs(np.asarray(got.losses) / np.asarray(want.losses) - 1))))
