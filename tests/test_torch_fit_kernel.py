"""The fused fit step's plain PyTorch version against the JAX package's Pallas
fit kernel (``fit_step_kernel``, interpret mode on the CPU), and the
differentiable kernel render (``render_kernel_diff``) against the fused step."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import fit_step_kernel as jax_fit_step_kernel
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel, fit_step_kernel_plain, l2_loss_and_grads
from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
from sdf3d_tpu_torch.utils.parity import (
    COND_FLOOR,
    FLAGSHIP_OWN,
    check_grads,
    conditioned,
    gradient_mass,
    primals_agree,
)
from test_torch_scene_program import transform_sampler

torch.set_num_threads(1)

PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
FROZEN = (0, 1, 2, 3)  # the plane of the fit demo
# (size, wrt_uniforms, frozen slots, scene): every combination on the
# reference scene; the flagship (its plane frozen in one) at 128x96 and 120x90
# under an orbit camera that sees the box's and the torus's sides.
CASES = [c + ("reference",) for c in itertools.product([(128, 96), (120, 90)], [False, True], [(), FROZEN])] + [
    ((128, 96), False, (), "flagship"),
    ((120, 90), True, FROZEN, "flagship"),
]
SCENES = {"reference": (s.reference_scene, s.Camera.reference),
          "flagship": (s.flagship_scene, lambda: s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0))}


def _id(case):
    (w, h), wrt_uniforms, frozen, scene = case
    head = "" if scene == "reference" else f"{scene}-"
    return f"{head}{w}x{h}-{'uni' if wrt_uniforms else 'scene'}-{'frozen' if frozen else 'all'}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_plain_fit_step_matches_jax_kernel(case):
    (W, H), wrt_uniforms, frozen, scene_name = case
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    scene_fn, cam_fn = SCENES[scene_name]
    jscene, jcam, jlight, jmat = scene_fn(), cam_fn(), s.reference_light(), s.reference_material()
    rgb, t, _, _ = (np.asarray(x) for x in jax_render_kernel_forward(jscene, jcam, jlight, jmat, jcfg, PC, planar=True))

    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    # Target: the render plus seeded noise, none where a grazing ray makes
    # the gradient ill-conditioned (utils/parity.py::conditioned).
    keep = conditioned(scene, prm, uni, torch.from_numpy(t.copy()), cfg).numpy()
    noise = np.random.default_rng(2).uniform(-0.1, 0.1, (3, H, W)).astype(np.float32)
    target = (rgb + noise * keep).astype(np.float32)

    jleaves, treedef = jax.tree_util.tree_flatten(jscene)
    juni = jax_pack_uniforms(jcam, jlight, jmat, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    j_loss, j_gp, j_gu = jax_fit_step_kernel(
        treedef, tuple(jnp.shape(l) for l in jleaves), jax_scene_param_vector(jscene), juni, jnp.asarray(target),
        jcfg, PC, wrt_uniforms=wrt_uniforms, frozen_slots=frozen)
    p_target = torch.from_numpy(target)
    loss, g_prm, g_uni = fit_step_kernel_plain(scene, prm, uni, p_target, cfg,
                                               wrt_uniforms=wrt_uniforms, frozen_slots=frozen)

    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    p_rgb, p_t, p_sh, p_ao = render_kernel_forward_plain(scene, prm, uni, cfg)
    mass = gradient_mass(scene, prm, uni, 2.0 * (p_rgb - p_target), p_t, p_sh, p_ao, cfg)
    got, want = torch.cat([g_prm, g_uni]), np.concatenate([np.asarray(j_gp), np.asarray(j_gu)])
    # The loosened bar of the fused step (ROADMAP Queue 3): each primal is
    # marched anew, so a ray that ends a step apart moves its pixel's term.
    # On the flagship a hit point 1e-5 apart turns a normal by 1e-5 times the
    # curvature (33 on the box's rounded corners, 17 on the torus): up to
    # 4.6e-4 of the mass, held at 1e-3, the top of the own-march range
    # (ROADMAP Queue 3).
    check_grads(got, want, mass, rtol=1e-4, mass_tol=1e-4 if scene_name == "reference" else 1e-3, max_tol=1e-3)
    assert all(float(g_prm[k]) == 0.0 for k in frozen)
    if not wrt_uniforms:
        assert float(g_uni.abs().max()) == 0.0
    # The wrapper on CPU tensors is the same plain version.
    again = fit_step_kernel(scene, prm, uni, p_target, cfg,
                            wrt_uniforms=wrt_uniforms, frozen_slots=frozen)
    for a, b in zip(again, (loss, g_prm, g_uni)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# The scenes of ROADMAP item 13b at 96x72: the transform sampler under the
# orbit camera (under the reference camera the rounded cylinder's edge, seen
# from below at grazing, moves one slot by 4e-3 of the largest gradient:
# PERF.md), the capsule chain under its gallery camera; csg_showcase for
# its non-finite gradients (its bare box and cylinder).
SCENES_13B = {"transform_sampler": (transform_sampler, lambda: s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)),
              "capsule_chain": (s.capsule_chain, lambda: s.Camera.orbit(0, 25, 2.2)),
              "csg_showcase": (s.csg_showcase, lambda: s.Camera.orbit(25, 25, 2.4))}


@pytest.mark.parametrize("name", sorted(SCENES_13B))
def test_plain_fit_step_matches_jax_kernel_13b_scenes(name):
    """The plain K3 against JAX's interpret-mode fit step at the flagship's
    own-march bar (``FLAGSHIP_OWN``, 1e-3 of the mass and of the largest
    gradient), each side marching its own primal.  The residual is held on
    the pixels where the gradient is well conditioned and the two primals
    agree (``primals_agree``; elsewhere each side's own render, as the
    smoke's ``k3_vs_plain`` does).  ``csg_showcase`` gives non-finite
    gradients in the same slots in both (ROADMAP Queue 3)."""
    W, H = 96, 72
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    scene_fn, cam_fn = SCENES_13B[name]
    jscene, jcam, jlight, jmat = scene_fn(), cam_fn(), s.reference_light(), s.reference_material()
    want = [np.asarray(x) for x in jax_render_kernel_forward(jscene, jcam, jlight, jmat, jcfg, PC, planar=True)]
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    j_planes = [torch.from_numpy(x.copy()) for x in want]
    keep = conditioned(scene, prm, uni, j_planes[1], cfg) & primals_agree(own, j_planes, cfg.march.max_distance)
    noise = torch.from_numpy(np.random.default_rng(2).uniform(-0.1, 0.1, (3, H, W)).astype(np.float32))
    target = torch.where(keep, j_planes[0] + noise, j_planes[0]).contiguous()
    p_target = torch.where(keep, j_planes[0] + noise, own[0]).contiguous()

    jleaves, treedef = jax.tree_util.tree_flatten(jscene)
    juni = jax_pack_uniforms(jcam, jlight, jmat, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    j_loss, j_gp, j_gu = jax_fit_step_kernel(
        treedef, tuple(jnp.shape(l) for l in jleaves), jax_scene_param_vector(jscene), juni,
        jnp.asarray(target.numpy()), jcfg, PC, wrt_uniforms=False, frozen_slots=())
    loss, g_prm, g_uni = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, wrt_uniforms=False)
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    j_gp = np.asarray(j_gp)
    np.testing.assert_array_equal(np.isfinite(g_prm.numpy()), np.isfinite(j_gp))
    if name == "csg_showcase":
        assert not np.isfinite(j_gp).any()  # every slot, as in JAX's kernel
        return
    assert np.isfinite(j_gp).all()
    mass = gradient_mass(scene, prm, uni, 2.0 * (own[0] - p_target), *own[1:], cfg)
    check_grads(torch.cat([g_prm, g_uni]), np.concatenate([j_gp, np.asarray(j_gu)]), mass, rtol=1e-4,
                mass_tol=FLAGSHIP_OWN, max_tol=FLAGSHIP_OWN)


def test_transform_sampler_own_march_excess_is_grazing():
    """Under the reference camera the transform sampler's own-march
    comparison reads more than ``FLAGSHIP_OWN`` of the mass only on grazing
    hits: the plain K3 against JAX's interpret-mode fit step at 96x72, each
    marching its own primal, holds ``FLAGSHIP_OWN`` once the hits with
    |∇f·d| under 1.5 times ``conditioned``'s floor are left out too (one
    pixel of the ellipsoid's silhouette carries almost all of the excess,
    on the z slot of the ellipsoid's rotation).  Under orbit 30/15 the 13b
    case above holds it at ``FLAGSHIP_OWN`` on every pixel ``conditioned``
    keeps."""
    W, H = 96, 72
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    jscene, jcam, jlight, jmat = transform_sampler(), s.Camera.reference(), s.reference_light(), s.reference_material()
    want = [np.asarray(x) for x in jax_render_kernel_forward(jscene, jcam, jlight, jmat, jcfg, PC, planar=True)]
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    j_planes = [torch.from_numpy(x.copy()) for x in want]
    agree = primals_agree(own, j_planes, cfg.march.max_distance)
    noise = torch.from_numpy(np.random.default_rng(2).uniform(-0.1, 0.1, (3, H, W)).astype(np.float32))
    jleaves, treedef = jax.tree_util.tree_flatten(jscene)
    juni = jax_pack_uniforms(jcam, jlight, jmat, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    keep = conditioned(scene, prm, uni, j_planes[1], cfg, floor=1.5 * COND_FLOOR) & agree
    target = torch.where(keep, j_planes[0] + noise, j_planes[0]).contiguous()
    p_target = torch.where(keep, j_planes[0] + noise, own[0]).contiguous()
    _, j_gp, _ = jax_fit_step_kernel(
        treedef, tuple(jnp.shape(l) for l in jleaves), jax_scene_param_vector(jscene), juni,
        jnp.asarray(target.numpy()), jcfg, PC, wrt_uniforms=False, frozen_slots=())
    _, g_prm, _ = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, wrt_uniforms=False)
    mass = gradient_mass(scene, prm, uni, 2.0 * (own[0] - p_target), *own[1:], cfg)[:prm.numel()]
    check_grads(g_prm, np.asarray(j_gp), mass, rtol=1e-4, mass_tol=FLAGSHIP_OWN)


def test_render_kernel_diff_gradients_match_fused_step():
    """``torch.autograd.grad`` of a sum of squares through the
    differentiable kernel render reaches the scene's parameters and the
    camera position, and equals the fused step's gradients."""
    W, H = 64, 48
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    light, mat = tt.reference_light(), tt.reference_material()
    target = tt.render(tt.reference_scene(), tt.Camera.reference(), light, mat, cfg)
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    cam = tt.Camera.reference()
    cam.position.requires_grad_(True)

    img = render_kernel_diff(cfg, KernelConfig(), scene, cam, light, mat)
    assert img.shape == (H, W, 3)
    loss = torch.sum((img - target) ** 2)
    params = list(leaves(scene))
    grads = torch.autograd.grad(loss, params + [cam.position])

    f_loss, (g_scene, g_cam, _, _) = l2_loss_and_grads(cfg, KernelConfig(), scene, cam, light, mat, target)
    assert float(loss.detach()) == pytest.approx(float(f_loss), rel=1e-6)
    assert float(grads[-1].abs().max()) > 0 and all(float(g.abs().max()) > 0 for g in grads[2:4])
    for g_ad, g_fused in zip(grads, g_scene + [g_cam.position]):
        torch.testing.assert_close(g_ad, g_fused, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("camera_grad", [True, False], ids=["camera", "scene"])
def test_render_kernel_diff_asks_for_uniforms_only_when_needed(camera_grad, monkeypatch):
    """The backward takes the uniforms' gradient only when autograd needs
    it: with a camera position that requires grad, ``wrt_uniforms=True`` and
    a non-zero gradient for it; without, ``wrt_uniforms=False`` and the
    scene's gradients unchanged."""
    from sdf3d_tpu_torch.ops import render_autograd

    calls = []
    backward = render_autograd.render_kernel_backward

    def recording(*args, wrt_uniforms=True, **kwargs):
        calls.append(wrt_uniforms)
        return backward(*args, wrt_uniforms=wrt_uniforms, **kwargs)

    monkeypatch.setattr(render_autograd, "render_kernel_backward", recording)
    W, H = 48, 32
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    light, mat = tt.reference_light(), tt.reference_material()
    target = tt.render(tt.reference_scene(), tt.Camera.reference(), light, mat, cfg)
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    cam = tt.Camera.reference()
    cam.position.requires_grad_(camera_grad)
    params = list(leaves(scene))
    loss = torch.sum((render_kernel_diff(cfg, KernelConfig(), scene, cam, light, mat) - target) ** 2)
    grads = torch.autograd.grad(loss, params + ([cam.position] if camera_grad else []))
    assert calls == [camera_grad]
    _, (g_scene, g_cam, _, _) = l2_loss_and_grads(cfg, KernelConfig(), scene, cam, light, mat, target)
    for g_ad, g_fused in zip(grads, g_scene + [g_cam.position]):
        torch.testing.assert_close(g_ad, g_fused, rtol=1e-4, atol=1e-4)
    assert all(float(g.abs().max()) > 0 for g in grads[2:])
