"""The fits' torch engine (``FitConfig(engine="torch")``, JAX's ``"xla"``:
``diff.py``'s implicit-function render) and the silhouette term outside the
fused step, against the JAX package on the CPU.

- ``fit_scene``, ``fit_view`` and ``fit_scene_multiview`` on the torch
  engine against JAX's ``engine="xla"`` fits of the same settings
  (``tests/test_fit.py``'s: the sphere's radius under a frozen plane, the
  pose fit with the silhouette term, two views);
- the kernel engine outside the fused step (a pyramid deeper than the
  kernel's block, with the silhouette term: ``diff.coverage`` on the
  camera's rays beside the differentiable kernel render, whose backward is
  the render backward's plain version here) against JAX's
  ``engine="pallas"`` in interpret mode, whose route is the same.

Bars (the fit tests', ROADMAP Queue 3): losses 1e-4 relative, the fitted
parameters within 15% of how far they moved (measured here: losses within
1.3e-5, parameters within 0.08% of their move).  About 50 s on one
worker."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.camera import camera_rays as jax_camera_rays
from sdf3d_tpu.diff import coverage as jax_coverage
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu.fit import fit_scene as jax_fit_scene
from sdf3d_tpu.fit import fit_scene_multiview as jax_fit_scene_multiview
from sdf3d_tpu.fit import fit_view as jax_fit_view
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu.sdf.transforms import rotvec_to_matrix as jax_rotvec_to_matrix
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene, fit_scene_multiview, fit_view
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

torch.set_num_threads(1)

JCFG = dataclasses.replace(s.REFERENCE_CONFIG, width=48, height=32)
BG = (0.0, 0.0, 0.0)
PLANE_FROZEN = (False, False, True, True)


def _jmask(jscene0):
    flags = iter(PLANE_FROZEN)
    return jax.tree_util.tree_map(lambda _: next(flags), jscene0)


def _view():
    return s.Camera.reference(), s.reference_light(), s.reference_material()


def _port(*objs):
    return [convert.from_jax(o) for o in objs]


def _hold_params(got, want, start):
    """The fitted vectors within 15% of how far JAX's moved (ROADMAP Queue 3)."""
    moved = want - start
    off = got - start - moved
    assert np.all(np.abs(off) <= 0.15 * np.abs(moved) + 1e-7), (off, moved)
    assert np.abs(moved).max() > 1e-3


def _scene_fit(jcfg, fields, steps=5):
    """Both packages' fits of the sphere's radius and center (start radius
    0.26) to a render of radius 0.2, the plane frozen."""
    jcam, jlight, jmat = _view()
    target = np.asarray(s.render(s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere((0.0, 0.4, 0.0), 0.2)),
                                 jcam, jlight, jmat, jcfg))
    jscene0 = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.26))
    jfc = JaxFitConfig(steps=steps, learning_rate=2e-2, log_every=1, **fields)
    want = jax_fit_scene(target, jscene0, jcam, jlight, jmat, jcfg, jfc, trainable=_jmask(jscene0))
    fc = convert.from_jax(jfc)
    got = fit_scene(target, *_port(jscene0, jcam, jlight, jmat, jcfg), fc, trainable=PLANE_FROZEN, device="cpu")
    return fc, got, want, np.asarray(jax_scene_param_vector(jscene0))


@pytest.mark.parametrize("case", ["l2", "silhouette_multiscale"])
def test_fit_scene_torch_engine_matches_jax_xla(case):
    """Five Adam steps on the torch engine against JAX's ``"xla"`` fit."""
    jcfg, fields = JCFG, {}
    if case == "silhouette_multiscale":
        jcfg = dataclasses.replace(JCFG, background=BG)
        fields = dict(loss="multiscale", silhouette_weight=0.5)
    fc, got, want, start = _scene_fit(jcfg, fields)
    assert fc.engine == "torch" and got.steps_run == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    _hold_params(scene_param_vector(got.scene).numpy(), np.asarray(jax_scene_param_vector(want.scene)), start)


def test_silhouette_outside_the_fused_step_matches_jax_pallas():
    """The kernel engine with a 4-level pyramid (deeper than the 8-row
    block) and the silhouette term: the differentiable kernel render plus
    ``diff.coverage``, against JAX's ``engine="pallas"`` (interpret mode;
    its 8-row tile takes the same route)."""
    jcfg = dataclasses.replace(JCFG, background=BG)
    fields = dict(loss="multiscale", pyramid_levels=4, silhouette_weight=0.5, engine="pallas", pallas_interpret=True,
                  pallas_tile=(8, 128))
    fc, got, want, start = _scene_fit(jcfg, fields, steps=4)
    assert fc.engine == "kernel"
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    _hold_params(scene_param_vector(got.scene).numpy(), np.asarray(jax_scene_param_vector(want.scene)), start)


def _pose_setup():
    """``test_fit.py``'s pose fit: the reference scene, the camera moved by
    0.06, the silhouette term's mask from JAX's coverage at the true camera."""
    scene = s.reference_scene()
    cam, light, mat = _view()
    target = np.asarray(s.render(scene, cam, light, mat, JCFG))
    o, d = jax_camera_rays(cam, JCFG.width, JCFG.height, JCFG.ray_mode)
    cov = np.asarray(jax_coverage(JCFG.march, scene, o, d, None))
    pert = 0.06
    cam0 = s.Camera(position=cam.position + pert * jnp.asarray([1.0, -0.7, 1.3], jnp.float32),
                    c2w=jax_rotvec_to_matrix(pert * jnp.asarray([0.3, 0.8, -0.3], jnp.float32)) @ cam.c2w,
                    fov_deg=cam.fov_deg)
    return scene, cam0, light, mat, target, cov


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_fit_view_outside_the_fused_step_matches_jax(engine):
    """Three Adam steps of the pose fit with the silhouette term: on the
    torch engine against JAX's ``"xla"`` (``diff.render_diff``), and on the
    kernel engine with a 4-level pyramid (the differentiable kernel render,
    the render backward in its uniforms' form, plus ``diff.coverage``)
    against JAX's ``"pallas"`` in interpret mode, whose route is the same."""
    scene, cam0, light, mat, target, cov = _pose_setup()
    fields = dict(steps=3, learning_rate=2e-3, log_every=1, silhouette_weight=1.0, engine=engine)
    if engine == "pallas":
        fields.update(loss="multiscale", pyramid_levels=4, pallas_interpret=True, pallas_tile=(8, 128))
    jfc = JaxFitConfig(**fields)
    want = jax_fit_view(target, scene, cam0, light, mat, JCFG, jfc, optimize=("camera",), target_coverage=cov)
    got = fit_view(target, *_port(scene, cam0, light, mat, JCFG), convert.from_jax(jfc), optimize=("camera",),
                   target_coverage=cov, device="cpu")
    assert got.steps_run == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    start, moved = np.asarray(cam0.position), np.asarray(want.camera.position)
    _hold_params(got.camera.position.numpy(), moved, start)
    np.testing.assert_allclose(got.camera.c2w.numpy(), np.asarray(want.camera.c2w), atol=1e-4)


def test_fit_scene_multiview_torch_engine_matches_jax_xla():
    """Three Adam steps over two views (``test_fit.py``'s multi-view
    setting: orbit ±35° around the start), silhouette term on, against
    JAX's ``"xla"`` fit."""
    jcfg = dataclasses.replace(JCFG, background=BG)
    _, light, mat = _view()
    cams = [s.Camera.orbit(azimuth_deg=a, elevation_deg=10.0) for a in (-35.0, 35.0)]
    truth = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere((0.0, 0.4, 0.0), 0.2))
    targets = [np.asarray(s.render(truth, c, light, mat, jcfg)) for c in cams]
    jscene0 = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.06, 0.44, -0.04), radius=0.25))
    jfc = JaxFitConfig(steps=3, learning_rate=2e-2, log_every=1, silhouette_weight=0.5)
    want = jax_fit_scene_multiview(targets, jscene0, cams, light, mat, jcfg, jfc, trainable=_jmask(jscene0))
    got = fit_scene_multiview(targets, convert.from_jax(jscene0), _port(*cams), *_port(light, mat, jcfg),
                              convert.from_jax(jfc), trainable=PLANE_FROZEN, device="cpu")
    assert got.steps_run == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    _hold_params(scene_param_vector(got.scene).numpy(), np.asarray(jax_scene_param_vector(want.scene)),
                 np.asarray(jax_scene_param_vector(jscene0)))
