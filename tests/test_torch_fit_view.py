"""``fit_view`` (camera, field of view, light and material against an image,
the scene fixed) and ``cli fit-view`` on the CPU: trajectories against the
JAX package's ``fit_view(engine="pallas", pallas_interpret=True)``, its
validation errors, and the CLI demo.  Each step is the fused fit step with
the uniforms' gradient (the plain version here), pulled back to the view's
parameters through the uniforms' packing.

Tolerances, each beside the error measured here (three Adam steps, each
side marching its own primal): losses 2e-5 relative (measured ≤ 6.0e-6),
the fitted view's tensors 5e-5 absolute plus 1e-5 relative (measured ≤
1.9e-5 absolute on the camera, 3.6e-6 relative on the field of view).
About 30 s on one worker."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.camera import camera_rays as jax_camera_rays
from sdf3d_tpu.diff import coverage as jax_coverage
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu.fit import fit_view as jax_fit_view
from sdf3d_tpu.sdf.transforms import rotvec_to_matrix as jax_rotvec_to_matrix
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import cli, convert
from sdf3d_tpu_torch.fit import FitConfig, ViewFitResult, fit_view
from sdf3d_tpu_torch.ops.render_kernel import KernelConfig

torch.set_num_threads(1)

W, H = 48, 32
STEPS = 3
# (optimize, silhouette weight, learning rate): the pose fit of ``cli
# fit-view`` (its silhouette term's mask from JAX's coverage), and the
# light and material under the plain L2.
CASES = {
    "camera-silhouette": (("camera",), 1.0, 2e-3),
    "light-material": (("light", "material"), 0.0, 1e-2),
    "fov": (("fov",), 0.0, 5e-2),
}


def _jax_setup():
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    scene = s.reference_scene()
    light, mat = s.reference_light(), s.reference_material()
    cam_true = s.Camera.reference()
    target = np.asarray(s.render(scene, cam_true, light, mat, cfg), np.float32)
    o, d = jax_camera_rays(cam_true, W, H, cfg.ray_mode)
    cov = np.asarray(jax_coverage(cfg.march, scene, o, d, None), np.float32)
    pert = 0.06
    cam0 = s.Camera(position=cam_true.position + pert * jnp.asarray([1.0, -0.7, 1.3], jnp.float32),
                    c2w=jax_rotvec_to_matrix(pert * jnp.asarray([0.3, 0.8, -0.3], jnp.float32)) @ cam_true.c2w,
                    fov_deg=cam_true.fov_deg)
    light0 = dataclasses.replace(light, position=light.position + jnp.asarray([0.3, -0.2, 0.1]))
    return cfg, scene, cam0, light0, mat, target, cov


@pytest.fixture(scope="module")
def setup():
    jcfg, jscene, jcam0, jlight0, jmat, target, cov = _jax_setup()
    port = [convert.from_jax(o) for o in (jcfg, jscene, jcam0, jlight0, jmat)]
    return (jcfg, jscene, jcam0, jlight0, jmat, target, cov), port


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_view_trajectory_matches_jax(setup, case):
    """A few Adam steps of ``fit_view`` against JAX's on its fused kernel in
    interpret mode: the same losses and the same fitted view."""
    (jcfg, jscene, jcam0, jlight0, jmat, target, cov), (cfg, scene, cam0, light0, mat) = setup
    optimize, sil_w, lr = CASES[case]
    jfc = JaxFitConfig(steps=STEPS, learning_rate=lr, log_every=1, silhouette_weight=sil_w, engine="pallas",
                       pallas_interpret=True, pallas_tile=(8, 128))
    want = jax_fit_view(target, jscene, jcam0, jlight0, jmat, jcfg, jfc, optimize=optimize,
                        target_coverage=cov if sil_w else None)
    fc = convert.from_jax(jfc)
    assert fc == FitConfig(steps=STEPS, learning_rate=lr, log_every=1, silhouette_weight=sil_w)
    got = fit_view(target, scene, cam0, light0, mat, cfg, fc, optimize=optimize,
                   target_coverage=cov if sil_w else None, device="cpu", kernel_config=KernelConfig(ray_sdf=False))
    assert isinstance(got, ViewFitResult) and got.steps_run == STEPS
    np.testing.assert_allclose(got.losses, want.losses, rtol=2e-5)
    for g, w in ((got.camera, want.camera), (got.light, want.light), (got.mat, want.mat)):
        for f in dataclasses.fields(g):
            np.testing.assert_allclose(getattr(g, f.name).numpy(), np.asarray(getattr(w, f.name)), rtol=1e-5,
                                       atol=5e-5, err_msg=f"{type(g).__name__}.{f.name}")
    # The start is not modified.
    torch.testing.assert_close(cam0.position, convert.from_jax(jcam0).position)


VIEW_ARGS = dict(device="cpu")


@pytest.mark.parametrize("case", ["unknown", "empty", "no_mask", "not_fused"])
def test_fit_view_validation_errors(setup, case):
    """JAX's errors: an unknown or empty group, a silhouette term without a
    mask or a background; and autodiff normals outside the fused step,
    which the kernel engine's differentiable render does not take (JAX's
    ``ValueError``; the torch engine takes them)."""
    _, (cfg, scene, cam0, light0, mat) = setup
    target = torch.zeros((H, W, 3))
    args = (target, scene, cam0, light0, mat, cfg)
    if case == "unknown":
        with pytest.raises(ValueError, match="unknown optimize groups \\['pose'\\]"):
            fit_view(*args, optimize=("camera", "pose"), **VIEW_ARGS)
    elif case == "empty":
        with pytest.raises(ValueError, match="at least one parameter group"):
            fit_view(*args, optimize=(), **VIEW_ARGS)
    elif case == "no_mask":
        with pytest.raises(ValueError, match="needs an object mask"):
            fit_view(*args, FitConfig(steps=1, silhouette_weight=1.0), **VIEW_ARGS)
    else:
        with pytest.raises(ValueError, match="central/tetrahedron normals"):
            fit_view(*args[:-1], dataclasses.replace(cfg, normals="autodiff"), FitConfig(steps=1), **VIEW_ARGS)


def test_cli_fit_view_prints_position_error(tmp_path, capsys):
    metrics = tmp_path / "view.jsonl"
    assert cli.main(["fit-view", "--device", "cpu", "--width", str(W), "--height", str(H), "--steps", "4",
                     "--metrics", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "position error" in out and "final loss" in out
    lines = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 3]
    assert all(np.isfinite(ln["loss"]) for ln in lines)
