"""The fit kernel's view axis (K3 over V views in one launch) on the CPU: the
plain multi-view step and ``multiview_loss_and_grads`` against the JAX
package's interpret-mode counterpart, the g++ host form of the CUDA source's
view axis against single-view host calls, ``fit_scene_multiview`` against
JAX's over a few Adam steps, and its errors.

Tolerances, each beside the error measured here: losses 1e-5 relative;
gradients by ``utils/parity.py::check_grads`` in the own-march form of
``test_torch_fit_kernel.py`` (each side marches its own primal; the residual
held on the pixels where the gradient is well conditioned and the two
primals agree): ``rtol`` 1e-4 of each component plus 1e-4 of its gradient
mass (the scene's and the summed light's and material's over the views,
each camera's over its view); the host form's per-view totals equal
single-view host calls bit for bit.  The Adam fit: the losses to 1e-4, the
parameters within 15% of their move.  About 60 s on one worker."""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu.fit import fit_scene_multiview as jax_fit_scene_multiview
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import multiview_loss_and_grads as jax_multiview_loss_and_grads
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene_multiview
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.fit_kernel import (
    _split_grads,
    _uniforms,
    fit_columns,
    fit_step_kernel,
    fit_step_views_plain,
    multiview_loss_and_grads,
    sum_views,
)
from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
from sdf3d_tpu_torch.utils.parity import check_grads, conditioned, gradient_mass, primals_agree
from test_torch_fit_losses import _HOST, BRANCHES, SIL_W, _host_library, _host_setup, _ptr

torch.set_num_threads(1)

PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True, ray_sdf=False)
# JAX's TestMultiviewFit: the true scene, the fit's start (its plane frozen)
# and the views (the reference camera, then orbits 40° apart).
TRUE_SCENE = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2))
PLANE_FROZEN = (False, False, True, True)


def _start():
    return s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.04, 0.44, -0.03), radius=0.26))


def _cams(n):
    return [s.Camera.reference()] + [s.Camera.orbit(azimuth_deg=40.0 * (k + 1), elevation_deg=10.0)
                                     for k in range(n - 1)]


def _flat(obj):
    """The fields of a port gradient object, flattened in field order."""
    return torch.cat([getattr(obj, f.name).reshape(-1) for f in dataclasses.fields(obj)])


def _jflat(tree):
    return np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("wrt_uniforms", [False, True], ids=["scene", "uniforms"])
def test_plain_multiview_matches_jax(wrt_uniforms):
    """The port's ``multiview_loss_and_grads`` (the plain multi-view step on
    the CPU) against JAX's in interpret mode, three views at 96×72, each
    side marching its own primal; the target is JAX's render plus seeded
    noise where the gradient is well conditioned and the primals agree, each
    side's own render elsewhere."""
    W, H, V = 96, 72, 3
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    jscene, jcams, jlight, jmat = _start(), _cams(V), s.reference_light(), s.reference_material()
    scene, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jlight, jmat, jcfg))
    cams = [convert.from_jax(c) for c in jcams]
    prm = scene_param_vector(scene)
    rng = np.random.default_rng(15)
    targets, p_targets, owns = [], [], []
    for jcam, cam in zip(jcams, cams):
        want = [torch.from_numpy(np.asarray(x).copy())
                for x in jax_render_kernel_forward(jscene, jcam, jlight, jmat, jcfg, PC, planar=True)]
        uni = _uniforms(cam, light, mat, cfg, None)
        own = render_kernel_forward_plain(scene, prm, uni, cfg)
        keep = conditioned(scene, prm, uni, want[1], cfg) & primals_agree(own, want, cfg.march.max_distance)
        noise = torch.from_numpy(rng.uniform(-0.1, 0.1, (3, H, W)).astype(np.float32))
        targets.append(torch.where(keep, want[0] + noise, want[0]).permute(1, 2, 0).contiguous())
        p_targets.append(torch.where(keep, want[0] + noise, own[0]).permute(1, 2, 0).contiguous())
        owns.append((uni, own))

    j_loss, (j_scene, j_cams, j_light, j_mat) = jax_multiview_loss_and_grads(
        jcfg, PC, jscene, jcams, jlight, jmat, [jnp.asarray(t.numpy()) for t in targets], wrt_uniforms=wrt_uniforms)
    loss, (g_scene, g_cams, g_light, g_mat) = multiview_loss_and_grads(
        cfg, KernelConfig(), scene, cams, light, mat, p_targets, wrt_uniforms=wrt_uniforms)

    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    masses = [gradient_mass(scene, prm, uni, 2.0 * (own[0] - t.permute(2, 0, 1)), *own[1:], cfg)
              for t, (uni, own) in zip(p_targets, owns)]
    P = prm.numel()
    st = check_grads(torch.cat([g.reshape(-1) for g in g_scene]), _jflat(j_scene), sum(m[:P] for m in masses),
                     rtol=1e-4, mass_tol=1e-4, label="scene")
    print(f"\nscene gradient: {st}")
    if not wrt_uniforms:
        assert g_cams is None and g_light is None and g_mat is None
        return
    # Each mass pulled back through the uniforms' packing as the gradients are.
    pulled = [_split_grads(scene, cam, light, mat, cfg, None, m[:P], m[P:], True)[1:] for cam, m in zip(cams, masses)]
    for v in range(V):
        st = check_grads(_flat(g_cams[v]), _jflat(j_cams[v]), _flat(pulled[v][0]).abs(), rtol=1e-4, mass_tol=1e-4,
                         label=f"camera {v}")
        print(f"camera {v}: {st}")
    for k, (got, want) in enumerate(((g_light, j_light), (g_mat, j_mat)), start=1):
        mass = sum(_flat(p[k]).abs() for p in pulled)
        st = check_grads(_flat(got), _jflat(want), mass, rtol=1e-4, mass_tol=1e-4, label=("light", "material")[k - 1])
        print(f"{('light', 'material')[k - 1]}: {st}")


def test_wrapper_sums_the_views_in_order():
    """On CPU tensors ``fit_step_kernel`` given (V, 30) uniforms runs the
    plain multi-view step: each view's values are the single-view step's,
    the loss and scene gradient their float64 sums in view order."""
    H, W = 32, 48
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    scene = convert.from_jax(_start())
    prm = scene_param_vector(scene)
    light, mat = tt.reference_light(), tt.reference_material()
    uni = torch.stack([_uniforms(convert.from_jax(c), light, mat, cfg, None) for c in _cams(2)])
    target = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, H, W)).astype(np.float32))
    loss_v, g_prm_v, g_uni_v = fit_step_views_plain(scene, prm, uni, target, cfg, wrt_uniforms=True)
    for v in range(2):
        one = fit_step_kernel(scene, prm, uni[v], target[v], cfg, wrt_uniforms=True)
        for a, b in zip(one, (loss_v[v], g_prm_v[v], g_uni_v[v])):
            assert torch.equal(a, b.to(torch.float32))
    loss, g_prm, g_uni = fit_step_kernel(scene, prm, uni, target, cfg, wrt_uniforms=True, sum_dtype=torch.float64)
    assert torch.equal(loss, loss_v[0] + loss_v[1]) and torch.equal(g_prm, g_prm_v[0] + g_prm_v[1])
    assert torch.equal(g_uni, g_uni_v) and g_uni.shape == (2, 30)
    assert all(torch.equal(a, b) for a, b in zip(sum_views(loss_v, g_prm_v, g_uni_v, torch.float64),
                                                 (loss, g_prm, g_uni)))


@pytest.mark.parametrize("branch", ["l2"] + sorted(BRANCHES))
def test_host_views_equal_single_view_calls(branch):
    """K3's host form (g++) with V = 3 views (the reference camera and two
    orbits; a ragged 100×42 image) gives each view the totals, and the
    partial rows, of a single-view host call on that view bit for bit; V =
    1 is that call itself.  Covers the plain L2, the 3-level pyramid, the
    silhouette and both."""
    H, W, V = 42, 100, 3
    scene, cfg, prm, uni0, target0, cov0 = _host_setup(H, W)
    kc = KernelConfig()
    levels, sil, wrt, frozen = BRANCHES.get(branch, (0, False, True, ()))
    lib = _host_library(scene, cfg, kc, branch) if branch in BRANCHES else _l2_library(scene, cfg, kc)
    cols, live = fit_columns(lib)
    light, mat = tt.reference_light(), tt.reference_material()
    uni = torch.stack([uni0] + [_uniforms(tt.Camera.orbit(azimuth_deg=a, elevation_deg=12.0), light, mat, cfg, None)
                                for a in (70.0, 200.0)]).contiguous()
    rng = np.random.default_rng(7)
    target = torch.from_numpy(rng.uniform(0, 1, (3, V, H, W)).astype(np.float32))
    target[:, 0] = target0
    cov = torch.from_numpy((rng.uniform(0, 1, (V, H, W)) > 0.5).astype(np.float32))
    cov[0] = cov0
    n_blocks = -(-W // kc.block_w) * -(-H // kc.block_h)
    beta = cfg.march.epsilon / 2.5
    extra = (SIL_W if sil else 0.0, beta)
    rows = np.zeros((V * n_blocks, live), np.float32)
    totals = np.zeros((V, cols), np.float64)
    planes = [target[c].contiguous() for c in range(3)]
    assert lib.sdf3d_fit_step_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in planes), _ptr(cov) if sil else None,
                                   *extra, _ptr(rows), _ptr(totals), H, W, V) == 0
    for v in range(V):
        rows1 = np.zeros((n_blocks, live), np.float32)
        totals1 = np.zeros(cols, np.float64)
        one = [target[c, v].contiguous() for c in range(3)]
        assert lib.sdf3d_fit_step_host(_ptr(uni[v].contiguous()), _ptr(prm), *(_ptr(c) for c in one),
                                       _ptr(cov[v].contiguous()) if sil else None, *extra, _ptr(rows1),
                                       _ptr(totals1), H, W, 1) == 0
        np.testing.assert_array_equal(rows[v * n_blocks:(v + 1) * n_blocks], rows1)
        np.testing.assert_array_equal(totals[v], totals1)
    assert np.isfinite(totals).all() and np.abs(totals[:, -1]).min() > 0.0


def _l2_library(scene, cfg, kc):
    """The host form of the plain-L2 step with the uniforms' gradient."""
    if "l2" not in _HOST:
        _HOST["l2"] = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_views_"), host=True)
    return _HOST["l2"].load(cuda_scene_source(scene, cfg, kc, True, ()))


def test_fit_matches_jax():
    """Six Adam steps at 3e-4 of both packages' ``fit_scene_multiview``
    (JAX: ``engine="pallas"``, interpret mode) on JAX's TestMultiviewFit
    scene and two of its views at 96×72, the plane frozen: the losses agree
    to 1e-4 (the bar of ``test_torch_fit.py::test_adam_fit_matches_jax_flagship``;
    measured 4.6e-5 at step 5, under 1e-6 up to step 2) and the parameters
    within 15% of their move.  The two trajectories part as the
    single-view fits on each of these views do (3.0e-5 by step 7 on the
    reference view): the loss is the sphere's silhouette against the true
    sphere's, where pixels turn on how each side's march ends (ROADMAP
    Queue 3)."""
    W, H = 96, 72
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    jcams, jlight, jmat = _cams(2), s.reference_light(), s.reference_material()
    targets = [np.asarray(s.render(TRUE_SCENE, c, jlight, jmat, jcfg)) for c in jcams]
    jstart = _start()
    steps, lr = 6, 3e-4
    tr = jax.tree_util.tree_map(lambda _: True, jstart)
    tr = tr.replace(a=jax.tree_util.tree_map(lambda _: False, jstart.a))
    want = jax_fit_scene_multiview(
        targets, jstart, jcams, jlight, jmat, jcfg,
        JaxFitConfig(steps=steps, learning_rate=lr, log_every=1, engine="pallas", pallas_interpret=True,
                     pallas_tile=(8, 128)), trainable=tr)
    got = fit_scene_multiview(targets, convert.from_jax(jstart), [convert.from_jax(c) for c in jcams],
                              convert.from_jax(jlight), convert.from_jax(jmat), convert.from_jax(jcfg),
                              FitConfig(steps=steps, learning_rate=lr, log_every=1), trainable=PLANE_FROZEN,
                              device="cpu")
    print(f"\nJAX losses {want.losses}\nport losses {got.losses}")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]
    start = np.asarray(jax_scene_param_vector(jstart))
    moved = np.asarray(jax_scene_param_vector(want.scene)) - start
    diff = scene_param_vector(got.scene).numpy() - start - moved
    assert np.all(np.abs(diff) <= 0.15 * np.abs(moved) + 1e-7), (diff, moved)
    assert np.all(moved[:4] == 0.0) and np.abs(moved[4:]).min() > 5e-4
    assert got.steps_run == steps and got.rays_per_second > 0.0


def test_validation():
    """JAX's TestMultiviewFit errors: a count mismatch, no view, a mask
    count mismatch."""
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=16, height=12)
    img = np.zeros((12, 16, 3), np.float32)
    scene, light, mat, cam = tt.reference_scene(), tt.reference_light(), tt.reference_material(), tt.Camera.reference()
    with pytest.raises(ValueError, match="targets vs"):
        fit_scene_multiview([img, img], scene, [cam], light, mat, cfg, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        fit_scene_multiview([], scene, [], light, mat, cfg, device="cpu")
    with pytest.raises(ValueError, match="coverage masks vs"):
        fit_scene_multiview([img], scene, [cam], light, mat, cfg, FitConfig(steps=1, silhouette_weight=0.5),
                            target_coverages=[np.ones((12, 16)), np.ones((12, 16))], device="cpu")


def test_silhouette_needs_mask_or_background():
    """The coverage term without masks and without a background raises, as
    JAX's; with a background the masks are inferred and the fit runs."""
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=16, height=12)
    scene, light, mat = tt.reference_scene(), tt.reference_light(), tt.reference_material()
    cams = [tt.Camera.reference(), tt.Camera.orbit(azimuth_deg=60.0)]
    imgs = [np.zeros((12, 16, 3), np.float32)] * 2
    fc = FitConfig(steps=2, silhouette_weight=0.5)
    with pytest.raises(ValueError, match="background"):
        fit_scene_multiview(imgs, scene, cams, light, mat, cfg, fc, device="cpu")
    bg_cfg = dataclasses.replace(cfg, background=(0.0, 0.0, 0.0))
    out = fit_scene_multiview(imgs, scene, cams, light, mat, bg_cfg, fc, trainable=PLANE_FROZEN, device="cpu")
    assert out.steps_run == 2 and np.isfinite(out.losses).all()


def test_deep_pyramid_takes_the_differentiable_render():
    """A pyramid deeper than the kernel's block takes each view's
    differentiable render and ``pixel_loss`` (JAX's ``render_pallas``
    route): its first loss is the sum of the views' losses."""
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=32, height=32)
    scene0 = convert.from_jax(_start())
    light, mat = tt.reference_light(), tt.reference_material()
    cams = [convert.from_jax(c) for c in _cams(2)]
    imgs = [tt.render(tt.reference_scene(), c, light, mat, cfg) for c in cams]
    fc = FitConfig(steps=1, loss="multiscale", pyramid_levels=4, log_every=1)
    out = fit_scene_multiview(imgs, scene0, cams, light, mat, cfg, fc, trainable=PLANE_FROZEN, device="cpu")
    want = sum(float(tt.pixel_loss(tt.render(scene0, c, light, mat, cfg), t, "multiscale", 4))
               for c, t in zip(cams, imgs))
    assert out.losses[0] == pytest.approx(want, rel=1e-4)
