"""The fit step's loss branches (the multiscale pyramid and the silhouette
coverage term inside K3/K4) on the CPU: the plain versions against the JAX
package's interpret-mode ``fit_step_kernel`` and the port's own
differentiable render, the g++ host forms of the CUDA source's pooling and
min-SDF tracker against the plain versions, K4 against K3, ``ray_min_sdf``,
the fused eligibility gate, and sharded fits on two CPU ranks.

Tolerances, each beside the error measured here: losses 1e-5 relative
(measured ≤ 1.1e-7 against JAX); gradients by ``utils/parity.py::check_grads``
(``rtol`` 1e-4 of each component, plus a share of the whole loss's gradient
mass, ``loss_mass``): 1e-5 of it on the same planes (the port's
differentiable render and the plain K4 summed over a plan: 0, every
component within its ``rtol``), 1e-4 where each side marches its own primal
(JAX: 6.9e-7 multiscale, 9.1e-6 silhouette, 6.3e-6 the camera's; the host
forms: 0).  No ray's argmin flips under one ulp of the camera in the
silhouette cases (``argmin_flips``: 0, recorded per test).  About 60 s on
one worker."""

import dataclasses
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.camera import camera_rays as jax_camera_rays
from sdf3d_tpu.march import ray_min_sdf as jax_ray_min_sdf
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import fit_step_kernel as jax_fit_step_kernel
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu.sdf.transforms import rotvec_to_matrix as jax_rotvec_to_matrix
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene, pixel_loss
from sdf3d_tpu_torch.march import ray_min_sdf
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.fit_kernel import (
    fit_columns,
    fit_step_kernel,
    fit_step_kernel_plain,
    fit_step_kernel_tiles_plain,
    fused_l2_eligible,
)
from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, leaves, scene_param_vector
from sdf3d_tpu_torch.parallel.mesh import Mesh
from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles
from sdf3d_tpu_torch.utils.parity import argmin_flips, check_grads, loss_mass

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True, ray_sdf=False)
KC = KernelConfig(ray_sdf=False)  # the point form, as JAX's cases (tests/test_pallas.py:419-510)
SIL_W = 0.7
BG = (0.0, 0.0, 0.0)
# JAX's cases: the multiscale pyramid at 100×70 (padded tiles, odd edges),
# the silhouette at 128×96 with a black background; the fit's start
# against a render of the reference scene.
CASES = {
    "multiscale": dict(size=(100, 70), loss_kind="multiscale", levels=3),
    "silhouette": dict(size=(128, 96), background=BG, sil_w=SIL_W),
    "camera": dict(size=(128, 96), background=BG, sil_w=SIL_W),
}


def _jax_view(case):
    cam = s.Camera.reference()
    if case == "camera":  # the pose fit's start (tests/test_pallas.py:478-482)
        cam = s.Camera(position=cam.position + 0.05 * jnp.asarray([1.0, -0.7, 1.3]),
                       c2w=jax_rotvec_to_matrix(0.05 * jnp.asarray([0.3, 0.8, -0.3])) @ cam.c2w,
                       fov_deg=cam.fov_deg)
    return cam, s.reference_light(), s.reference_material()


def _jax_scene(case):
    if case == "camera":
        return s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2))
    return s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.25))


def _setup(case):
    """The JAX side's inputs and the port's converted ones."""
    c = CASES[case]
    W, H = c["size"]
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H, background=c.get("background"))
    jscene, view = _jax_scene(case), _jax_view(case)
    target_scene = jscene if case == "camera" else s.reference_scene()
    target = np.asarray(s.render(target_scene, s.Camera.reference(), *view[1:], jcfg), np.float32)
    cov = (np.abs(target).max(-1) > 1e-3).astype(np.float32) if "sil_w" in c else None
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, *view, jcfg))
    return jcfg, jscene, view, target, cov, scene, (cam, light, mat), cfg


def _loss_kw(case):
    c = CASES[case]
    return dict(loss_kind=c.get("loss_kind", "l2"), levels=c.get("levels", 3), sil_w=c.get("sil_w", 0.0))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's interpret-mode fit step of each case (and both uniform modes of
    the multiscale one), computed once for the module."""
    out = {}
    for case, wrt in (("multiscale", False), ("multiscale", True), ("silhouette", False), ("camera", True)):
        jcfg, jscene, view, target, cov, *_ = _setup(case)
        jleaves, treedef = jax.tree_util.tree_flatten(jscene)
        juni = jax_pack_uniforms(*view, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
        kw = _loss_kw(case)
        loss, gp, gu = jax_fit_step_kernel(
            treedef, tuple(jnp.shape(l) for l in jleaves), jax_scene_param_vector(jscene), juni,
            jnp.asarray(np.transpose(target, (2, 0, 1))), jcfg, PC, wrt_uniforms=wrt,
            target_coverage=None if cov is None else jnp.asarray(cov), **kw)
        out[case, wrt] = (float(loss), np.concatenate([np.asarray(gp), np.asarray(gu)]))
    return out


def _port_step(case, wrt):
    """The port's plain step of a case, with its inputs and loss mass."""
    jcfg, jscene, view, target, cov, scene, (cam, light, mat), cfg = _setup(case)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    tgt = torch.from_numpy(np.ascontiguousarray(np.transpose(target, (2, 0, 1))))
    cov_t = None if cov is None else torch.from_numpy(cov)
    kw = _loss_kw(case)
    out = fit_step_kernel_plain(scene, prm, uni, tgt, cfg, KC, wrt, loss_kind=kw["loss_kind"], levels=kw["levels"],
                                sil_w=kw["sil_w"], target_coverage=cov_t)
    rgb, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg, KC)
    mass = loss_mass(scene, prm, uni, rgb, tgt, t, sh, ao, cfg, kw["levels"] if kw["loss_kind"] == "multiscale" else 0,
                     cov_t, kw["sil_w"], kc=KC)
    return out, mass, (scene, prm, uni, cfg)


@pytest.mark.parametrize("wrt_uniforms", [False, True], ids=["scene", "uniforms"])
def test_plain_multiscale_matches_jax(jax_steps, wrt_uniforms):
    """The plain K3's pyramid against JAX's interpret-mode kernel at 100×70
    (its tiles padded, the image's odd edges cropped)."""
    (loss, g_prm, g_uni), mass, _ = _port_step("multiscale", wrt_uniforms)
    j_loss, j_g = jax_steps["multiscale", wrt_uniforms]
    assert float(loss) == pytest.approx(j_loss, rel=1e-5)
    check_grads(torch.cat([g_prm, g_uni]), j_g, mass, rtol=1e-4, mass_tol=1e-4)


def test_plain_multiscale_matches_render_kernel_diff():
    """On the same planes: the plain K3's multiscale step against autograd of
    ``pixel_loss(render_kernel_diff(...), "multiscale")`` (forward and
    backward kernels' plain versions; the pyramid by reshape and mean)."""
    _, _, _, target, _, scene, view, cfg = _setup("multiscale")
    tgt = torch.from_numpy(target.copy())
    img = render_kernel_diff(cfg, KC, scene, *view)
    want = pixel_loss(img, tgt, "multiscale", 3)
    grads = torch.autograd.grad(want, list(leaves(scene)))
    (loss, g_prm, _), mass, _ = _port_step("multiscale", False)
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    check_grads(g_prm, torch.cat([g.reshape(-1) for g in grads]), mass[:g_prm.numel()], rtol=1e-4, mass_tol=1e-5)


@pytest.mark.parametrize("case", ["silhouette", "camera"])
def test_plain_silhouette_matches_jax(jax_steps, case, record_property):
    """The plain K3's coverage term (``sil_w = 0.7``) against JAX's: the
    scene's gradients on the fit's start, and the uniforms' (the camera's)
    on a perturbed pose (JAX's cases, tests/test_pallas.py:442-510).  Rays
    whose argmin step one ulp of the camera moves (``argmin_flips``) are
    counted and reported; none is left out."""
    wrt = case == "camera"
    (loss, g_prm, g_uni), mass, (scene, prm, uni, cfg) = _port_step(case, wrt)
    flips = int(argmin_flips(scene, prm, uni, cfg, KC).sum())
    record_property("argmin_flips", flips)
    j_loss, j_g = jax_steps[case, wrt]
    assert float(loss) == pytest.approx(j_loss, rel=1e-5)
    check_grads(torch.cat([g_prm, g_uni]), j_g, mass, rtol=1e-4, mass_tol=1e-4)
    if wrt:
        assert float(g_uni[:12].abs().max()) > 0.0  # the pose gets the silhouette's force


# ---- the host forms (g++) of the CUDA source ----

_HOST = {}
BRANCHES = {  # branch: (levels, silhouette, wrt_uniforms, frozen slots)
    "multiscale": (3, False, False, (0, 1, 2, 3)),
    "silhouette": (0, True, True, ()),
    "both": (3, True, False, ()),
}


def _host_library(scene, cfg, kc, branch):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if "libs" not in _HOST:
        _HOST["libs"] = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_losses_"), host=True)
    levels, sil, wrt, frozen = BRANCHES[branch]
    return _HOST["libs"].load(cuda_scene_source(scene, cfg, kc, wrt, frozen, "full", levels, sil))


def _ptr(x):
    return x.numpy().ctypes.data if isinstance(x, torch.Tensor) else x.ctypes.data


def _host_setup(H, W):
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H, background=BG)
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(tt.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0), tt.reference_light(),
                        tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    ref = render_kernel_forward_plain(tt.reference_scene(), scene_param_vector(tt.reference_scene()), uni, cfg)[0]
    cov = (ref.abs().amax(0) > 1e-3).to(torch.float32).contiguous()
    return scene, cfg, prm, uni, ref.contiguous(), cov


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_host_fit_step_matches_plain(branch):
    """K3's host form (the CUDA source's pooling over each block and its
    tracked march, built by g++) against the plain version on a ragged
    100×42 image (partial blocks at both edges)."""
    H, W = 42, 100
    scene, cfg, prm, uni, target, cov = _host_setup(H, W)
    kc = KernelConfig()
    levels, sil, wrt, frozen = BRANCHES[branch]
    lib = _host_library(scene, cfg, kc, branch)
    cols, live = fit_columns(lib)
    partials = np.zeros((-(-W // kc.block_w) * -(-H // kc.block_h), live), np.float32)
    totals = np.zeros(cols, np.float64)
    beta = cfg.march.epsilon / 2.5
    assert lib.sdf3d_fit_step_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in target), _ptr(cov) if sil else None,
                                   SIL_W if sil else 0.0, beta, _ptr(partials), _ptr(totals), H, W, 1) == 0
    got = torch.from_numpy(totals.astype(np.float32))
    loss, g_prm, g_uni = fit_step_kernel_plain(scene, prm, uni, target, cfg, kc, wrt, frozen,
                                               loss_kind="multiscale" if levels else "l2", levels=levels,
                                               sil_w=SIL_W if sil else 0.0, target_coverage=cov)
    assert float(got[-1]) == pytest.approx(float(loss), rel=1e-5)
    rgb, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg)
    mass = loss_mass(scene, prm, uni, rgb, target, t, sh, ao, cfg, levels, cov if sil else None, SIL_W)
    check_grads(got[:-1], torch.cat([g_prm, g_uni]), mass, rtol=1e-4, mass_tol=1e-4)
    assert all(float(got[k]) == 0.0 for k in frozen)
    assert wrt or float(got[prm.numel():-1].abs().max()) == 0.0


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_host_k4_rows_equal_k3(branch):
    """K4's host form over a balanced plan of 8×128 tiles, out of image
    order, gives K3's partial rows bit for bit for the same blocks: a
    block's pyramid groups and coverage terms are the image's."""
    H, W = 48, 256
    scene, cfg, prm, uni, target, cov = _host_setup(H, W)
    kc = KernelConfig(tile_h=8, tile_w=128)
    levels, sil, _, _ = BRANCHES[branch]
    lib = _host_library(scene, cfg, kc, branch)
    cols, live = fit_columns(lib)
    beta = cfg.march.epsilon / 2.5
    extra = (SIL_W if sil else 0.0, beta)
    rows3 = np.zeros(((W // kc.block_w) * (H // kc.block_h), live), np.float32)
    totals3 = np.zeros(cols, np.float64)
    assert lib.sdf3d_fit_step_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in target), _ptr(cov) if sil else None,
                                   *extra, _ptr(rows3), _ptr(totals3), H, W, 1) == 0
    work = np.random.default_rng(5).exponential(size=(H // kc.tile_h, W // kc.tile_w))
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1, "balanced", work)
    trow, tcol = plan.tables(0, "cpu")
    T = int(trow.shape[0])
    stack = gather_target_tiles(torch.cat([target, cov[None]]), plan)[0].contiguous()
    bx4, by4 = kc.tile_w // kc.block_w, kc.tile_h // kc.block_h
    rows4 = np.zeros((T * bx4 * by4, live), np.float32)
    totals4 = np.zeros_like(totals3)
    assert lib.sdf3d_fit_step_tiles_host(_ptr(uni), _ptr(prm), _ptr(trow), _ptr(tcol),
                                         *(_ptr(stack[k].contiguous()) for k in range(3)),
                                         _ptr(stack[3].contiguous()) if sil else None, *extra, _ptr(rows4),
                                         _ptr(totals4), T, H, W) == 0
    for z in range(T):
        for by in range(by4):
            for bx in range(bx4):
                k3 = (int(trow[z]) // kc.block_h + by) * (W // kc.block_w) + int(tcol[z]) // kc.block_w + bx
                assert np.array_equal(rows3[k3].view(np.uint32), rows4[(z * by4 + by) * bx4 + bx].view(np.uint32))
    assert np.array_equal(totals3.astype(np.float32), totals4.astype(np.float32))


@pytest.mark.parametrize("branch", ["multiscale", "silhouette"])
def test_plain_k4_over_a_plan_gives_k3_totals(branch):
    """The plain K4 summed over the work-lists of a 4-rank round-robin plan
    (8×128 tiles, dummy tiles included) gives the plain K3's loss and
    gradients."""
    H, W = 40, 256
    scene, cfg, prm, uni, target, cov = _host_setup(H, W)
    kc = KernelConfig(tile_h=8, tile_w=128)
    levels, sil, wrt, frozen = BRANCHES[branch]
    kw = dict(loss_kind="multiscale" if levels else "l2", levels=levels, sil_w=SIL_W if sil else 0.0)
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 4, "round_robin")
    stacks = gather_target_tiles(torch.cat([target, cov[None]]), plan)
    parts = []
    for r in range(4):
        trow, tcol = plan.tables(r, "cpu")
        st = stacks[r]
        parts.append(fit_step_kernel_tiles_plain(scene, prm, uni, st[:3].contiguous(), trow, tcol, cfg, kc, wrt,
                                                 frozen, coverage_tiles=st[3].contiguous(), **kw))
    loss, g_prm, g_uni = fit_step_kernel_plain(scene, prm, uni, target, cfg, kc, wrt, frozen, target_coverage=cov,
                                               **kw)
    assert sum(float(p[0]) for p in parts) == pytest.approx(float(loss), rel=1e-5)
    rgb, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg)
    mass = loss_mass(scene, prm, uni, rgb, target, t, sh, ao, cfg, levels, cov if sil else None, SIL_W)
    check_grads(sum(torch.cat(p[1:]) for p in parts), torch.cat([g_prm, g_uni]), mass, rtol=1e-4, mass_tol=1e-5)


def test_ray_min_sdf_matches_jax():
    """``march.ray_min_sdf`` per ray against JAX's at 64×48 (the reference
    scene, the reference camera): the same minimum distance and, but on rays
    whose argmin one ulp of the camera moves, the same distance at it."""
    W, H = 64, 48
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    o, d = jax_camera_rays(s.Camera.reference(), W, H, jcfg.ray_mode)
    j_min, j_t = (np.asarray(x) for x in jax_ray_min_sdf(s.reference_scene().distance, o, d, jcfg.march))
    scene, cfg = tt.reference_scene(), convert.from_jax(jcfg)
    po, pd = tt.camera_rays(tt.Camera.reference(), W, H, cfg.ray_mode)
    min_s, t_min = ray_min_sdf(scene.distance, po, pd, cfg.march)
    assert min_s.shape == t_min.shape == (H, W)
    np.testing.assert_allclose(min_s.numpy(), j_min, rtol=1e-4, atol=1e-5)
    uni = pack_uniforms(tt.Camera.reference(), tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    keep = ~argmin_flips(scene, scene_param_vector(scene), uni, cfg, KernelConfig(ray_sdf=False)).numpy()
    np.testing.assert_allclose(t_min.numpy()[keep], j_t[keep], rtol=1e-4, atol=1e-4)


def test_fused_eligibility_gate():
    """``fused_l2_eligible`` as JAX's (tests/test_pallas.py:399-417), with the
    block rule: a pyramid group must fit the block and the tile."""
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=128, height=96)
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.0, 0.4, 0.0), 0.25))
    assert fused_l2_eligible(cfg, scene)
    assert not fused_l2_eligible(dataclasses.replace(cfg, shadow=dataclasses.replace(cfg.shadow, grad="ad")), scene)
    assert fused_l2_eligible(cfg, scene, sil_w=1.0)
    relaxed = dataclasses.replace(cfg, march=dataclasses.replace(cfg.march, relaxation=1.6))
    assert not fused_l2_eligible(relaxed, scene, sil_w=1.0)
    assert fused_l2_eligible(relaxed, scene)
    assert fused_l2_eligible(cfg, scene, loss="multiscale", levels=3)
    assert not fused_l2_eligible(cfg, scene, loss="multiscale", levels=4)  # 8-row blocks, 24-row tiles
    big = KernelConfig(block_w=32, block_h=16, tile_h=32, tile_w=640)
    assert fused_l2_eligible(cfg, scene, loss="multiscale", levels=4, kc=big)
    assert not fused_l2_eligible(cfg, scene, loss="sum")
    with pytest.raises(ValueError, match="divisible by 2\\^levels"):
        fit_step_kernel(scene, scene_param_vector(scene), torch.zeros(30), torch.zeros((3, 96, 128)), cfg,
                        loss_kind="multiscale", levels=4)
    with pytest.raises(ValueError, match="needs target_coverage"):
        fit_step_kernel(scene, scene_param_vector(scene), torch.zeros(30), torch.zeros((3, 96, 128)), cfg, sil_w=1.0)
    with pytest.raises(ValueError, match="relaxation == 1.0"):
        cuda_scene_source(scene, relaxed, KernelConfig(), silhouette=True)


VIEW = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())


def test_multiscale_alignment_gate_raises():
    """JAX's gate (tests/test_fit.py:503-543): a sharded multiscale fit whose
    rank row runs do not start on 2**levels boundaries raises before any
    work; the aligned one passes the gate."""
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=64, height=48)  # slab 6 over 8 ranks
    target = torch.zeros((48, 64, 3))
    kc = KernelConfig(tile_h=8, tile_w=64)
    mesh = Mesh(size=8, rank=0, device=torch.device("cpu"))
    fc = FitConfig(steps=1, loss="multiscale", shard_layout="contiguous")
    with pytest.raises(ValueError, match="multiscale loss under row sharding"):
        fit_scene(target, tt.reference_scene(), *VIEW, cfg, fc, mesh=mesh, kernel_config=kc)
    with pytest.raises(ValueError, match="multiscale loss under row sharding"):
        fit_scene(target, tt.reference_scene(), *VIEW, cfg, dataclasses.replace(fc, shard_layout="interleaved"),
                  mesh=mesh, kernel_config=KernelConfig(tile_h=6, tile_w=64))
    with pytest.raises(ValueError, match="height 48 not divisible by mesh size 5"):
        fit_scene(target, tt.reference_scene(), *VIEW, cfg, fc, mesh=Mesh(size=5, rank=0, device=torch.device("cpu")),
                  kernel_config=kc)


def test_silhouette_fit_needs_a_mask():
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=32, height=24)
    with pytest.raises(ValueError, match="needs an object mask"):
        fit_scene(torch.zeros((24, 32, 3)), tt.reference_scene(), *VIEW, cfg, FitConfig(steps=1, silhouette_weight=1.0),
                  device="cpu")


def test_fit_scene_branches_take_the_fused_step(monkeypatch):
    """``fit_scene`` with the pyramid and the silhouette term runs the fused
    step (never the differentiable render), the silhouette fits descending;
    a pyramid deeper than the block (levels 4) takes the differentiable
    render, with the silhouette term beside it (``diff.coverage``)."""
    from sdf3d_tpu_torch import fit as fit_module

    calls = []
    diff = fit_module.render_kernel_diff
    monkeypatch.setattr(fit_module, "render_kernel_diff", lambda *a, **k: calls.append(1) or diff(*a, **k))
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=48, height=32, background=BG)
    target = tt.render(tt.reference_scene(), *VIEW, cfg)
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.26))
    for extra in (dict(loss="multiscale"), dict(silhouette_weight=0.5), dict(loss="multiscale", silhouette_weight=0.5)):
        res = fit_scene(target, scene0, *VIEW, cfg, FitConfig(steps=4, learning_rate=5e-3, log_every=1, **extra),
                        trainable=(False, False, True, True), device="cpu")
        assert calls == [] and all(np.isfinite(res.losses)), (extra, res.losses)
        assert "silhouette_weight" not in extra or res.losses[-1] < res.losses[0], (extra, res.losses)
    fit_scene(target, scene0, *VIEW, cfg, FitConfig(steps=2, log_every=1, loss="multiscale", pyramid_levels=4),
              trainable=(False, False, True, True), device="cpu")
    assert calls == [1, 1]
    res = fit_scene(target, scene0, *VIEW, cfg, FitConfig(steps=1, loss="multiscale", pyramid_levels=4,
                                                          silhouette_weight=0.5), device="cpu")
    assert calls == [1, 1, 1] and all(np.isfinite(res.losses))


# ---- sharded fits on two CPU ranks (gloo) ----

STEPS = 2
SHARDED = {  # name: FitConfig fields
    "silhouette-tiles": dict(silhouette_weight=0.5, shard_layout="tiles"),
    "silhouette-interleaved": dict(silhouette_weight=0.5, shard_layout="interleaved"),
    "silhouette-contiguous": dict(silhouette_weight=0.5, shard_layout="contiguous"),
    "multiscale-tiles": dict(loss="multiscale", shard_layout="tiles"),
    "multiscale-interleaved": dict(loss="multiscale", shard_layout="interleaved"),
    "multiscale-contiguous": dict(loss="multiscale", shard_layout="contiguous"),
}
WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops import KernelConfig
from sdf3d_tpu_torch.parallel import launch, make_mesh

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, device="cpu")
mesh = make_mesh("cpu")
spec = json.load(open(os.path.join(outdir, "spec.json")))
cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=64, height=48, background=(0.0, 0.0, 0.0))
kc = KernelConfig(tile_h=8, tile_w=64)
view = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())
target = torch.from_numpy(np.load(os.path.join(outdir, "target.npy")))
out = {}
for name, extra in spec["fits"].items():
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.04, 0.44, -0.03), 0.26))
    res = fit_scene(target, scene0, *view, cfg, FitConfig(steps=spec["steps"], learning_rate=2e-2, log_every=1,
                                                          **extra),
                    mesh=mesh, trainable=(False, False, True, True), kernel_config=kc)
    out[name] = res.losses
json.dump(out, open(os.path.join(outdir, f"out_r{rank}.json"), "w"))
launch.shutdown()
"""


def _sharded_cfg():
    return dataclasses.replace(tt.REFERENCE_CONFIG, width=64, height=48, background=BG)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' losses of every sharded fit above, run once."""
    outdir = tmp_path_factory.mktemp("ranks")
    target = tt.render(tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.0, 0.4, 0.0), 0.2)), *VIEW, _sharded_cfg())
    np.save(outdir / "target.npy", target.numpy())
    (outdir / "spec.json").write_text(json.dumps(dict(steps=STEPS, fits=SHARDED)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port), str(r), str(outdir), str(REPO)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return target, [json.loads((outdir / f"out_r{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_two_rank_fit_matches_unsharded(name, two_ranks):
    """A silhouette or multiscale fit on two gloo ranks in each layout: the
    ranks hold the same losses, the unsharded fit's (JAX's
    tests/test_fit.py:597-620; the coverage plane rides as a fourth target
    channel)."""
    target, outs = two_ranks
    assert outs[0][name] == outs[1][name] and len(outs[0][name]) == STEPS
    extra = {k: v for k, v in SHARDED[name].items() if k != "shard_layout"}
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.04, 0.44, -0.03), 0.26))
    single = fit_scene(target, scene0, *VIEW, _sharded_cfg(),
                       FitConfig(steps=STEPS, learning_rate=2e-2, log_every=1, **extra),
                       trainable=(False, False, True, True), device="cpu", kernel_config=KernelConfig(tile_h=8,
                                                                                                      tile_w=64))
    np.testing.assert_allclose(outs[0][name], single.losses, rtol=1e-5)
