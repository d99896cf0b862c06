"""The CUDA kernels (forward render, fit step, render backward, neural render,
the tile-queue forward and fit step, the ring all-reduces, and the fit
step's benchmark variants) against their plain PyTorch versions, the bench,
and the torch engine (``diff.py``) against the kernels' differentiable
render and the neural fits' launches, on the card.

Marked ``cuda``; each test skips without a CUDA device.  On a machine with a
card and without JAX (``tests/conftest.py`` imports JAX) run:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import ctypes
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import bench
from sdf3d_tpu_torch.benchmarks.exp_ad import short_config
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.fit_kernel import (
    _fit_buffers,
    _split_totals,
    fit_launcher,
    fit_step_kernel,
    fit_step_kernel_launch,
    fit_step_kernel_plain,
    fit_step_kernel_tiles,
    fit_step_kernel_tiles_launch,
    fit_step_kernel_tiles_plain,
    fit_step_variant,
    fit_step_variant_plain,
)
from sdf3d_tpu_torch.ops.neural_kernel import (
    NeuralRenderConfig,
    render_neural_forward,
    render_neural_forward_plain,
    render_neural_launch,
)
from sdf3d_tpu_torch.ops.render_bwd_kernel import (
    render_bwd_launcher,
    render_kernel_backward,
    render_kernel_backward_launch,
    render_kernel_backward_plain,
    shade_planes,
)
from sdf3d_tpu_torch.ops.render_kernel import (
    KernelConfig,
    kernel_library,
    pack_uniforms,
    pixel_planes,
    render_kernel_forward,
    render_kernel_forward_plain,
    render_kernel_launch,
    render_kernel_tiles_forward,
    render_kernel_tiles_forward_plain,
    render_kernel_tiles_launch,
    tile_pixel_planes,
)
from sdf3d_tpu_torch.ops.scene_program import count_params, cuda_scene_source, scene_param_vector
from sdf3d_tpu_torch.parallel import make_mesh, render_sharded_kernel
from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles
from sdf3d_tpu_torch.utils.parity import (
    FLAGSHIP_OWN,
    FLAGSHIP_SAME,
    NEURAL_BAR,
    SCENE_BARS,
    check_grads,
    check_planes,
    conditioned,
    fit_targets,
    fixed_order_total,
    flagship_fit_start,
    loss_mass,
    fractal_fit_start,
    gradient_mass,
    primals_agree,
    razor_edge,
    rounding_decided,
    scenes_13b,
    shaded_slots,
    transform_sampler,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
pytestmark = pytest.mark.cuda

BASE = dataclasses.replace(tt.REFERENCE_CONFIG, width=256, height=192)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _inputs(scene, cam, cfg, dev):
    uni = pack_uniforms(cam, tt.reference_light(), tt.reference_material(), cfg.ray_mode, dev)
    uni[27] = cfg.shadow.k
    return scene_param_vector(scene, dev), uni


def _compare(scene, cam, cfg, kc, dev, razor=False, rounding=False, **bar):
    """K1 against its plain version; with ``razor``, past the hard limit only
    razor-edge rays (``utils/parity.py::razor_edge``), with ``rounding`` also
    the pixels rounding decides (``rounding_decided``); ``bar`` overrides the
    budget (``utils/parity.py::SCENE_BARS``)."""
    prm, uni = _inputs(scene, cam, cfg, dev)
    got = render_kernel_launch(scene, prm, uni, cfg, kc)
    want = render_kernel_forward_plain(scene, prm, uni, cfg, kc)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    mask = razor_edge(scene, prm, uni, cfg, kc) if razor and not rounding else None
    if rounding:
        def mask():
            return razor_edge(scene, prm, uni, cfg, kc) | rounding_decided(scene, prm, uni, cfg, kc)
    check_planes(got, want, cfg.march.max_distance, razor=mask, **bar)


@pytest.mark.parametrize("ray_sdf", [True, False], ids=["ray", "point"])
@pytest.mark.parametrize("azimuth", [0.0, 30.0])
def test_kernel_matches_plain(dev, ray_sdf, azimuth):
    cam = tt.Camera.orbit(azimuth_deg=azimuth, elevation_deg=15.0 if azimuth else 0.0)
    _compare(tt.reference_scene(), cam, BASE, KernelConfig(ray_sdf=ray_sdf), dev)


def test_kernel_matches_plain_options(dev):
    """Tetrahedron normals, AO, Lambert, a background colour, a ragged image
    (not a multiple of the block) and a three-leaf scene."""
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.0, 0.4, 0.0), 0.2),
                         tt.sdf.sphere((0.35, 0.15, 0.1), 0.15))
    cfg = dataclasses.replace(BASE, width=203, height=117, normals="tetrahedron", shading="lambert",
                              background=(0.3, 0.2, 0.1), ao=dataclasses.replace(BASE.ao, enabled=True))
    _compare(scene, tt.Camera.orbit(azimuth_deg=40.0, elevation_deg=20.0), cfg, KernelConfig(block_w=16, block_h=16), dev)


def test_parameter_change_does_not_rebuild(dev):
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
    render_kernel_forward(tt.reference_scene(), cam, light, mat, BASE, device=dev)
    loaded, launches = _build.LIBRARIES.loaded, render_kernel_forward.launches
    other = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.1, 0.35, 0.0), 0.27))
    render_kernel_forward(other, cam, light, mat, BASE, device=dev)
    assert _build.LIBRARIES.loaded == loaded
    assert render_kernel_forward.launches == launches + 1


def test_launch_rejects_bad_inputs(dev):
    scene, cam = tt.reference_scene(), tt.Camera.reference()
    prm, uni = _inputs(scene, cam, BASE, dev)
    with pytest.raises(ValueError):
        render_kernel_launch(scene, prm.double(), uni, BASE)
    with pytest.raises(ValueError):
        render_kernel_launch(scene, prm[:7], uni, BASE)
    with pytest.raises(ValueError):
        render_kernel_launch(scene, prm, uni.cpu(), BASE)


FROZEN = (0, 1, 2, 3)


def _fit_scene0(dev):
    return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25)).to(dev)


@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, FROZEN), (True, ())], ids=["scene-frozen", "uniforms"])
@pytest.mark.parametrize("size", [(256, 192), (250, 190)], ids=["256x192", "ragged"])
def test_fit_step_matches_plain(dev, wrt_uniforms, frozen, size):
    cfg = dataclasses.replace(BASE, width=size[0], height=size[1])
    scene = _fit_scene0(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    keep = conditioned(scene, prm, uni, t, cfg)
    target = (rgb + (torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1) * keep).contiguous()
    loss, g_prm, g_uni = fit_step_kernel_launch(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen)
    p_loss, p_prm, p_uni = fit_step_kernel_plain(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen)
    # The plain reverse pass on the kernel's own primal planes (K1's).
    s_prm, s_uni = render_kernel_backward_plain(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    s_prm[list(frozen)] = 0.0
    torch.cuda.synchronize()
    assert float(loss) == pytest.approx(float(p_loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    got = torch.cat([g_prm, g_uni])
    check_grads(got, torch.cat([s_prm, s_uni if wrt_uniforms else torch.zeros_like(s_uni)]), mass,
                rtol=1e-4, mass_tol=1e-5)
    # The plain version marches its own primal: a ray that ends a step apart
    # moves its pixel's term (ROADMAP Queue 3).
    check_grads(got, torch.cat([p_prm, p_uni]), mass, rtol=1e-4, mass_tol=1e-3)
    assert all(float(g_prm[k]) == 0.0 for k in frozen)
    assert wrt_uniforms or float(g_uni.abs().max()) == 0.0


# The fit step's loss branches (ROADMAP 12a), as ``fit_step_kernel``'s options.
LOSS_BRANCHES = {"multiscale": dict(loss_kind="multiscale", levels=3), "silhouette": dict(sil_w=0.5),
                 "both": dict(loss_kind="multiscale", levels=3, sil_w=0.5)}
BLACK = dataclasses.replace(BASE, background=(0.0, 0.0, 0.0))


def _branch_inputs(cfg, cam, dev, scene=None):
    """The fit demo's start (or ``scene``), its inputs, and the target: the
    reference scene's render on the card, with its object mask (off the
    black background) as the coverage target."""
    scene = _fit_scene0(dev) if scene is None else scene
    prm, uni = _inputs(scene, cam, cfg, dev)
    ref = tt.reference_scene().to(dev)
    target = render_kernel_launch(ref, scene_param_vector(ref, dev), uni, cfg)[0].contiguous()
    return scene, prm, uni, target, (target.abs().amax(0) > 1e-3).to(torch.float32).contiguous()


def _branch_plain(branch, cov, cfg, opts=None, **kw):
    """The plain step's loss options of ``branch`` (``_fit_step_plain``'s),
    or of the kernel's options ``opts``."""
    opts = LOSS_BRANCHES[branch] if opts is None else opts
    sil = opts.get("sil_w", 0.0)
    return dict(levels=opts.get("levels", 0), coverage=cov if sil else None, sil_w=sil, **kw)


#: ``examples/inverse_fit.py``'s fit: its start under the reference camera
#: at 96×64 (every 32×8 block whole, every 24×640 tile ragged), ``sil_w = 1``.
INVERSE_FIT = "inverse_fit"


@pytest.mark.parametrize("branch", sorted(LOSS_BRANCHES))
@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, FROZEN), (True, ())], ids=["scene-frozen", "uniforms"])
@pytest.mark.parametrize("size", [(256, 192), (250, 190), (96, 64, INVERSE_FIT)],
                         ids=["256x192", "ragged", "inverse_fit_96x64"])
def test_fit_loss_branches_match_plain(dev, branch, wrt_uniforms, frozen, size):
    """K3 with the pyramid (its groups pooled in each block), the coverage
    term (its tracked march) or both, against the plain step on K1's planes
    (1e-5 of the whole loss's gradient mass; 1e-4 with the coverage term,
    whose plain version tracks its own march) and against the plain
    version marching its own primal (1e-3).  The target: the reference
    scene's render where the gradient is well conditioned (whole pyramid
    groups of such pixels: ``utils/parity.py::fit_targets``), each side's
    own render elsewhere.  On the fit demo's start under orbit 30/15 at
    ``sil_w = 0.5``, and on ``inverse_fit``'s start and view at its size
    and ``sil_w = 1``."""
    from sdf3d_tpu_torch.ops.fit_kernel import _fit_step_plain

    cfg = dataclasses.replace(BLACK, width=size[0], height=size[1])
    opts = LOSS_BRANCHES[branch]
    if size[2:] == (INVERSE_FIT,):
        start = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.08, 0.45, 0.0), 0.27)).to(dev)
        scene, prm, uni, base, cov = _branch_inputs(cfg, tt.Camera.reference(), dev, start)
        opts = {**opts, "sil_w": 1.0} if "sil_w" in opts else opts
    else:
        scene, prm, uni, base, cov = _branch_inputs(cfg, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), dev)
    rgb, t, sh, ao = planes = render_kernel_launch(scene, prm, uni, cfg)
    target, p_target = fit_targets(base, planes, render_kernel_forward_plain(scene, prm, uni, cfg), scene, prm, uni,
                                   cfg, opts.get("levels", 0))
    got = fit_step_kernel_launch(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen,
                                 target_coverage=cov, **opts)
    same = _fit_step_plain(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen,
                           pixel_planes(uni, cfg.height, cfg.width),
                           **_branch_plain(branch, cov, cfg, opts, planes=(t, sh, ao)))
    own = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, KernelConfig(), wrt_uniforms, frozen,
                                target_coverage=cov, **opts)
    torch.cuda.synchronize()
    plain = _branch_plain(branch, cov, cfg, opts)
    mass = loss_mass(scene, prm, uni, rgb, target, t, sh, ao, cfg, plain["levels"], plain["coverage"], plain["sil_w"])
    assert float(got[0]) == pytest.approx(float(same[0]), rel=1e-5)
    assert float(got[0]) == pytest.approx(float(own[0]), rel=1e-5)
    g = torch.cat(got[1:])
    check_grads(g, torch.cat(same[1:]), mass, rtol=1e-4, mass_tol=1e-4 if plain["sil_w"] else 1e-5)
    check_grads(g, torch.cat(own[1:]), mass, rtol=1e-4, mass_tol=1e-3)
    assert all(float(got[1][k]) == 0.0 for k in frozen)
    assert wrt_uniforms or float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("branch", sorted(LOSS_BRANCHES))
def test_fit_loss_branches_tiles_match_k3(dev, branch):
    """K4 with each loss branch over a balanced 4-rank plan of 8×128 tiles:
    each work-list against its plain version (1e-3), and the sum over the
    plan against K3 on the whole image (loss 1e-5, gradients 1e-4 of the
    mass); targets as ``test_fit_loss_branches_match_plain``'s."""
    cfg = BLACK
    kc = KernelConfig(tile_h=8, tile_w=128)
    scene, prm, uni, base, cov = _branch_inputs(cfg, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), dev)
    opts = LOSS_BRANCHES[branch]
    plan = _plan((cfg.width, cfg.height), kc, "balanced")
    rgb, t, sh, ao = planes = render_kernel_launch(scene, prm, uni, cfg, kc)
    target, p_target = fit_targets(base, planes, render_kernel_forward_plain(scene, prm, uni, cfg, kc), scene, prm,
                                   uni, cfg, opts.get("levels", 0))
    stacks, p_stacks = (gather_target_tiles(torch.cat([x, cov[None]]), plan) for x in (target, p_target))
    plain = _branch_plain(branch, cov, cfg)
    mass = loss_mass(scene, prm, uni, rgb, target, t, sh, ao, cfg, plain["levels"], plain["coverage"], plain["sil_w"])
    total = None
    for r in range(4):
        trow, tcol = plan.tables(r, dev)
        st, p_st = stacks[r], p_stacks[r]
        got = fit_step_kernel_tiles_launch(scene, prm, uni, st[:3].contiguous(), trow, tcol, cfg, kc, True, FROZEN,
                                           coverage_tiles=st[3].contiguous(), **opts)
        want = fit_step_kernel_tiles_plain(scene, prm, uni, p_st[:3].contiguous(), trow, tcol, cfg, kc, True, FROZEN,
                                           coverage_tiles=p_st[3].contiguous(), **opts)
        torch.cuda.synchronize()
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
        check_grads(torch.cat(got[1:]), torch.cat(want[1:]), mass, rtol=1e-4, mass_tol=1e-3, label=f"rank {r}")
        total = got if total is None else tuple(a + b for a, b in zip(total, got))
    w = fit_step_kernel_launch(scene, prm, uni, target, cfg, kc, True, FROZEN, target_coverage=cov, **opts)
    assert float(total[0]) == pytest.approx(float(w[0]), rel=1e-5)
    check_grads(torch.cat(total[1:]), torch.cat(w[1:]), mass, rtol=1e-4, mass_tol=1e-4)


@pytest.mark.parametrize("wrt_uniforms", [True, False], ids=["uniforms", "params"])
@pytest.mark.parametrize("normals", ["central", "tetrahedron"])
def test_render_backward_matches_plain(dev, normals, wrt_uniforms):
    cfg = dataclasses.replace(BASE, width=250, height=190, normals=normals,
                              ao=dataclasses.replace(BASE.ao, enabled=normals == "tetrahedron"))
    scene = tt.reference_scene().to(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    _, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    g_rgb = (torch.randn((3, cfg.height, cfg.width), generator=gen, device=dev) * conditioned(scene, prm, uni, t, cfg))
    got = render_kernel_backward_launch(scene, prm, uni, g_rgb.contiguous(), t, sh, ao, cfg,
                                        wrt_uniforms=wrt_uniforms)
    want = render_kernel_backward_plain(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    torch.cuda.synchronize()
    mass = gradient_mass(scene, prm, uni, g_rgb, t, sh, ao, cfg)
    if wrt_uniforms:
        check_grads(torch.cat(got), torch.cat(want), mass, rtol=1e-4, mass_tol=1e-5)
    else:
        assert got[1] is None and want[1] is None
        check_grads(got[0], want[0], mass[:prm.numel()], rtol=1e-4, mass_tol=1e-5)


@pytest.mark.parametrize("ray_sdf", [True, False], ids=["ray", "point"])
@pytest.mark.parametrize("size", [(256, 192), (250, 190), (1920, 1080)], ids=["256x192", "ragged", "1080p"])
def test_flagship_kernel_matches_plain(dev, ray_sdf, size):
    cfg = dataclasses.replace(BASE, width=size[0], height=size[1])
    _compare(tt.flagship_scene().to(dev), tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg,
             KernelConfig(ray_sdf=ray_sdf), dev, razor=True)


@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, FROZEN), (True, ())], ids=["scene-frozen", "uniforms"])
def test_flagship_fit_step_matches_plain(dev, wrt_uniforms, frozen):
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene = flagship_fit_start(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    # Where the gradient is ill-conditioned or the two primals disagree, each
    # side's target is its own render: no residual there reaches either
    # gradient.
    keep = conditioned(scene, prm, uni, t, cfg) & primals_agree((rgb, t, sh, ao), own, cfg.march.max_distance)
    noisy = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1
    target, p_target = (torch.where(keep, noisy, x).contiguous() for x in (rgb, own[0]))
    loss, g_prm, g_uni = fit_step_kernel_launch(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen)
    p_loss, p_prm, p_uni = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, KernelConfig(), wrt_uniforms, frozen)
    s_prm, s_uni = render_kernel_backward_plain(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    s_prm[list(frozen)] = 0.0
    check_planes((rgb, t, sh, ao), own, cfg.march.max_distance, razor=razor_edge(scene, prm, uni, cfg))
    torch.cuda.synchronize()
    # The loss against K1's planes (the same primal).
    assert float(loss) == pytest.approx(float(((rgb - target).double() ** 2).sum()), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    got = torch.cat([g_prm, g_uni])
    check_grads(got, torch.cat([s_prm, s_uni if wrt_uniforms else torch.zeros_like(s_uni)]), mass,
                rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    # The plain version's own march.
    assert float(loss) == pytest.approx(float(p_loss), rel=1e-5)
    check_grads(got, torch.cat([p_prm, p_uni]), mass, rtol=1e-4, mass_tol=FLAGSHIP_OWN)
    assert all(float(g_prm[k]) == 0.0 for k in frozen)


@pytest.mark.parametrize("wrt_uniforms", [True, False], ids=["uniforms", "params"])
def test_flagship_render_backward_matches_plain(dev, wrt_uniforms):
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene = tt.flagship_scene().to(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    _, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    g_rgb = (torch.randn((3, cfg.height, cfg.width), generator=gen, device=dev)
             * conditioned(scene, prm, uni, t, cfg)).contiguous()
    got = render_kernel_backward_launch(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    want = render_kernel_backward_plain(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    torch.cuda.synchronize()
    mass = gradient_mass(scene, prm, uni, g_rgb, t, sh, ao, cfg)
    if wrt_uniforms:
        check_grads(torch.cat(got), torch.cat(want), mass, rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    else:
        check_grads(got[0], want[0], mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME)


@pytest.mark.parametrize("kernel", ["fit_step", "fit_step_uniforms", "render_bwd", "render_bwd_uniforms"])
def test_flagship_totals_finite_at_1080p(dev, kernel):
    """K3 and K5 on the flagship fit's start at 1920x1080, the target the
    flagship's render: every float64 total finite (no reverse-pass tap in a
    box's core, where the emitters' derivative is NaN)."""
    cfg = dataclasses.replace(BASE, width=1920, height=1080)
    scene = flagship_fit_start(dev)
    prm, uni = _inputs(scene, tt.Camera.reference(), cfg, dev)
    target = render_kernel_launch(tt.flagship_scene().to(dev), scene_param_vector(tt.flagship_scene(), dev), uni,
                                  cfg)[0].contiguous()
    wrt = kernel.endswith("uniforms")
    if kernel.startswith("fit_step"):
        totals = fit_launcher(scene, prm, uni, target, cfg, KernelConfig(), wrt, () if wrt else FROZEN)[0]()
    else:
        rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
        totals = render_bwd_launcher(scene, prm, uni, (2.0 * (rgb - target)).contiguous(), t, sh, ao, cfg,
                                     KernelConfig(), wrt)[0]()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(totals).all()) and float(totals.abs().max()) > 0.0


@pytest.mark.parametrize("ray_sdf", [True, False], ids=["ray", "point"])
@pytest.mark.parametrize("name", ["csg_showcase", "lattice_scene", "capsule_chain", "random_blobs",
                                  "transform_sampler"])
def test_13b_scene_kernel_matches_plain(dev, name, ray_sdf):
    """K1 on each scene of ROADMAP item 13b under its camera at 256x192."""
    scene, cam = scenes_13b(dev)[name]
    cfg = dataclasses.replace(BASE, width=256, height=192)
    _compare(scene, cam, cfg, KernelConfig(ray_sdf=ray_sdf), dev, razor=True, rounding=True,
             **SCENE_BARS.get(name, {}))


#: K1's scenes with bounded union operands (``ops/scene_program.py::_ray_union``
#: skips them where they cannot win) beside the flagship's (its own test):
#: ``(scene, camera, _compare's options)``, the 13b scenes' options for
#: ``random_blobs`` (at 1080p the reference scene has razor-edge rays too: its
#: K1 planes are the parent's bit for bit, ``chip_smoke.py --time-kernels``).
SKIP_SCENES = {
    "reference": lambda dev: (tt.reference_scene(), tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0),
                              {"razor": True}),
    "random_blobs": lambda dev: (*scenes_13b(dev)["random_blobs"], {"razor": True, "rounding": True}),
}


@pytest.mark.parametrize("size", [(1920, 1080), (250, 190)], ids=["1080p", "ragged"])
@pytest.mark.parametrize("name", sorted(SKIP_SCENES))
def test_kernel_with_union_skips_matches_plain(dev, name, size):
    """K1, whose ray form skips a union's bounded operand, against its plain
    version (which evaluates every operand) at 1080p and at a ragged 250x190."""
    scene, cam, opts = SKIP_SCENES[name](dev)
    _compare(scene, cam, dataclasses.replace(BASE, width=size[0], height=size[1]), KernelConfig(), dev, **opts)


@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, FROZEN), (True, ())], ids=["scene-frozen", "uniforms"])
def test_transform_sampler_fit_step_matches_plain(dev, wrt_uniforms, frozen):
    """K3 on the transform sampler (every 13b node) at a ragged 250x190,
    against the plain reverse pass on K1's planes (``FLAGSHIP_SAME``) and
    against its plain version on the pixels where the primals agree
    (``FLAGSHIP_OWN``)."""
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene = transform_sampler(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    keep = conditioned(scene, prm, uni, t, cfg) & primals_agree((rgb, t, sh, ao), own, cfg.march.max_distance)
    noisy = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1
    target, p_target = (torch.where(keep, noisy, x).contiguous() for x in (rgb, own[0]))
    loss, g_prm, g_uni = fit_step_kernel_launch(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen)
    p_loss, p_prm, p_uni = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, KernelConfig(), wrt_uniforms, frozen)
    s_prm, s_uni = render_kernel_backward_plain(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    s_prm[list(frozen)] = 0.0
    torch.cuda.synchronize()
    assert float(loss) == pytest.approx(float(((rgb - target).double() ** 2).sum()), rel=1e-5)
    assert float(loss) == pytest.approx(float(p_loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    got = torch.cat([g_prm, g_uni])
    check_grads(got, torch.cat([s_prm, s_uni if wrt_uniforms else torch.zeros_like(s_uni)]), mass,
                rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    check_grads(got, torch.cat([p_prm, p_uni]), mass, rtol=1e-4, mass_tol=FLAGSHIP_OWN)
    assert all(float(g_prm[k]) == 0.0 for k in frozen)


@pytest.mark.parametrize("wrt_uniforms", [True, False], ids=["uniforms", "params"])
def test_transform_sampler_render_backward_matches_plain(dev, wrt_uniforms):
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene = transform_sampler(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    _, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    g_rgb = (torch.randn((3, cfg.height, cfg.width), generator=gen, device=dev)
             * conditioned(scene, prm, uni, t, cfg)).contiguous()
    got = render_kernel_backward_launch(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    want = render_kernel_backward_plain(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    torch.cuda.synchronize()
    mass = gradient_mass(scene, prm, uni, g_rgb, t, sh, ao, cfg)
    if wrt_uniforms:
        check_grads(torch.cat(got), torch.cat(want), mass, rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    else:
        check_grads(got[0], want[0], mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME)


def test_13b_parameter_change_reuses_the_library(dev):
    """A changed rotation vector (across the series' threshold) or period
    reuses the scene's library: the selects are run-time."""
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
    cfg = dataclasses.replace(BASE, width=64, height=48)
    a = transform_sampler(dev)
    render_kernel_forward(a, cam, light, mat, cfg, device=dev)
    builds = _build.LIBRARIES.builds
    with torch.no_grad():
        for m in a.modules():
            if type(m).__name__ == "Rotate":
                m.rotvec.add_(0.2)
            if type(m).__name__ == "RepeatInfinite":
                m.period.mul_(1.3)
    render_kernel_forward(a, cam, light, mat, cfg, device=dev)
    assert _build.LIBRARIES.builds == builds


def _render_bwd_rows(dev, wrt_uniforms):
    """K5 on a ragged 250×190 image of the fit demo's start scene: its
    partial rows (blocks, columns) and float64 totals, launched twice."""
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene = _fit_scene0(dev)
    prm, uni = _inputs(scene, tt.Camera.reference(), cfg, dev)
    _, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    g_rgb = torch.randn((3, cfg.height, cfg.width), generator=gen, device=dev)
    launch, partials, totals = render_bwd_launcher(scene, prm, uni, g_rgb, t, sh, ao, cfg, KernelConfig(),
                                                   wrt_uniforms)
    first = launch().clone()
    launch()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int64), totals.view(torch.int64))
    kc = KernelConfig()
    cols = count_params(scene) + (30 if wrt_uniforms else 0)
    assert partials.shape == (-(-cfg.width // kc.block_w) * -(-cfg.height // kc.block_h), cols)
    return partials.cpu().numpy(), totals.cpu().numpy()


@pytest.mark.parametrize("wrt_uniforms", [True, False], ids=["uniforms", "params"])
def test_render_bwd_total_in_launch_is_the_fixed_order_sum(dev, wrt_uniforms):
    """K5's float64 totals are its partial rows summed in the fixed order of
    ``fixed_order_total``, bit for bit, and launches in a row agree."""
    partials, totals = _render_bwd_rows(dev, wrt_uniforms)
    assert np.array_equal(totals.view(np.uint64), fixed_order_total(partials).view(np.uint64))


def test_render_bwd_params_alone_keeps_the_rows(dev):
    """K5 without the uniforms' gradient (the P columns) gives the partial
    rows and totals of the parameters' columns with it, bit for bit: a
    pixel's dP has the same arithmetic in both instantiations."""
    rows_u, totals_u = _render_bwd_rows(dev, True)
    rows_p, totals_p = _render_bwd_rows(dev, False)
    P = rows_p.shape[1]
    assert np.abs(rows_p).max() > 0.0
    assert np.array_equal(rows_p.view(np.uint32), np.ascontiguousarray(rows_u[:, :P]).view(np.uint32))
    assert np.array_equal(totals_p.view(np.uint64), totals_u[:P].view(np.uint64))


def test_fit_parameter_change_does_not_rebuild(dev):
    scene = _fit_scene0(dev)
    prm, uni = _inputs(scene, tt.Camera.reference(), BASE, dev)
    target = torch.zeros((3, BASE.height, BASE.width), device=dev)
    fit_step_kernel_launch(scene, prm, uni, target, BASE, KernelConfig(), False, FROZEN)
    loaded, launches = _build.LIBRARIES.loaded, fit_step_kernel.launches
    fit_step_kernel_launch(scene, prm * 1.01, uni, target, BASE, KernelConfig(), False, FROZEN)
    assert _build.LIBRARIES.loaded == loaded
    assert fit_step_kernel.launches == launches + 1


@pytest.mark.parametrize("loss,counts", [("l2", (3, 0, 0)), ("multiscale", (3, 0, 0)), ("multiscale4", (0, 3, 3)),
                                         ("silhouette", (3, 0, 0))])
def test_fit_scene_launch_counters(dev, loss, counts):
    """The plain L2, the multiscale pyramid (3 levels) and the silhouette
    term run in the fit step once a step and nothing else; a pyramid the
    block cannot hold (4 levels) takes the forward and backward kernels."""
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
    cfg = BLACK if loss == "silhouette" else BASE
    target = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, device=dev)[0]
    extra = {"l2": {}, "multiscale": dict(loss="multiscale"), "multiscale4": dict(loss="multiscale", pyramid_levels=4),
             "silhouette": dict(silhouette_weight=0.5)}[loss]
    render_kernel_forward.launches = fit_step_kernel.launches = render_kernel_backward.launches = 0
    res = fit_scene(target, _fit_scene0(dev), cam, light, mat, cfg,
                    FitConfig(steps=3, log_every=1, learning_rate=5e-3, **extra),
                    trainable=(False, False, True, True), device=dev)
    assert (fit_step_kernel.launches, render_kernel_forward.launches, render_kernel_backward.launches) == counts
    assert all(np.isfinite(res.losses))
    # The same fit's plain version on the CPU.
    cpu = fit_scene(target.cpu(), _fit_scene0("cpu"), cam, light, mat, cfg,
                    FitConfig(steps=3, log_every=1, learning_rate=5e-3, **extra), trainable=(False, False, True, True),
                    device="cpu")
    np.testing.assert_allclose(res.losses, cpu.losses, rtol=1e-3)


@pytest.mark.parametrize("layout", ["tiles", "interleaved", "contiguous"])
@pytest.mark.parametrize("branch", ["multiscale", "silhouette"])
def test_fit_scene_mesh_loss_branches(dev, layout, branch):
    """A multiscale or silhouette fit at world size 1 in each layout (K4 or
    K3 once a step) gives the unsharded fit's losses."""
    cfg = dataclasses.replace(BLACK, width=256, height=192)
    kc = KernelConfig(tile_h=8, tile_w=128)
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
    target = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, device=dev)[0]
    extra = dict(loss="multiscale") if branch == "multiscale" else dict(silhouette_weight=0.5)
    fc = dict(steps=3, log_every=1, chunk_steps=2, learning_rate=5e-3, **extra)
    ref = fit_scene(target, _fit_scene0(dev), cam, light, mat, cfg, FitConfig(**fc), trainable=(False, False, True, True),
                    device=dev, kernel_config=kc)
    fit_step_kernel.launches = fit_step_kernel_tiles.launches = 0
    res = fit_scene(target, _fit_scene0(dev), cam, light, mat, cfg, FitConfig(**fc, shard_layout=layout),
                    mesh=make_mesh(dev), trainable=(False, False, True, True), kernel_config=kc)
    assert (fit_step_kernel.launches, fit_step_kernel_tiles.launches) == ((0, 3) if layout == "tiles" else (3, 0))
    for a, b in zip(res.losses, ref.losses):
        assert a == pytest.approx(b, rel=1e-5)


def test_fit_view_on_the_card(dev):
    """``fit_view`` of the camera with the silhouette term: the fit step
    with the uniforms' gradient once a step, losses near the plain
    version's on the CPU."""
    from sdf3d_tpu_torch.fit import fit_view
    from sdf3d_tpu_torch.march import ray_min_sdf
    from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix

    cfg = dataclasses.replace(BASE, width=128, height=96)
    light, mat = tt.reference_light(), tt.reference_material()
    true = tt.Camera.reference()
    target = render_kernel_forward(tt.reference_scene().to(dev), true, light, mat, cfg, device=dev)[0]
    o, d = tt.camera_rays(true, cfg.width, cfg.height, cfg.ray_mode)
    eps = cfg.march.epsilon
    cov = torch.sigmoid((2.0 * eps - ray_min_sdf(tt.reference_scene().distance, o, d, cfg.march)[0]) / (eps / 2.5))
    rot = rotvec_to_matrix(0.06 * torch.tensor([0.3, 0.8, -0.3]))
    cam0 = tt.Camera(position=true.position + 0.06 * torch.tensor([1.0, -0.7, 1.3]),
                     c2w=(rot[:, :, None] * true.c2w[None, :, :]).sum(1), fov_deg=true.fov_deg)
    fc = FitConfig(steps=5, learning_rate=2e-3, log_every=1, silhouette_weight=1.0)
    fit_step_kernel.launches = 0
    got = fit_view(target, tt.reference_scene(), cam0, light, mat, cfg, fc, target_coverage=cov, device=dev)
    assert fit_step_kernel.launches == 5 and all(np.isfinite(got.losses))
    want = fit_view(target.cpu(), tt.reference_scene(), cam0, light, mat, cfg, fc, target_coverage=cov, device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)


NEURAL = dataclasses.replace(BASE, march=dataclasses.replace(BASE.march, max_steps=64),
                             shadow=dataclasses.replace(BASE.shadow, max_steps=32))


@pytest.mark.parametrize("hidden", [64, 128, 256, 20])
@pytest.mark.parametrize("shape", ["union", "bare"])
def test_neural_kernel_matches_plain(dev, shape, hidden):
    """Hidden 64 and 128 keep the MLP's matrices in shared memory, 256
    streams them in panels, 20 pads the width to 24; the neural bar of
    utils/parity.py."""
    m = tt.sdf.neural_sdf(hidden, hidden=hidden, depth=3, radius=0.3)
    scene = (m if shape == "bare" else tt.sdf.ground_plane() | m).to(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), NEURAL, dev)
    got = render_neural_launch(scene, prm, uni, NEURAL)
    want = render_neural_forward_plain(scene, prm, uni, NEURAL)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    check_planes(got, want, NEURAL.march.max_distance, f"{shape} hidden {hidden}", **NEURAL_BAR)


@pytest.mark.parametrize("hidden,depth", [(64, 3), (256, 3), (16, 2), (24, 4)])
def test_neural_kernel_bits_do_not_depend_on_block_rays(dev, hidden, depth):
    """A pixel's bits depend only on its own sequence of points: 64 and 512
    slots a block (other tiles, other grids, other orders) give the same
    planes, bit for bit."""
    m = tt.sdf.neural_sdf(hidden + depth, hidden=hidden, depth=depth, radius=0.3)
    scene = (tt.sdf.ground_plane() | m).to(dev)
    cfg = dataclasses.replace(NEURAL, ao=dataclasses.replace(NEURAL.ao, enabled=True))
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    a = render_neural_launch(scene, prm, uni, cfg, NeuralRenderConfig(block_rays=64))
    b = render_neural_launch(scene, prm, uni, cfg, NeuralRenderConfig(block_rays=512))
    want = render_neural_forward_plain(scene, prm, uni, cfg)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    check_planes(a, want, cfg.march.max_distance, f"hidden {hidden} depth {depth}", **NEURAL_BAR)


def test_neural_weights_do_not_rebuild(dev):
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
    a = render_neural_forward(tt.sdf.ground_plane() | tt.sdf.neural_sdf(0, hidden=16), cam, light, mat, NEURAL,
                              device=dev)[0]
    loaded, launches = _build.LIBRARIES.loaded, render_neural_forward.launches
    b = render_neural_forward(tt.sdf.ground_plane() | tt.sdf.neural_sdf(1, hidden=16), cam, light, mat, NEURAL,
                              device=dev)[0]
    assert _build.LIBRARIES.loaded == loaded
    assert render_neural_forward.launches == launches + 1
    assert bool((a != b).any())


TILE_CASES = {
    "256x192": ((256, 192), KernelConfig(tile_h=8, tile_w=128)),
    "ragged": ((248, 184), KernelConfig(block_w=8, block_h=8, tile_h=8, tile_w=8)),
}


def _plan(size, kc, policy):
    W, H = size
    work = torch.rand((H // kc.tile_h, W // kc.tile_w), generator=torch.Generator().manual_seed(1)).numpy()
    return plan_tiles(H, W, kc.tile_h, kc.tile_w, 4, policy, work)


@pytest.mark.parametrize("policy", ["round_robin", "balanced"])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tiles_forward_matches_plain(dev, case, policy):
    """K2 per rank of a 4-rank plan against its plain version; the ranks'
    stacks reassembled against K1's whole image."""
    size, kc = TILE_CASES[case]
    cfg = dataclasses.replace(BASE, width=size[0], height=size[1])
    scene = tt.reference_scene().to(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    plan = _plan(size, kc, policy)
    stacks = []
    for r in range(4):
        trow, tcol = plan.tables(r, dev)
        got = render_kernel_tiles_launch(scene, prm, uni, trow, tcol, cfg, kc)
        want = render_kernel_tiles_forward_plain(scene, prm, uni, trow, tcol, cfg, kc)
        torch.cuda.synchronize()
        check_planes(got, want, cfg.march.max_distance, f"rank {r}")
        stacks.append(got)
    index = torch.from_numpy(plan.gather_index.astype("int64")).to(dev)
    images = []
    for k in range(4):
        x = torch.cat([st[k] for st in stacks], dim=-2)
        lead = tuple(x.shape[:-2])
        x = x.reshape(lead + (4 * plan.tiles_per_device, kc.tile_h, kc.tile_w))
        images.append(x[..., index, :, :].transpose(-3, -2).reshape(lead + (cfg.height, cfg.width)))
    check_planes(images, render_kernel_launch(scene, prm, uni, cfg, kc), cfg.march.max_distance, "reassembled")


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tiles_fit_step_matches_plain(dev, case):
    """K4 per work-list against the plain reverse pass on K2's planes (1e-5
    of the mass) and against its plain version (1e-3: its own march); the
    sum over the plan against K3 on the whole image (1e-4); a work-list of
    dummy tiles gives exactly 0."""
    size, kc = TILE_CASES[case]
    cfg = dataclasses.replace(BASE, width=size[0], height=size[1])
    scene = _fit_scene0(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg, kc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    keep = conditioned(scene, prm, uni, t, cfg)
    target = (rgb + (torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1) * keep).contiguous()
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    plan = _plan(size, kc, "balanced")
    stacks = gather_target_tiles(target, plan)
    total = None
    for r in range(4):
        trow, tcol = plan.tables(r, dev)
        stack = stacks[r].contiguous()
        got = fit_step_kernel_tiles_launch(scene, prm, uni, stack, trow, tcol, cfg, kc, True, FROZEN)
        want = fit_step_kernel_tiles_plain(scene, prm, uni, stack, trow, tcol, cfg, kc, True, FROZEN)
        pixels = tile_pixel_planes(trow, tcol, kc.tile_h, kc.tile_w)
        k_rgb, k_t, k_sh, k_ao = render_kernel_tiles_launch(scene, prm, uni, trow, tcol, cfg, kc)
        inside = ((pixels[0] < cfg.height) & (pixels[1] < cfg.width)).to(torch.float32)
        g_rgb = 2.0 * (k_rgb - stack) * inside
        s_prm, s_uni = render_kernel_backward_plain(scene, prm, uni, g_rgb, k_t, k_sh, k_ao, cfg, pixels)
        s_prm[list(FROZEN)] = 0.0
        torch.cuda.synchronize()
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
        g = torch.cat(got[1:])
        check_grads(g, torch.cat([s_prm, s_uni]), mass, rtol=1e-4, mass_tol=1e-5, label=f"rank {r} same planes")
        check_grads(g, torch.cat(want[1:]), mass, rtol=1e-4, mass_tol=1e-3, label=f"rank {r}")
        assert all(float(got[1][k]) == 0.0 for k in FROZEN)
        total = got if total is None else tuple(a + b for a, b in zip(total, got))
    w_loss, w_prm, w_uni = fit_step_kernel_launch(scene, prm, uni, target, cfg, kc, True, FROZEN)
    assert float(total[0]) == pytest.approx(float(w_loss), rel=1e-5)
    check_grads(torch.cat(total[1:]), torch.cat([w_prm, w_uni]), mass, rtol=1e-4, mass_tol=1e-4)
    dummy = torch.full((2,), cfg.height, dtype=torch.int32, device=dev), torch.zeros(2, dtype=torch.int32, device=dev)
    ones = torch.ones((3, 2 * kc.tile_h, kc.tile_w), device=dev)
    loss, g_prm, g_uni = fit_step_kernel_tiles_launch(scene, prm, uni, ones, *dummy, cfg, kc, True, FROZEN)
    assert float(loss) == 0.0 and not bool(g_prm.any()) and not bool(g_uni.any())


@pytest.mark.parametrize("layout,counts", [("tiles", (0, 3)), ("interleaved", (3, 0)), ("contiguous", (3, 0))])
def test_fit_scene_mesh_launch_counters(dev, layout, counts):
    """At world size 1 (no process group) the tile queue runs K4 once a step
    and K3 never, the row layouts K3 once a step; the losses are the
    unsharded fit's."""
    cfg = dataclasses.replace(BASE, width=256, height=192)
    kc = KernelConfig(tile_h=8, tile_w=128)
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
    target = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, device=dev)[0]
    fc = dict(steps=3, log_every=1, chunk_steps=2)
    ref = fit_scene(target, _fit_scene0(dev), cam, light, mat, cfg, FitConfig(**fc), trainable=(False, False, True, True),
                    device=dev, kernel_config=kc)
    fit_step_kernel.launches = fit_step_kernel_tiles.launches = 0
    res = fit_scene(target, _fit_scene0(dev), cam, light, mat, cfg, FitConfig(**fc, shard_layout=layout),
                    mesh=make_mesh(dev), trainable=(False, False, True, True), kernel_config=kc)
    assert (fit_step_kernel.launches, fit_step_kernel_tiles.launches) == counts
    for a, b in zip(res.losses, ref.losses):
        assert a == pytest.approx(b, rel=1e-5)


def test_render_sharded_tiles_launches_once(dev):
    cfg = dataclasses.replace(BASE, width=256, height=192)
    kc = KernelConfig(tile_h=8, tile_w=128)
    cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
    render_kernel_tiles_forward.launches = 0
    img = render_sharded_kernel(tt.reference_scene().to(dev), cam, light, mat, cfg, make_mesh(dev), kc,
                                layout="tiles", planar=True)
    assert render_kernel_tiles_forward.launches == 1
    ref = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, kc, planar=True, device=dev)
    check_planes((img,), (ref[0],), cfg.march.max_distance)


RING_WORKER = r"""
import glob, json, os, sys, time
import numpy as np, torch
port, rank, world, outdir, repo = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
sys.path.insert(0, repo)
from sdf3d_tpu_torch.parallel import launch, make_mesh, ring_kernel
from sdf3d_tpu_torch.parallel.collectives import _rs_ag_threshold

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)  # ranks sharing the card: gloo
mesh = make_mesh()
kernels = {"ring": ring_kernel.ring_allreduce_launch, "rs_ag": ring_kernel.rs_ag_launch}
plains = {"ring": ring_kernel.ring_allreduce_plain, "rs_ag": ring_kernel.rs_ag_plain}
out, digests = {"mismatches": []}, {}
for n in (1, 9, 130, 5000, _rs_ag_threshold(world) + 5, 70001):
    for dtype in ("float32", "float64"):
        x = torch.from_numpy(np.random.default_rng(n + rank).standard_normal(n).astype(dtype)).to(mesh.device)
        for alg in ("ring", "rs_ag"):
            got, want = kernels[alg](x, mesh), plains[alg](x, mesh)
            if not torch.equal(got, want):
                out["mismatches"].append(f"{alg} {n} {dtype}")
            digests[f"{alg} {n} {dtype}"] = got.cpu().numpy().tobytes().hex()[:4096]
x = torch.arange(70001, dtype=torch.float64, device=mesh.device) * (rank + 1)
want = ring_kernel.ring_allreduce_plain(x, mesh)
for i in range(50):  # both parity sets, rising epochs
    for alg in ("ring", "rs_ag"):
        if not torch.equal(kernels[alg](x, mesh, collective_id=7), want):
            out["mismatches"].append(f"call {i} {alg}")
# A wait that never completes: every rank sets up the buffers, rank 0 alone calls.
ring_kernel.ring_buffers(mesh, 9, "ring", torch.float32).ensure(8)
if rank == 0:
    t0 = time.perf_counter()
    try:
        ring_kernel.ring_allreduce_launch(torch.ones(8, device=mesh.device), mesh, 9, spin_s=1.0)
        out["timeout"] = None
    except RuntimeError as e:
        out["timeout"] = str(e)
    out["timeout_seconds"] = time.perf_counter() - t0
out["launches"] = [ring_kernel.ring_allreduce.launches, ring_kernel.rs_ag_allreduce.launches]
out["digests"] = digests
# The shared segments' names went at set-up; nothing is left after close_all.
ring_kernel.close_all()
out["shm_left"] = sorted(glob.glob(f"/dev/shm/sdf3d_coll_{os.getpid()}_*"))
json.dump(out, open(os.path.join(outdir, f"out_r{rank}.json"), "w"))
launch.shutdown()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_ring_kernels_match_plain(dev, world, tmp_path):
    """K7 and K8 with ``world`` processes on the card, bit for bit against
    their plain versions, the same bits on every rank, 50 calls in a row,
    and a wait that never completes raises naming rank, step and stream."""
    from sdf3d_tpu_torch.parallel import ring_kernel

    ring_kernel.collectives_library()  # built here, before the ranks start
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = [subprocess.Popen([sys.executable, "-c", RING_WORKER, str(port), str(r), str(world), str(tmp_path),
                               str(repo)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [json.loads((tmp_path / f"out_r{r}.json").read_text()) for r in range(world)]
    for o in outs:
        assert o["mismatches"] == []
        assert o["digests"] == outs[0]["digests"]
        assert o["launches"] == [12 + 50 + (o is outs[0]), 12 + 50]
    assert "rank 0 of" in outs[0]["timeout"] and "step 0, stream A" in outs[0]["timeout"]
    assert outs[0]["timeout_seconds"] < 1.0 + 1.0
    assert all(o["shm_left"] == [] for o in outs)


@pytest.mark.parametrize("kind", ["ring", "rs_ag"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [9, 4482, 70001])
def test_local_ring_pair_matches_plain(dev, kind, dtype, n):
    """Both ranks of a ring of two in one process, one host thread each
    (``LocalRing``): K7 and K8 over three calls (both parity sets) give the
    plain versions' bits (at N = 2 both add x0 + x1), and the shared
    segment is gone from /dev/shm once set up."""
    from sdf3d_tpu_torch.parallel import ring_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    xs = [torch.randn(n, generator=gen, dtype=dtype, device=dev) for _ in range(2)]
    ring = ring_kernel.LocalRing(kind, 2, n, dtype, dev)
    try:
        assert not pathlib.Path("/dev/shm", ring.sync.name.lstrip("/")).exists()
        outs = ring.run(xs, calls=3)
        torch.cuda.synchronize()
    finally:
        ring.close()
    want = xs[0] + xs[1]
    for o in outs:
        assert torch.equal(o, want)


@pytest.mark.parametrize("kind", ["ring", "rs_ag"])
def test_local_ring_missing_peer_raises(dev, kind):
    """A call whose peer never comes raises within spin_s + 1 s, naming the
    rank, the step and the stream; it launches nothing after the wait."""
    from sdf3d_tpu_torch.parallel import ring_kernel

    xs = [torch.ones(130, dtype=torch.float64, device=dev) for _ in range(2)]
    ring = ring_kernel.LocalRing(kind, 2, 130, torch.float64, dev)
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match=r"rank 0 of 2 .*wait of step 0, stream A; wait of step 0, stream B"):
            ring.run(xs, ranks=[0], spin_s=0.5)
        assert time.perf_counter() - t0 < 0.5 + 1.0
    finally:
        ring.close()


@pytest.mark.parametrize("variant", ["full", "tgt3", "wrt_p", "primal", "noscatter", "nopow", "shade_only", "empty",
                                     "empty_noin"])
@pytest.mark.parametrize("short", [True, False], ids=["one_step", "reference"])
def test_fit_variant_matches_plain(dev, variant, short):
    """K9: each benchmark variant of the fit kernel against its plain
    version (loss 1e-5 relative; gradients at the fit step's bar, its own
    march on each side; shade_only on the same fixed planes); ``full`` is K3
    bit for bit and ``noscatter``'s loss is ``full``'s."""
    cfg = short_config(BASE) if short else BASE
    scene = tt.reference_scene().to(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    keep = conditioned(scene, prm, uni, t, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    target = torch.round((rgb + (torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1) * keep) * 256) / 256
    launches = fit_step_variant.launches
    got = fit_step_variant(variant, scene, prm, uni, target.contiguous(), cfg)
    want = fit_step_variant_plain(variant, scene, prm, uni, target.contiguous(), cfg)
    torch.cuda.synchronize()
    assert fit_step_variant.launches == launches + 1
    if variant in ("empty", "empty_noin"):
        assert float(got[0]) == float(want[0])
        return
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    full = fit_step_variant("full", scene, prm, uni, target.contiguous(), cfg)
    if variant in ("full", "tgt3"):
        k3 = fit_step_kernel_launch(scene, prm, uni, target.contiguous(), cfg, KernelConfig(), True, ())
        assert all(torch.equal(a, b) for a, b in zip(got, k3))
    if variant == "noscatter":
        assert torch.equal(got[0], full[0])
    if got[1] is None:
        return
    if variant == "shade_only":
        ones = torch.ones_like(t)
        s_rgb = shade_planes(prm, uni, 2.0 * ones, ones, ones, scene, cfg, pixel_planes(uni, cfg.height, cfg.width))
        mass = gradient_mass(scene, prm, uni, 2.0 * (s_rgb - target), 2.0 * ones, ones, ones, cfg)
    else:
        p_rgb, p_t, p_sh, p_ao = render_kernel_forward_plain(scene, prm, uni, cfg)
        mass = gradient_mass(scene, prm, uni, 2.0 * (p_rgb - target), p_t, p_sh, p_ao, cfg)
    g = torch.cat([x for x in got[1:] if x is not None])
    w = torch.cat([x for x in want[1:] if x is not None])
    check_grads(g, w, mass[:g.numel()], rtol=1e-4, mass_tol=1e-5 if variant == "shade_only" else 1e-3)


@pytest.mark.parametrize("mode", ["fwd", "fwd_bwd"])
def test_run_benchmark_on_the_card(dev, mode):
    """One bench cell at 256×192 (a reduced protocol): the payload, and the
    cell's kernel launched (K1 for fwd, K3 for fwd_bwd), no other."""
    counters = {"fwd": render_kernel_forward, "fwd_bwd": fit_step_kernel}
    for c in counters.values():
        c.launches = 0
    r = bench.run_benchmark(width=256, height=192, mode=mode, iters=2, frames_per_dispatch=4)
    assert r["metric"] == f"rays_per_second_192p_{mode}_kernel" and r["backend"] == "cuda" and r["value"] > 0
    assert counters[mode].launches > 0
    assert all(c.launches == 0 for m, c in counters.items() if m != mode)


def test_fit_launcher_keeps_its_inputs(dev):
    """``fit_launcher``'s launch holds the addresses of its inputs: it keeps
    the tensors alive, so a launch after the caller dropped them (and the
    allocator handed their memory on) still reads the same inputs."""
    scene = tt.reference_scene().to(dev)
    prm, uni = _inputs(scene, tt.Camera.reference(), BASE, dev)
    target = render_kernel_launch(scene, prm, uni, BASE)[0].contiguous() * 0.5
    want = fit_step_kernel_launch(scene, prm, uni, target, BASE, KernelConfig(), True, ())
    launch, _, totals = fit_launcher(scene, prm.clone(), uni.clone(), target.clone(), BASE, KernelConfig(), True, ())
    del prm, uni, target
    junk = [torch.full((4096,), float(k), device=dev) for k in range(64)]
    assert launch() is totals
    got = _split_totals(totals, count_params(scene), torch.float32)
    torch.cuda.synchronize()
    assert junk and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, FROZEN), (True, ())], ids=["scene-frozen", "uniforms"])
def test_fit_total_in_launch_is_the_fixed_order_sum(dev, wrt_uniforms, frozen):
    """The float64 totals of a launch are its partial rows summed in the
    kernel's fixed order (``fixed_order_total``), bit for bit, and the frozen
    slots (and the uniforms' columns unless taken) read 0; launches in a row
    agree bit for bit."""
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene = _fit_scene0(dev)
    prm, uni = _inputs(scene, tt.Camera.reference(), cfg, dev)
    target = render_kernel_launch(tt.reference_scene().to(dev), scene_param_vector(tt.reference_scene(), dev), uni,
                                  cfg)[0].contiguous()
    kc = KernelConfig()
    launch, partials, totals = fit_launcher(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen)
    first = launch().clone()
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int64), totals.view(torch.int64))
    P = count_params(scene)
    cols = P + 31  # dP, dU (zeros unless taken), the loss
    keep = [k for k in range(P) if k not in frozen] + (list(range(P, cols - 1)) if wrt_uniforms else []) + [cols - 1]
    assert partials.shape == (-(-cfg.width // kc.block_w) * -(-cfg.height // kc.block_h), len(keep))
    want = np.zeros(cols, np.float64)
    want[keep] = fixed_order_total(partials.cpu().numpy())
    assert np.array_equal(totals.cpu().numpy().view(np.uint64), want.view(np.uint64))
    assert all(float(totals[k]) == 0.0 for k in frozen)


def test_fit_k3_and_k4_partial_rows_equal(dev):
    """K3 over a 1280×48 image and K4 over a balanced plan of its four
    24×640 tiles (whole 32×8 blocks, out of image order) give bit-equal
    partial rows for the same pixels, and equal totals once rounded to
    float32 (their float64 totals add the rows in another block order)."""
    cfg = dataclasses.replace(BASE, width=1280, height=48)
    scene = _fit_scene0(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=20.0, elevation_deg=10.0), cfg, dev)
    target = render_kernel_launch(tt.reference_scene().to(dev), scene_param_vector(tt.reference_scene(), dev), uni,
                                  cfg)[0].contiguous()
    kc = KernelConfig()
    launch3, rows3, totals3 = fit_launcher(scene, prm, uni, target, cfg, kc, False, FROZEN)
    launch3()
    work = np.random.default_rng(5).exponential(size=(cfg.height // kc.tile_h, cfg.width // kc.tile_w))
    plan = plan_tiles(cfg.height, cfg.width, kc.tile_h, kc.tile_w, 1, "balanced", work)
    trow, tcol = plan.tables(0, dev)
    stack = gather_target_tiles(target, plan)[0].contiguous()
    T = int(trow.shape[0])
    bx4, by4 = kc.tile_w // kc.block_w, kc.tile_h // kc.block_h
    lib = kernel_library(scene, prm, uni, cfg, kc, False, FROZEN)
    store4, rows4, totals4, stream = _fit_buffers(lib, T * bx4 * by4, dev)
    assert lib.sdf3d_fit_step_tiles(uni.data_ptr(), prm.data_ptr(), trow.data_ptr(), tcol.data_ptr(),
                                    *(stack[k].data_ptr() for k in range(3)), None, 0.0, 0.0, store4.data_ptr(),
                                    totals4.data_ptr(), T, cfg.height, cfg.width, stream) == 0
    torch.cuda.synchronize()
    gx3 = cfg.width // kc.block_w
    tr, tc = trow.cpu().tolist(), tcol.cpu().tolist()
    index3 = [(tr[z] // kc.block_h + by) * gx3 + tc[z] // kc.block_w + bx
              for z in range(T) for by in range(by4) for bx in range(bx4)]
    assert torch.equal(rows3[index3].view(torch.int32), rows4.view(torch.int32))
    assert torch.equal(totals3.float(), totals4.float())
    loss4 = fit_step_kernel_tiles_launch(scene, prm, uni, stack, trow, tcol, cfg, kc, False, FROZEN)
    loss3 = fit_step_kernel_launch(scene, prm, uni, target, cfg, kc, False, FROZEN)
    assert all(torch.equal(a, b) for a, b in zip(loss3, loss4))


# ---------------------------------------------------------------------------
# ROADMAP item 13c: the fractal (six iterations) on K1, K3 and K5, and the
# over-relaxed march (omega = 1.6) on K1-K4 (chip_smoke.py phases 37-39).
# ---------------------------------------------------------------------------

OMEGA = 1.6


def _relaxed(cfg):
    return dataclasses.replace(cfg, march=dataclasses.replace(cfg.march, relaxation=OMEGA))


@pytest.mark.parametrize("relaxation", [1.0, OMEGA], ids=["exact", "relaxed"])
@pytest.mark.parametrize("ray_sdf", [True, False], ids=["ray", "point"])
@pytest.mark.parametrize("size", [(256, 192), (250, 190)], ids=["256x192", "ragged"])
def test_fractal_kernel_matches_plain(dev, ray_sdf, size, relaxation):
    """K1 on the fractal against its plain version, exact and relaxed, past
    the hard limit only on razor-edge rays and pixels rounding decides."""
    cfg = dataclasses.replace(BASE, width=size[0], height=size[1])
    cfg = _relaxed(cfg) if relaxation != 1.0 else cfg
    _compare(tt.fractal_scene().to(dev), tt.Camera.reference(), cfg, KernelConfig(ray_sdf=ray_sdf), dev,
             rounding=True, **SCENE_BARS.get("fractal", {}))


@pytest.mark.parametrize("ray_sdf", [True, False], ids=["ray", "point"])
@pytest.mark.parametrize("azimuth", [0.0, 30.0])
def test_relaxed_kernel_matches_plain(dev, ray_sdf, azimuth):
    """K1 relaxed on the reference scene against its plain version, whose
    march (``march.relaxed_step``) the kernel's relaxed branch follows."""
    cam = tt.Camera.orbit(azimuth_deg=azimuth, elevation_deg=15.0 if azimuth else 0.0)
    _compare(tt.reference_scene(), cam, _relaxed(BASE), KernelConfig(ray_sdf=ray_sdf), dev, razor=True)


@pytest.mark.parametrize("case", ["fractal-scene-frozen", "fractal-uniforms", "reference-relaxed"])
def test_fractal_and_relaxed_fit_step_match_plain(dev, case):
    """K3 on the fractal's fit start (and relaxed on the fit demo's start)
    against the plain reverse pass on K1's planes (``FLAGSHIP_SAME``) and
    the plain version's own march (``FLAGSHIP_OWN``, on the pixels where the
    two primals agree)."""
    if case.startswith("fractal"):
        scene, cfg, cam = fractal_fit_start(dev), BASE, tt.Camera.reference()
    else:
        scene, cfg, cam = _fit_scene0(dev), _relaxed(BASE), tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    wrt_uniforms, frozen = (True, ()) if case == "fractal-uniforms" else (False, FROZEN)
    prm, uni = _inputs(scene, cam, cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    keep = conditioned(scene, prm, uni, t, cfg) & primals_agree((rgb, t, sh, ao), own, cfg.march.max_distance)
    noisy = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1
    target, p_target = (torch.where(keep, noisy, x).contiguous() for x in (rgb, own[0]))
    loss, g_prm, g_uni = fit_step_kernel_launch(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen)
    p_loss, p_prm, p_uni = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, KernelConfig(), wrt_uniforms, frozen)
    s_prm, s_uni = render_kernel_backward_plain(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    s_prm[list(frozen)] = 0.0
    torch.cuda.synchronize()
    assert float(loss) == pytest.approx(float(((rgb - target).double() ** 2).sum()), rel=1e-5)
    assert float(loss) == pytest.approx(float(p_loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    got = torch.cat([g_prm, g_uni])
    check_grads(got, torch.cat([s_prm, s_uni if wrt_uniforms else torch.zeros_like(s_uni)]), mass, rtol=1e-4,
                mass_tol=FLAGSHIP_SAME)
    check_grads(got, torch.cat([p_prm, p_uni]), mass, rtol=1e-4, mass_tol=FLAGSHIP_OWN)


@pytest.mark.parametrize("wrt_uniforms", [False, True], ids=["params", "uniforms"])
def test_fractal_render_backward_matches_plain(dev, wrt_uniforms):
    """Both K5 forms on the fractal's fit start against the plain version on
    the same planes, at the flagship's bar."""
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene = fractal_fit_start(dev)
    prm, uni = _inputs(scene, tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    _, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    g_rgb = (torch.randn((3, cfg.height, cfg.width), generator=gen, device=dev)
             * conditioned(scene, prm, uni, t, cfg)).contiguous()
    got = render_kernel_backward_launch(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    want = render_kernel_backward_plain(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    torch.cuda.synchronize()
    mass = gradient_mass(scene, prm, uni, g_rgb, t, sh, ao, cfg)
    if wrt_uniforms:
        check_grads(torch.cat(got), torch.cat(want), mass, rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    else:
        check_grads(got[0], want[0], mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME)


def test_relaxed_tiles_match_plain(dev):
    """K2 and K4 relaxed on a 4-rank plan at 256×192 against their plain tile
    versions (the loss within 1e-5), and ``fit_scene(mesh)`` in ``tiles``
    relaxed gives the unsharded relaxed fit's losses."""
    import torch.distributed as dist

    from sdf3d_tpu_torch.parallel import launch

    cfg, kc = _relaxed(BASE), KernelConfig(tile_h=8, tile_w=128)
    scene = _fit_scene0(dev)
    cam = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    prm, uni = _inputs(scene, cam, cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    keep = conditioned(scene, prm, uni, t, cfg) & primals_agree((rgb, t, sh, ao), own, cfg.march.max_distance)
    noisy = rgb + 0.05
    target, p_target = (torch.where(keep, noisy, x).contiguous() for x in (rgb, own[0]))
    plan = plan_tiles(cfg.height, cfg.width, kc.tile_h, kc.tile_w, 4)
    stacks, p_stacks = gather_target_tiles(target, plan), gather_target_tiles(p_target, plan)
    for rank in range(4):
        trow, tcol = plan.tables(rank, dev)
        got2 = render_kernel_tiles_launch(scene, prm, uni, trow, tcol, cfg, kc)
        want2 = render_kernel_tiles_forward_plain(scene, prm, uni, trow, tcol, cfg, kc)
        got4 = fit_step_kernel_tiles_launch(scene, prm, uni, stacks[rank].contiguous(), trow, tcol, cfg, kc, False,
                                            FROZEN)
        want4 = fit_step_kernel_tiles_plain(scene, prm, uni, p_stacks[rank].contiguous(), trow, tcol, cfg, kc, False,
                                            FROZEN)
        torch.cuda.synchronize()
        pixels = tile_pixel_planes(trow, tcol, kc.tile_h, kc.tile_w)
        check_planes(got2, want2, cfg.march.max_distance, razor=razor_edge(scene, prm, uni, cfg, kc, pixels))
        assert float(got4[0]) == pytest.approx(float(want4[0]), rel=1e-5)
    full = dataclasses.replace(cfg, width=640, height=48)
    target_img = render_kernel_forward(tt.reference_scene(), cam, tt.reference_light(), tt.reference_material(), full,
                                       device=dev)[0]
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"tcp://127.0.0.1:{port.getsockname()[1]}"
    port.close()
    unsharded = fit_scene(target_img, _fit_scene0(dev), cam, tt.reference_light(), tt.reference_material(), full,
                          FitConfig(steps=5, learning_rate=1e-2), trainable=(False, False, True, True), device=dev)
    launch.initialize(addr, world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        fit_step_kernel_tiles.launches = 0
        tiles = fit_scene(target_img, _fit_scene0(dev), cam, tt.reference_light(), tt.reference_material(), full,
                          FitConfig(steps=5, learning_rate=1e-2, shard_layout="tiles"), mesh=make_mesh(),
                          trainable=(False, False, True, True))
        assert fit_step_kernel_tiles.launches == 5
    finally:
        launch.shutdown()
    assert max(abs(a / b - 1.0) for a, b in zip(tiles.losses, unsharded.losses)) <= 1e-5


def test_fractal_totals_finite_at_1080p(dev):
    """K3 and both K5 forms on the fractal at 1920×1080 under the reference
    camera give finite totals: the clamp of ``rho^8`` keeps the escape
    selects' untaken branch finite where JAX's reverse pass is NaN (ROADMAP
    Queue 3)."""
    cfg = dataclasses.replace(BASE, width=1920, height=1080)
    scene = fractal_fit_start(dev)
    prm, uni = _inputs(scene, tt.Camera.reference(), cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    target = (rgb * 0.95).contiguous()
    loss, g_prm, g_uni = fit_step_kernel_launch(scene, prm, uni, target, cfg, KernelConfig(), True, ())
    assert bool(torch.isfinite(torch.cat([g_prm, g_uni])).all()) and float(loss) > 0.0
    for wrt in (False, True):
        got = render_kernel_backward_launch(scene, prm, uni, (2.0 * (rgb - target)).contiguous(), t, sh, ao, cfg,
                                            wrt_uniforms=wrt)
        assert all(bool(torch.isfinite(g).all()) for g in got if g is not None)


# ---------------------------------------------------------------------------
# K3's view axis (ROADMAP 12b) and per-object materials (ROADMAP 12c).
# ---------------------------------------------------------------------------

VIEW_CAMS = (tt.Camera.reference, lambda: tt.Camera.orbit(azimuth_deg=40.0, elevation_deg=10.0),
             lambda: tt.Camera.orbit(azimuth_deg=200.0, elevation_deg=20.0))


def _views(cfg, dev, opts):
    """The fit demo's start under three cameras: its (3, 30) uniforms, the
    reference scene's renders as the (3, 3, H, W) target (stored as (3, V, H,
    W)) and their object masks (off the black background) as the coverage."""
    scene = _fit_scene0(dev)
    ref = tt.reference_scene().to(dev)
    unis = torch.stack([_inputs(scene, cam(), cfg, dev)[1] for cam in VIEW_CAMS])
    target = torch.stack([render_kernel_launch(ref, scene_param_vector(ref, dev), u, cfg)[0] for u in unis], 1)
    cov = (target.abs().amax(0) > 1e-3).to(torch.float32).contiguous()
    loss = dict(opts)
    if loss.get("sil_w"):
        loss["coverage"] = cov
        loss["sil_beta"] = cfg.march.epsilon / 2.5
    loss["levels"] = loss.pop("levels", 0) if loss.pop("loss_kind", "l2") == "multiscale" else 0
    return scene, scene_param_vector(scene, dev), unis, target.contiguous().transpose(0, 1), cov, loss


@pytest.mark.parametrize("branch", ["l2"] + sorted(LOSS_BRANCHES))
def test_multiview_totals_equal_single_view_launches(dev, branch):
    """K3 over three views in one launch gives each view the partial rows and
    float64 totals of K3 launched on that view alone, bit for bit (250×190,
    ragged blocks), with each loss branch."""
    cfg = dataclasses.replace(BLACK, width=250, height=190)
    opts = LOSS_BRANCHES.get(branch, {})
    scene, prm, unis, target, cov, loss = _views(cfg, dev, opts)
    launch, rows, totals = fit_launcher(scene, prm, unis, target, cfg, KernelConfig(), True, (), **loss)
    launch()
    for v in range(3):
        one = dict(loss, coverage=cov[v].contiguous()) if "coverage" in loss else loss
        l1, rows1, totals1 = fit_launcher(scene, prm, unis[v].contiguous(), target[v].contiguous(), cfg,
                                          KernelConfig(), True, (), **one)
        l1()
        torch.cuda.synchronize()
        assert torch.equal(rows[v], rows1) and torch.equal(totals[v], totals1), f"view {v}"
    assert bool(torch.isfinite(totals).all())


def test_multiview_fit_step_matches_plain(dev):
    """The multi-view step (K3's view axis) against its plain version (the
    single view's in a loop), each marching its own primal, each view's
    target the reference scene's render where the gradient is well
    conditioned and the primals agree (``fit_targets``), each side's own
    render elsewhere: the loss to 1e-5, the scene gradient and each view's
    uniforms' gradient at 1e-3 of their mass; the wrapper counts one launch
    for the three views."""
    cfg = dataclasses.replace(BASE, width=256, height=192)
    scene, prm, unis, base, _, _ = _views(cfg, dev, {})
    planes = [render_kernel_launch(scene, prm, u.contiguous(), cfg) for u in unis]
    pairs = [fit_targets(base[v], planes[v], render_kernel_forward_plain(scene, prm, unis[v], cfg), scene, prm,
                         unis[v], cfg) for v in range(3)]
    target = torch.stack([t for t, _ in pairs], 1).contiguous().transpose(0, 1)
    p_target = torch.stack([p for _, p in pairs])
    fit_step_kernel.launches = 0
    loss, g_prm, g_uni = fit_step_kernel(scene, prm, unis, target, cfg, KernelConfig(), True)
    assert fit_step_kernel.launches == 1 and g_uni.shape == (3, 30)
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_views_plain, sum_views

    p_loss, p_prm, p_uni = sum_views(*fit_step_views_plain(scene, prm, unis, p_target, cfg, KernelConfig(), True))
    torch.cuda.synchronize()
    assert float(loss) == pytest.approx(float(p_loss), rel=1e-5)
    masses = []
    for v in range(3):
        rgb, t, sh, ao = planes[v]
        masses.append(gradient_mass(scene, prm, unis[v], 2.0 * (rgb - target[v]), t, sh, ao, cfg))
    P = prm.numel()
    check_grads(g_prm, p_prm, sum(m[:P] for m in masses), rtol=1e-4, mass_tol=1e-3, label="scene")
    for v in range(3):
        check_grads(g_uni[v], p_uni[v], masses[v][P:], rtol=1e-4, mass_tol=1e-3, label=f"view {v}")


def _materials(cfg, dev, cam=None):
    scene = tt.materials_scene().to(dev)
    prm, uni = _inputs(scene, cam or tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg, dev)
    return scene, prm, uni


@pytest.mark.parametrize("ray_sdf", [True, False], ids=["ray", "point"])
@pytest.mark.parametrize("size", [(256, 192), (250, 190)], ids=["256x192", "ragged"])
def test_materials_kernel_matches_plain(dev, ray_sdf, size):
    """K1 on ``materials_scene`` (the material program at each hit) against
    its plain version at the flagship's image bar."""
    cfg = dataclasses.replace(BASE, width=size[0], height=size[1])
    _compare(tt.materials_scene().to(dev), tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), cfg,
             KernelConfig(ray_sdf=ray_sdf), dev, razor=True)


@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, FROZEN), (True, ())], ids=["scene-frozen", "uniforms"])
def test_materials_fit_step_matches_plain(dev, wrt_uniforms, frozen):
    """K3 on ``materials_scene`` against the plain reverse pass on K1's planes
    (``FLAGSHIP_SAME``) and the plain step marching its own primal
    (``FLAGSHIP_OWN``); the Shaded slots' gradients are not zero."""
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene, prm, uni = _materials(cfg, dev)
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    keep = conditioned(scene, prm, uni, t, cfg) & primals_agree((rgb, t, sh, ao), own, cfg.march.max_distance)
    noisy = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1
    target, p_target = (torch.where(keep, noisy, x).contiguous() for x in (rgb, own[0]))
    loss, g_prm, g_uni = fit_step_kernel_launch(scene, prm, uni, target, cfg, KernelConfig(), wrt_uniforms, frozen)
    p_loss, p_prm, p_uni = fit_step_kernel_plain(scene, prm, uni, p_target, cfg, KernelConfig(), wrt_uniforms, frozen)
    s_prm, s_uni = render_kernel_backward_plain(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    s_prm[list(frozen)] = 0.0
    torch.cuda.synchronize()
    assert float(loss) == pytest.approx(float(((rgb - target).double() ** 2).sum()), rel=1e-5)
    assert float(loss) == pytest.approx(float(p_loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    got = torch.cat([g_prm, g_uni])
    check_grads(got, torch.cat([s_prm, s_uni if wrt_uniforms else torch.zeros_like(s_uni)]), mass, rtol=1e-4,
                mass_tol=FLAGSHIP_SAME)
    check_grads(got, torch.cat([p_prm, p_uni]), mass, rtol=1e-4, mass_tol=FLAGSHIP_OWN)
    assert float(g_prm[shaded_slots(scene)].abs().max()) > 0.0


@pytest.mark.parametrize("wrt_uniforms", [True, False], ids=["uniforms", "params"])
def test_materials_render_backward_matches_plain(dev, wrt_uniforms):
    """Both K5 forms on ``materials_scene`` against the plain version at
    ``FLAGSHIP_SAME``."""
    cfg = dataclasses.replace(BASE, width=250, height=190)
    scene, prm, uni = _materials(cfg, dev)
    _, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    g_rgb = (torch.randn((3, cfg.height, cfg.width), generator=gen, device=dev)
             * conditioned(scene, prm, uni, t, cfg)).contiguous()
    got = render_kernel_backward_launch(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    want = render_kernel_backward_plain(scene, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt_uniforms)
    torch.cuda.synchronize()
    mass = gradient_mass(scene, prm, uni, g_rgb, t, sh, ao, cfg)
    if wrt_uniforms:
        check_grads(torch.cat(got), torch.cat(want), mass, rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    else:
        check_grads(got[0], want[0], mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    assert float(got[0][shaded_slots(scene)].abs().max()) > 0.0


def test_materials_tiles_equal_the_grid(dev):
    """K2 over a balanced 4-rank plan of 8×128 tiles gives K1's planes on
    ``materials_scene``, and K4's work-lists sum to K3 (loss 1e-5, gradients
    1e-4 of the mass)."""
    cfg = BASE
    kc = KernelConfig(tile_h=8, tile_w=128)
    scene, prm, uni = _materials(cfg, dev)
    plan = _plan((cfg.width, cfg.height), kc, "balanced")
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg, kc)
    target = (rgb * 0.95).contiguous()
    stacks = gather_target_tiles(target, plan)
    total = None
    for r in range(4):
        trow, tcol = plan.tables(r, dev)
        planes = render_kernel_tiles_launch(scene, prm, uni, trow, tcol, cfg, kc)
        whole = gather_target_tiles(torch.cat([rgb, t[None], sh[None], ao[None]]), plan)[r]
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([planes[0], *(p[None] for p in planes[1:])]), whole)
        got = fit_step_kernel_tiles_launch(scene, prm, uni, stacks[r].contiguous(), trow, tcol, cfg, kc, True, ())
        total = got if total is None else tuple(a + b for a, b in zip(total, got))
    w = fit_step_kernel_launch(scene, prm, uni, target, cfg, kc, True, ())
    torch.cuda.synchronize()
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    assert float(total[0]) == pytest.approx(float(w[0]), rel=1e-5)
    check_grads(torch.cat(total[1:]), torch.cat(w[1:]), mass, rtol=1e-4, mass_tol=1e-4)


# ---- diff.py (ROADMAP item 5) and the neural fits (17a, 17b) on the card ----


def _view_leaves(dev, azimuth):
    """The orbit camera at ``azimuth`` (the reference camera at 0), the
    reference light and material, every tensor a leaf that takes a gradient."""
    cam = tt.Camera.orbit(azimuth_deg=azimuth, elevation_deg=15.0, device=dev) if azimuth else \
        tt.Camera.reference(device=dev)
    objs = (cam, tt.reference_light(device=dev), tt.reference_material(device=dev))
    for obj in objs:
        for f in dataclasses.fields(obj):
            getattr(obj, f.name).requires_grad_(True)
    return objs


def _object_grads(sc, cam, light, mat):
    """Gradients in the uniforms' order (the light's colour reaches no pixel)."""
    from sdf3d_tpu_torch.ops.scene_program import leaves

    tensors = [*leaves(sc), cam.position, cam.c2w, cam.fov_deg, light.position, light.ambient,
               *(getattr(mat, f.name) for f in dataclasses.fields(mat))]
    return torch.cat([(x.grad if x.grad is not None else torch.zeros_like(x)).reshape(-1) for x in tensors])


@pytest.mark.parametrize("azimuth", [0.0, 30.0])
def test_torch_engine_gradients_match_kernel_route(dev, azimuth):
    """``diff.render_diff`` (the torch march, its implicit-function
    gradient) against ``render_kernel_diff`` (K1 forward, K5 in its P + 30
    form) on the reference scene: the image at the pixel budget, the depth
    at the t bar, the gradients of a seeded cotangent for the scene, camera,
    light and material at the own-march bar (1e-3 of the mass) on the pixels
    where the primals agree and the gradient is conditioned."""
    import copy

    from sdf3d_tpu_torch.camera import focal_z
    from sdf3d_tpu_torch.diff import depth_implicit, render_diff
    from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff

    cam, light, mat = _view_leaves(dev, azimuth)
    scene = tt.reference_scene().to(dev)
    prm, uni = _inputs(scene, cam, BASE, dev)
    k1 = render_kernel_launch(scene, prm, uni, BASE)
    with torch.no_grad():
        planes = (render_diff(scene, cam, light, mat, BASE).permute(2, 0, 1), depth_implicit(scene, cam, BASE),
                  k1[2], k1[3])
    check_planes(planes, k1, BASE.march.max_distance, razor=lambda: razor_edge(scene, prm, uni, BASE))
    gen = torch.Generator(device=dev)
    gen.manual_seed(48)
    keep = primals_agree(k1, planes, BASE.march.max_distance) & conditioned(scene, prm, uni, k1[1], BASE)
    g_rgb = (torch.randn((3, BASE.height, BASE.width), generator=gen, device=dev) * keep).contiguous()
    got, want = [], []
    for fn, out in ((lambda *a: render_diff(*a, BASE), got),
                    (lambda sc, *v: render_kernel_diff(BASE, KernelConfig(), sc, *v), want)):
        sc, view = copy.deepcopy(scene), _view_leaves(dev, azimuth)
        (fn(sc, *view) * g_rgb.permute(1, 2, 0)).sum().backward()
        out.append(_object_grads(sc, *view))
    P = prm.numel()
    mass = gradient_mass(scene, prm, uni, g_rgb, k1[1], k1[2], k1[3], BASE)[:P + 27].clone()
    fov = torch.tensor(60.0, device=dev, requires_grad=True)
    focal_z(fov, BASE.ray_mode).backward()
    mass[P + 12] *= fov.grad.abs()
    check_grads(got[0], want[0], mass, rtol=1e-4, mass_tol=1e-3)


def _neural_scene(dev, hidden=64):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return tt.sdf.ground_plane().to(dev) | tt.sdf.neural_sdf(gen, hidden=hidden, depth=3, radius=0.3)


def test_neural_fit_launches_k6_once_a_step(dev):
    """``fit_scene`` of ``ground_plane() | neural_sdf(hidden=64)`` on the
    kernel engine (ROADMAP 17a): one K6 launch a step and no other kernel,
    finite weights that move, step 0 within 1e-3 of the torch engine's (the
    neural kernel's own bar class, ``NEURAL_BAR``)."""
    cfg = dataclasses.replace(BASE, march=dataclasses.replace(BASE.march, max_steps=64),
                              shadow=dataclasses.replace(BASE.shadow, max_steps=32))
    scene = _neural_scene(dev)
    target = tt.render(tt.reference_scene().to(dev), tt.Camera.reference(device=dev), tt.reference_light(device=dev),
                       tt.reference_material(device=dev), cfg)
    view = (tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev))
    trainable = (False, False) + (True,) * 7
    render_neural_forward.launches = render_kernel_forward.launches = render_kernel_backward.launches = 0
    kfit = fit_scene(target, scene, *view, cfg, FitConfig(steps=3, learning_rate=1e-4, log_every=1),
                     trainable=trainable, device=dev)
    assert (render_neural_forward.launches, render_kernel_forward.launches, render_kernel_backward.launches) == \
        (3, 0, 0)
    fitted = scene_param_vector(kfit.scene)
    assert bool(torch.isfinite(fitted).all()) and not torch.equal(fitted, scene_param_vector(scene))
    tfit = fit_scene(target, scene, *view, cfg, FitConfig(steps=1, learning_rate=1e-4, engine="torch"),
                     trainable=trainable, device=dev)
    assert abs(kfit.losses[0] / tfit.losses[0] - 1.0) <= 1e-3


NEURAL_FIT_WORKER = r"""
import dataclasses, json, os, sys
import torch
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
torch.backends.cuda.matmul.allow_tf32 = False
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.parallel import launch, make_mesh, ring_kernel

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
mesh = make_mesh()
cfg = torch.load(os.path.join(outdir, "cfg.pt"), weights_only=False)
scene = torch.load(os.path.join(outdir, "scene.pt"), map_location=mesh.device, weights_only=False)
target = torch.load(os.path.join(outdir, "target.pt"), map_location=mesh.device)
view = (tt.Camera.reference(device=mesh.device), tt.reference_light(device=mesh.device),
        tt.reference_material(device=mesh.device))
ring_kernel.ring_allreduce.launches = ring_kernel.rs_ag_allreduce.launches = 0
res = fit_scene(target, scene, *view, cfg, FitConfig(steps=2, learning_rate=1e-4, log_every=1,
                allreduce="pallas_ring"), mesh=mesh, trainable=(False, False) + (True,) * 7)
json.dump({"losses": res.losses, "params": scene_param_vector(res.scene).tolist(),
           "launches": [ring_kernel.ring_allreduce.launches, ring_kernel.rs_ag_allreduce.launches]},
          open(os.path.join(outdir, f"out_r{rank}.json"), "w"))
launch.shutdown()
"""


def test_sharded_neural_fit_takes_rs_ag(dev, tmp_path):
    """Two processes on the card fit ``ground_plane() | neural_sdf(hidden=64)``
    (ROADMAP 17b): each renders its rows through ``diff.render_rays_diff``
    in bands, and ``allreduce="pallas_ring"`` sends the 4483-value step
    (the loss and the MLP's gradient; the plane frozen) through K8, not K7,
    once a step; the losses and
    parameters those of the unsharded torch-engine fit (JAX's bars: 1e-5,
    1e-4 plus 1e-6)."""
    from sdf3d_tpu_torch.parallel import ring_kernel

    ring_kernel.collectives_library()  # built here, before the ranks start
    cfg = dataclasses.replace(BASE, march=dataclasses.replace(BASE.march, max_steps=64),
                              shadow=dataclasses.replace(BASE.shadow, enabled=False))
    scene = _neural_scene(dev)
    view = (tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev))
    target = tt.render(tt.reference_scene().to(dev), *view, cfg)
    torch.save(cfg, tmp_path / "cfg.pt")
    torch.save(scene, tmp_path / "scene.pt")
    torch.save(target, tmp_path / "target.pt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = [subprocess.Popen([sys.executable, "-c", NEURAL_FIT_WORKER, str(port), str(r), str(tmp_path), str(repo)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [json.loads((tmp_path / f"out_r{r}.json").read_text()) for r in range(2)]
    assert outs[0] == outs[1] and outs[0]["launches"] == [0, 2]
    ref = fit_scene(target, scene, *view, cfg, FitConfig(steps=2, learning_rate=1e-4, log_every=1, engine="torch"),
                    trainable=(False, False) + (True,) * 7, device=dev)
    np.testing.assert_allclose(outs[0]["losses"], ref.losses, rtol=1e-5)
    np.testing.assert_allclose(outs[0]["params"], scene_param_vector(ref.scene).cpu().numpy(), rtol=1e-4, atol=1e-6)


# ---- the rest of the differentiable render (ROADMAP 12, 15b): the "ad"
# shadow and the row slabs on the card ----


def _ad(cfg):
    return dataclasses.replace(cfg, shadow=dataclasses.replace(cfg.shadow, grad="ad"))


@pytest.mark.parametrize("azimuth", [0.0, 30.0])
def test_shadow_ad_route_matches_cpu(dev, azimuth):
    """``render_kernel_diff`` under ``shadow.grad == "ad"`` on the card (K1
    forward, the planar re-trace with the shadow re-marched on CUDA tensors)
    against the same route on the CPU (the plain K1): K1 launched once and
    K5 never, the primal the "detach" render's bit for bit, the image at the
    pixel budget, and the gradients of a seeded cotangent for the scene,
    camera, light and material at the own-march bar (1e-3 of the mass, the
    re-march's terms counted) where the primals agree and the gradient is
    conditioned."""
    import copy

    from sdf3d_tpu_torch.camera import focal_z
    from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff

    cfg = _ad(BASE)
    cam, light, mat = _view_leaves(dev, azimuth)
    scene = tt.reference_scene().to(dev)
    prm, uni = _inputs(scene, cam, BASE, dev)
    k1 = render_kernel_launch(scene, prm, uni, BASE)
    plain = render_kernel_forward_plain(scene, prm, uni, BASE)
    keep = primals_agree(k1, plain, BASE.march.max_distance) & conditioned(scene, prm, uni, k1[1], BASE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    g_rgb = (torch.randn((3, BASE.height, BASE.width), generator=gen, device=dev) * keep).contiguous()
    render_kernel_forward.launches = render_kernel_backward.launches = 0
    sc_k = copy.deepcopy(scene)
    img = render_kernel_diff(cfg, KernelConfig(), sc_k, cam, light, mat)
    (img * g_rgb.permute(1, 2, 0)).sum().backward()
    torch.cuda.synchronize()
    assert (render_kernel_forward.launches, render_kernel_backward.launches) == (1, 0)
    torch.testing.assert_close(img.detach().permute(2, 0, 1), k1[0], rtol=0, atol=0)
    got = _object_grads(sc_k, cam, light, mat).cpu()
    cpu_view = [type(o)(*(getattr(o, f.name).detach().cpu().requires_grad_(True) for f in dataclasses.fields(o)))
                for o in (cam, light, mat)]
    sc_c = copy.deepcopy(scene).to("cpu")
    img_c = render_kernel_diff(cfg, KernelConfig(), sc_c, *cpu_view)
    check_planes((img.detach().permute(2, 0, 1), *k1[1:]), plain, BASE.march.max_distance)
    (img_c * g_rgb.cpu().permute(1, 2, 0)).sum().backward()
    want = _object_grads(sc_c, *cpu_view)
    mass = gradient_mass(scene, prm, uni, g_rgb, *k1[1:], BASE, remarch_shadow=True).cpu()
    P = prm.numel()
    fov = cpu_view[0].fov_deg.detach().clone().requires_grad_(True)
    focal_z(fov, BASE.ray_mode).backward()
    mass_obj = mass[:P + 27].clone()
    mass_obj[P + 12] *= fov.grad.abs()
    check_grads(got, want, mass_obj, rtol=1e-4, mass_tol=1e-3, label=f"'ad' route, card vs CPU, azimuth {azimuth}")


@pytest.mark.parametrize("interleaved", [False, True], ids=["contiguous", "interleaved"])
def test_row_slabs_match_the_full_launch(dev, interleaved):
    """K1 on each rank's row slab (the row uniforms of a 4-rank layout) gives
    the full launch's rows bit for bit, and K5 on the slabs sums to the full
    launch's gradient within 1e-5 of the mass (the partial rows group the
    pixels otherwise); under "ad" the slabs take K5 all the same (JAX's row
    route)."""
    from sdf3d_tpu_torch.ops.render_autograd import render_kernel_rows
    from sdf3d_tpu_torch.ops.scene_program import leaves
    from sdf3d_tpu_torch.parallel import launch
    from sdf3d_tpu_torch.parallel.mesh import Mesh
    from sdf3d_tpu_torch.parallel.shard_render import row_layout

    kc = KernelConfig(tile_h=8, tile_w=128)
    scene = tt.reference_scene().to(dev)
    cam = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    view = (cam, tt.reference_light(device=dev), tt.reference_material(device=dev))
    prm, uni = _inputs(scene, cam, BASE, dev)
    full = render_kernel_launch(scene, prm, uni, BASE, kc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    g = torch.randn((BASE.height, BASE.width, 3), generator=gen, device=dev)
    g_full = render_kernel_backward(scene, prm, uni, g.permute(2, 0, 1).contiguous(), *full[1:], BASE, kc,
                                    wrt_uniforms=False)[0]
    n = 4
    render_kernel_forward.launches = render_kernel_backward.launches = 0
    sc = tt.reference_scene().to(dev)
    for r in range(n):
        slab_cfg, row0, stride = row_layout(_ad(BASE), Mesh(n, r, dev), interleaved, kc.tile_h)
        rows = torch.from_numpy(launch.rank_rows(Mesh(n, r, dev), BASE.height, interleaved, kc.tile_h)).to(dev)
        slab = render_kernel_rows(sc, *view, slab_cfg, kc, row0, stride)
        torch.testing.assert_close(slab.detach(), full[0].permute(1, 2, 0)[rows], rtol=0, atol=0)
        (slab * g[rows]).sum().backward()
    torch.cuda.synchronize()
    assert (render_kernel_forward.launches, render_kernel_backward.launches) == (n, n)
    got = torch.cat([x.grad.reshape(-1) for x in leaves(sc)])
    mass = gradient_mass(scene, prm, uni, g.permute(2, 0, 1), *full[1:], BASE)[:prm.numel()]
    check_grads(got.cpu(), g_full.cpu(), mass.cpu(), rtol=1e-5, mass_tol=1e-5, label="K5 on row slabs")


# The union bounds as the card computes them: the g++ probe of
# tests/test_torch_union_bounds.py (Scene::Ray::lower(t) beside eval(t) for
# each bounded kind) built by nvcc with the kernels' flags for sm_90a.
BOUNDS_CARD_SHIM = r"""
#include <cuda_runtime.h>
#include "render_kernel.cuh"
{includes}

template <class S>
__global__ void bounds_kernel(const float* rays, const float* prm, int P, int n, float* value, float* lower) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* r = rays + 7 * i;
  typename S::Ray ray;
  ray.setup(r[0], r[1], r[2], r[3], r[4], r[5], prm + static_cast<long>(i) * P);
  value[i] = ray.eval(r[6]);
  lower[i] = ray.lower(r[6]);
}}

extern "C" int sdf3d_bounds_card(int k, const float* rays, const float* prm, int P, int n, float* value,
                                 float* lower) {{
  const int blocks = (n + 255) / 256;
  switch (k) {{
{cases}
    default: return 1;
  }}
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 2;
}}
"""


def test_union_bounds_hold_as_the_card_computes_them(dev, tmp_path):
    """``lower(t) <= eval(t)`` wherever ``eval(t)`` is not NaN, for every
    bounded kind of ``tests/test_torch_union_bounds.py`` at that test's
    seeded rays and parameters (10⁵ a kind), both computed on the card by an
    nvcc build with the kernels' flags (``ops/_build.py::NVCC_FLAGS``: nvcc
    contracts products into FMAs where it chooses, as in K1, which the g++
    builds cannot show)."""
    import test_torch_union_bounds as ub

    index, headers, includes, cases = {}, {}, [], []
    for kind in ub.KINDS:
        header = cuda_scene_source(ub.KINDS[kind][0](), tt.REFERENCE_CONFIG, KernelConfig())
        if header not in headers:
            k = headers[header] = len(headers)
            (tmp_path / f"scene{k}.cuh").write_text(header)
            includes.append(f'namespace s{k} {{\n#include "scene{k}.cuh"\n}}')
            cases.append(f"    case {k}: bounds_kernel<s{k}::Scene><<<blocks, 256>>>(rays, prm, P, n, value, lower);"
                         " break;")
        index[kind] = headers[header]
    (tmp_path / "shim.cu").write_text(BOUNDS_CARD_SHIM.format(includes="\n".join(includes), cases="\n".join(cases)))
    lib = tmp_path / "libbounds_card.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(ub.CSRC), "-I",
                           str(tmp_path), str(tmp_path / "shim.cu"), "-o", str(lib)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    handle = ctypes.CDLL(str(lib))
    handle.sdf3d_bounds_card.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2
    for kind in sorted(ub.KINDS):
        rng = np.random.default_rng(sorted(ub.KINDS).index(kind) + 2000)
        prm, centre, size, tight = ub.KINDS[kind][1](rng, ub.N)
        rays = ub._rays(rng, centre, size, tight)
        rays_d = torch.from_numpy(np.ascontiguousarray(rays, np.float32)).to(dev)
        prm_d = torch.from_numpy(np.ascontiguousarray(prm, np.float32)).to(dev)
        value, lower = (torch.empty(ub.N, dtype=torch.float32, device=dev) for _ in range(2))
        assert handle.sdf3d_bounds_card(index[kind], rays_d.data_ptr(), prm_d.data_ptr(), prm.shape[1], ub.N,
                                        value.data_ptr(), lower.data_ptr()) == 0
        value, lower = value.cpu().numpy(), lower.cpu().numpy()
        bad = ~(lower <= value) & ~np.isnan(value)
        assert not bad.any(), f"{kind}: {int(bad.sum())} samples with lower > value on the card, e.g. " \
                              f"{rays[bad][:3]}, {prm[bad][:3]}, {lower[bad][:3]}, {value[bad][:3]}"
        assert np.isfinite(lower).mean() > 0.99
        gap = (value - lower)[np.isfinite(value - lower)]
        print(f"\n[measured] {kind} on the card: {ub.N} samples, value - lower min {float(gap.min()):.3g}, "
              f"median {float(np.median(gap)):.3g}")
