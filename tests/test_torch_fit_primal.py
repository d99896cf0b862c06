"""The fit kernel's structure on the CPU, through its host form (the same
C++ built by g++, ``csrc/fit_kernel.cu``): the reverse pass over a pixel's
own primal against the re-trace from its planes, the block sums and the
float64 total in the card's fixed order, and the columns it reduces."""

import dataclasses
import shutil
import tempfile

import numpy as np
import pytest
import torch

import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.fit_kernel import fit_columns, fit_step_kernel_plain
from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles
from sdf3d_tpu_torch.utils.parity import check_grads, conditioned, fixed_order_total, gradient_mass

torch.set_num_threads(1)

CASES = {
    "reference": (lambda: tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25)), {}),
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
}
_HOST = {}


def _library(scene, cfg, kc, wrt_uniforms, frozen):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if "libs" not in _HOST:
        _HOST["libs"] = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_host_"), host=True)
    return _HOST["libs"].load(cuda_scene_source(scene, cfg, kc, wrt_uniforms, frozen))


def _setup(case, H=24, W=64):
    scene_fn, overrides = CASES[case]
    scene = scene_fn()
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H, **overrides)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(tt.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0), tt.reference_light(),
                        tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    rgb = render_kernel_forward_plain(scene, prm, uni, cfg)[0]
    noise = np.random.default_rng(11).uniform(-0.1, 0.1, rgb.shape).astype(np.float32)
    return scene, cfg, prm, uni, (rgb + torch.from_numpy(noise)).contiguous()


def _ptr(x):
    return x.numpy().ctypes.data if isinstance(x, torch.Tensor) else x.ctypes.data


def _host_step(lib, uni, prm, target, kc, H, W):
    """The host form's partial rows and float64 totals over the image."""
    cols, live = fit_columns(lib)
    partials = np.zeros((-(-W // kc.block_w) * -(-H // kc.block_h), live), np.float32)
    totals = np.zeros(cols, np.float64)
    assert lib.sdf3d_fit_step_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in target), None, 0.0, 0.0, _ptr(partials),
                                   _ptr(totals), H, W, 1) == 0
    return partials, totals


def _values(P, wrt_uniforms):
    """A pixel's values: dP, dU where the kernel takes it, the loss last."""
    return P + 31 if wrt_uniforms else P + 1


def _warp_tree(values):
    """block_sum_store's order in numpy float32: lane l adds lane l + 16, 8,
    4, 2, 1 in turn within each warp, then the warps' sums in order from 0."""
    total = np.float32(0.0)
    for warp in range(values.shape[0] // 32):
        s = values[warp * 32:(warp + 1) * 32].astype(np.float32).copy()
        off = 16
        while off:
            s[:off] = s[:off] + s[off:2 * off]
            off //= 2
        total = np.float32(total + s[0])
    return total


@pytest.mark.parametrize("wrt_uniforms", [False, True], ids=["scene", "uniforms"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reverse_over_own_primal_equals_retrace(case, wrt_uniforms):
    """Per pixel, the reverse pass over the Primal of the pixel's own
    forward (K3) equals, bit for bit, the one over the Primal rebuilt from
    that forward's (t, shadow, ao) (K5's route): tracing once moved no
    arithmetic."""
    scene, cfg, prm, uni, target = _setup(case)
    H, W = cfg.height, cfg.width
    lib = _library(scene, cfg, KernelConfig(), wrt_uniforms, ())
    P = prm.numel()
    own, retraced = (np.full((H * W, _values(P, wrt_uniforms)), np.nan, np.float32) for _ in range(2))
    assert lib.sdf3d_fit_retrace_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in target), _ptr(own), _ptr(retraced),
                                      H, W) == 0
    assert np.array_equal(own.view(np.uint32), retraced.view(np.uint32))
    assert (own[:, :P] != 0.0).sum(0).min() > 0  # every parameter gets gradient from some pixel
    assert (own[:, -1] > 0.0).sum() > H * W // 2


@pytest.mark.parametrize("kc", [KernelConfig(), KernelConfig(block_w=8, block_h=8), KernelConfig(block_h=1)],
                         ids=["32x8", "8x8", "32x1"])
@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, (0, 1, 2, 3)), (True, ()), (True, (5,))],
                         ids=["scene-frozen", "uniforms", "uniforms-frozen"])
def test_host_rows_and_total_follow_the_fixed_order(kc, wrt_uniforms, frozen):
    """The host form's partial rows are each block's pixels summed in the
    warp-tree order (from the per-pixel values of ``sdf3d_fit_retrace_host``),
    and its float64 totals are :func:`fixed_order_total` of those rows
    exactly (32×1 blocks: 80 rows)."""
    scene, cfg, prm, uni, target = _setup("reference", H=40)
    H, W = cfg.height, cfg.width
    lib = _library(scene, cfg, kc, wrt_uniforms, frozen)
    P = prm.numel()
    cols, live = fit_columns(lib)
    assert cols == P + 31
    partials, totals = _host_step(lib, uni, prm, target, kc, H, W)
    n = _values(P, wrt_uniforms)
    pixel = np.zeros((H * W, n), np.float32)
    assert lib.sdf3d_fit_retrace_host(_ptr(uni), _ptr(prm), *(_ptr(c) for c in target), _ptr(pixel),
                                      _ptr(np.zeros_like(pixel)), H, W) == 0
    pixel = pixel.reshape(H, W, n)
    keep = [k for k in range(n) if k not in frozen]
    nt = kc.block_w * kc.block_h
    gx = -(-W // kc.block_w)
    for b in range(partials.shape[0]):
        by, bx = divmod(b, gx)
        block = pixel[by * kc.block_h:(by + 1) * kc.block_h, bx * kc.block_w:(bx + 1) * kc.block_w]
        values = block.reshape(nt, n)[:, keep]
        want = [_warp_tree(values[:, j]) for j in range(live)]
        assert np.array_equal(partials[b].view(np.uint32), np.array(want, np.float32).view(np.uint32))
    want = np.zeros(cols, np.float64)
    want[keep[:-1] + [cols - 1]] = fixed_order_total(partials)  # the loss is the totals' last column
    assert np.array_equal(totals.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("frozen", [(), (0, 1, 2, 3)], ids=["none", "plane"])
def test_columns_without_uniforms(frozen):
    """Without ``wrt_uniforms`` a block reduces P + 1 values (the scene's
    gradient, then the loss) less the frozen slots: a partial row has
    P + 1 − |frozen| columns.  The totals keep all P + 31 columns, the
    uniforms' and the frozen slots' exactly 0, and hold the plain version
    at the fit step's bars."""
    scene, cfg, prm, uni, target = _setup("reference")
    H, W, P = cfg.height, cfg.width, prm.numel()
    lib = _library(scene, cfg, KernelConfig(), False, frozen)
    assert fit_columns(lib) == (P + 31, P + 1 - len(frozen))
    partials, totals = _host_step(lib, uni, prm, target, KernelConfig(), H, W)
    assert partials.shape[1] == P + 1 - len(frozen)
    assert all(totals[k] == 0.0 for k in frozen) and all(totals[k] != 0.0 for k in range(P) if k not in frozen)
    assert not totals[P:-1].any()
    loss, g_prm, _ = fit_step_kernel_plain(scene, prm, uni, target, cfg, KernelConfig(), False, frozen)
    assert float(totals[-1]) == pytest.approx(float(loss), rel=1e-5)
    rgb, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg)
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target) * conditioned(scene, prm, uni, t, cfg), t, sh, ao,
                         cfg)
    check_grads(torch.from_numpy(totals[:P].astype(np.float32)), g_prm, mass[:P], rtol=1e-4, mass_tol=1e-3)


def test_k3_and_k4_give_equal_rows_on_the_host():
    """K3 over an image and K4 over a balanced plan of its 24×640 tiles
    (whole 32×8 blocks, out of image order) give the same partial rows, bit for bit, for the same pixels,
    and the same totals once rounded to float32."""
    H, W = 48, 1280
    scene, cfg, prm, uni, target = _setup("reference", H, W)
    kc = KernelConfig()
    lib = _library(scene, cfg, kc, False, (0, 1, 2, 3))
    rows3, totals3 = _host_step(lib, uni, prm, target, kc, H, W)
    work = np.random.default_rng(5).exponential(size=(H // kc.tile_h, W // kc.tile_w))
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1, "balanced", work)  # the tiles out of image order
    trow, tcol = plan.tables(0, "cpu")
    T = int(trow.shape[0])
    stack = gather_target_tiles(target, plan)[0].contiguous()
    bx4, by4 = kc.tile_w // kc.block_w, kc.tile_h // kc.block_h
    rows4 = np.zeros((T * bx4 * by4, rows3.shape[1]), np.float32)
    totals4 = np.zeros_like(totals3)
    assert lib.sdf3d_fit_step_tiles_host(_ptr(uni), _ptr(prm), _ptr(trow), _ptr(tcol), *(_ptr(c) for c in stack),
                                         None, 0.0, 0.0, _ptr(rows4), _ptr(totals4), T, H, W) == 0
    gx3 = W // kc.block_w
    for z in range(T):
        for by in range(by4):
            for bx in range(bx4):
                k3 = (int(trow[z]) // kc.block_h + by) * gx3 + int(tcol[z]) // kc.block_w + bx
                k4 = (z * by4 + by) * bx4 + bx
                assert np.array_equal(rows3[k3].view(np.uint32), rows4[k4].view(np.uint32))
    assert np.array_equal(totals3.astype(np.float32), totals4.astype(np.float32))
