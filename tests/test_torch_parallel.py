"""The port's sharded path in one process: plans, layouts and the tile-queue
kernels' plain versions (K2, K4) against the JAX package's (its 8-device CPU
mesh, Pallas in interpret mode, the (8, 128) test tile), and the port's own
invariants: partition invariance, dummy tiles, the row stride, and the g++
builds of K2 and K4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.march import march_step_map as jax_march_step_map
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import fit_step_kernel_tiles as jax_fit_step_kernel_tiles
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu.parallel import collectives as jax_collectives
from sdf3d_tpu.parallel import make_mesh as jax_make_mesh
from sdf3d_tpu.parallel import render_pallas_sharded
from sdf3d_tpu.parallel import shard_render as jax_shard_render
from sdf3d_tpu.parallel import tile_queue as jax_tile_queue
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.march import march_step_map
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops import KernelConfig, cuda_scene_source, pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel_plain, fit_step_kernel_tiles, fit_step_kernel_tiles_plain
from sdf3d_tpu_torch.ops.render_kernel import render_kernel_tiles_forward, render_kernel_tiles_forward_plain
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.parallel import Mesh, allreduce_tree, make_mesh, render_sharded_kernel
from sdf3d_tpu_torch.parallel import collectives, shard_render, tile_queue
from sdf3d_tpu_torch.utils.parity import check_grads, check_planes, conditioned, gradient_mass

torch.set_num_threads(1)

PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
KC = KernelConfig(tile_h=8, tile_w=128)
HW = [(96, 256), (88, 256)]  # 88 rows: 22 tiles, so 8 ranks get dummies
CAM, LIGHT, MAT = s.Camera.reference(), s.reference_light(), s.reference_material()


def _cfg(H, W):
    return dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)


def _inputs(scene, cfg, cam=None):
    cam = cam or tt.Camera.reference()
    uni = pack_uniforms(cam, tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    return scene_param_vector(scene), uni


def _work(H, W, seed=0):
    return np.random.default_rng(seed).exponential(size=(H // 8, W // 128))


class _Ranks:
    """A stand-in mesh of rank ``r`` of ``n``: the plain versions run each
    rank's share in one process."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return (Mesh(size=self.n, rank=r, device=torch.device("cpu")) for r in range(self.n))


@pytest.mark.parametrize("policy", ["round_robin", "balanced"])
@pytest.mark.parametrize("hw", HW)
def test_plan_tiles_matches_jax(policy, hw):
    H, W = hw
    for n in (8, 3):
        got = tile_queue.plan_tiles(H, W, 8, 128, n, policy, _work(H, W))
        want = jax_tile_queue.plan_tiles(H, W, 8, 128, n, policy, _work(H, W))
        for f in ("rows", "cols", "gather_index"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got.tiles_per_device == want.tiles_per_device
        trow, tcol = got.tables(1, "cpu")
        assert trow.dtype == torch.int32 and trow.is_contiguous()
        np.testing.assert_array_equal(trow.numpy(), want.rows[1])
        np.testing.assert_array_equal(tcol.numpy(), want.cols[1])


@pytest.mark.parametrize("hw", HW)
def test_gather_target_tiles_matches_jax(hw):
    H, W = hw
    plan = tile_queue.plan_tiles(H, W, 8, 128, 8, "balanced", _work(H, W, 1))
    jplan = jax_tile_queue.plan_tiles(H, W, 8, 128, 8, "balanced", _work(H, W, 1))
    x = np.random.default_rng(2).normal(size=(4, H, W)).astype(np.float32)
    got = tile_queue.gather_target_tiles(torch.from_numpy(x), plan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_tile_queue.gather_target_tiles(jnp.asarray(x), jplan)))
    np.testing.assert_array_equal(tile_queue.gather_target_tiles(torch.from_numpy(x[0]), plan).numpy(),
                                  np.asarray(jax_tile_queue.gather_target_tiles(jnp.asarray(x[0]), jplan)))


def test_interleave_rows_matches_jax():
    x = np.arange(128 * 3, dtype=np.float32).reshape(128, 3)
    for n, th in ((8, 8), (2, 8), (4, 16)):
        y = shard_render.interleave_rows(torch.from_numpy(x), n, th)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jax_shard_render.interleave_rows(jnp.asarray(x), n, th)))
        np.testing.assert_array_equal(shard_render.deinterleave_rows(y, n, th).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        shard_render.interleave_rows(torch.from_numpy(x), 8, 32)


def test_work_estimate_matches_jax():
    """``march_step_map`` counts the JAX package's steps; the pooled
    estimate ranks object tiles above sky tiles, as JAX's test asks."""
    cfg = _cfg(96, 256)
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=256, height=96)
    from sdf3d_tpu.camera import camera_rays as jax_camera_rays

    o, d = jax_camera_rays(CAM, 64, 24, jcfg.ray_mode)
    _, j_steps = jax_march_step_map(s.reference_scene().distance, o, d, jcfg.march)
    _, t_steps = march_step_map(tt.reference_scene().distance, torch.from_numpy(np.array(o)),
                                torch.from_numpy(np.array(d)), cfg.march)
    # A ray that passes a surface at almost exactly epsilon may take one
    # step more in one implementation (JAX's CPU rsqrt is not 1/sqrt).
    diff = np.abs(t_steps.numpy() - np.asarray(j_steps))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    steps = tile_queue.estimate_tile_work(tt.reference_scene(), tt.Camera.reference(), cfg, tt.reference_light(), 4)
    want = jax_tile_queue.estimate_tile_work(s.reference_scene(), CAM, jcfg, LIGHT, scale=4)
    assert steps.shape == want.shape == (24, 64)
    assert np.abs(steps - want).max() <= 2
    work = tile_queue.pool_work_to_tiles(steps, 96, 256, 8, 128)
    np.testing.assert_array_equal(work, jax_tile_queue.pool_work_to_tiles(steps, 96, 256, 8, 128))
    assert work.shape == (12, 2) and work[6:].mean() > 1.5 * work[:2].mean()


@pytest.mark.parametrize("num", [2, 3, 4, 8])
def test_ring_schedules_match_jax(num):
    assert collectives.ring_schedule(num) == jax_collectives.ring_schedule(num)
    for bp in (False, True):
        assert collectives.rs_ag_schedule(num, bp) == jax_collectives.rs_ag_schedule(num, bp)


def _jax_setup(H, W):
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    return jcfg, convert.from_jax(jcfg)


def _port_tiles_image(cfg, n, policy, work):
    """K2's plain version run per rank of an ``n``-rank plan, the stacks
    gathered in rank order and reassembled."""
    scene = tt.reference_scene()
    prm, uni = _inputs(scene, cfg)
    plan = tile_queue.plan_tiles(cfg.height, cfg.width, 8, 128, n, policy, work)
    stacks = []
    for mesh in _Ranks(n):
        trow, tcol = plan.tables(mesh.rank, "cpu")
        stacks.append(render_kernel_tiles_forward(scene, prm, uni, trow, tcol, cfg, KC))
    index = torch.from_numpy(plan.gather_index.astype(np.int64))
    planes = []
    for k in range(4):
        x = torch.cat([st[k] for st in stacks], dim=-2)  # rank-major stack
        lead = tuple(x.shape[:-2])
        x = x.reshape(lead + (n * plan.tiles_per_device, 8, 128))
        planes.append(x[..., index, :, :].transpose(-3, -2).reshape(lead + (cfg.height, cfg.width)))
    return planes, plan


@pytest.mark.parametrize("policy", ["round_robin", "balanced"])
@pytest.mark.parametrize("hw", HW)
def test_tiles_forward_matches_jax(hw, policy, cpu_devices):
    """K2's plain version per rank of an 8-rank plan, reassembled, against
    JAX's tile-queue render on its 8-device mesh (interpret mode), within
    the pixel budget; and the port's single-process ``render_tiles``
    reassembles the same image."""
    H, W = hw
    jcfg, cfg = _jax_setup(H, W)
    work = _work(H, W, 5)
    (rgb, t, sh, ao), _ = _port_tiles_image(cfg, 8, policy, work)
    want = np.asarray(jax_tile_queue.render_pallas_tiles(
        s.reference_scene(), CAM, LIGHT, MAT, jcfg, jax_make_mesh(cpu_devices, n_devices=8), PC, policy=policy,
        work=work, planar=True))
    check_planes((rgb,), (want,), cfg.march.max_distance)
    # The reassembled planes are K1's plain image, bit for bit.
    prm, uni = _inputs(tt.reference_scene(), cfg)
    whole = render_kernel_forward_plain(tt.reference_scene(), prm, uni, cfg, KC)
    for got, ref in zip((rgb, t, sh, ao), whole):
        assert torch.equal(got, ref)
    img = render_sharded_kernel(tt.reference_scene(), tt.Camera.reference(), tt.reference_light(),
                                tt.reference_material(), cfg, make_mesh("cpu"), KC, layout="tiles", planar=True)
    assert torch.equal(img, whole[0])


@pytest.mark.parametrize("layout,hw", [("contiguous", (96, 256)), ("interleaved", (128, 128))])
def test_row_layouts_match_jax(layout, hw, cpu_devices):
    """The row layouts' per-rank K1 plain renders (``row0``/``rowstride``
    slots, an 8-rank mesh), gathered, against JAX's ``render_pallas_sharded``
    on its 8-device mesh."""
    H, W = hw
    jcfg, cfg = _jax_setup(H, W)
    scene = tt.reference_scene()
    n = 8
    pieces = []
    for mesh in _Ranks(n):
        slab_cfg, row0, stride = shard_render.row_layout(cfg, mesh, layout == "interleaved", KC.tile_h)
        prm, uni = _inputs(scene, cfg)
        uni[28], uni[29] = float(row0), float(stride)
        pieces.append(render_kernel_forward_plain(scene, prm, uni, slab_cfg, KC)[0])
    out = torch.cat(pieces, dim=1)
    if layout == "interleaved":
        out = shard_render.deinterleave_rows(out.transpose(0, 1), n, KC.tile_h).transpose(0, 1)
    want = np.asarray(render_pallas_sharded(s.reference_scene(), CAM, LIGHT, MAT, jcfg,
                                            jax_make_mesh(cpu_devices, n_devices=8), PC, layout=layout, planar=True))
    check_planes((out,), (want,), cfg.march.max_distance)
    prm, uni = _inputs(scene, cfg)
    assert torch.equal(out, render_kernel_forward_plain(scene, prm, uni, cfg, KC)[0])


def _fit_target(cfg, seed):
    """The reference render plus seeded noise, none on grazing rays
    (``utils/parity.py::conditioned``), and the planes of the fit's start."""
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    prm, uni = _inputs(scene, cfg)
    rgb, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg)
    keep = conditioned(scene, prm, uni, t, cfg)
    noise = torch.from_numpy(np.random.default_rng(seed).uniform(-0.1, 0.1, rgb.shape).astype(np.float32))
    target = (rgb + noise * keep).contiguous()
    mass = gradient_mass(scene, prm, uni, 2.0 * (rgb - target), t, sh, ao, cfg)
    return scene, prm, uni, target, mass


def _port_tiles_step(scene, prm, uni, target, cfg, plan, wrt_uniforms=False, frozen=()):
    """K4's plain version per work-list, summed over the plan."""
    stacks = tile_queue.gather_target_tiles(target, plan)
    total = None
    for r in range(plan.n):
        trow, tcol = plan.tables(r, "cpu")
        got = fit_step_kernel_tiles(scene, prm, uni, stacks[r].contiguous(), trow, tcol, cfg, KC, wrt_uniforms,
                                    frozen)
        total = got if total is None else tuple(a + b for a, b in zip(total, got))
    return total


@pytest.mark.parametrize("wrt_uniforms,frozen", [(False, (0, 1, 2, 3)), (True, ())], ids=["scene-frozen", "uniforms"])
@pytest.mark.parametrize("hw", HW)
def test_tiles_fit_step_matches_jax(hw, wrt_uniforms, frozen):
    """K4's plain version summed over an 8-rank balanced plan against JAX's
    tile-queue fit kernel (interpret) over the same tiles: the loss within
    1e-5 relative, gradients within 1e-4 of the gradient mass (each side
    marches its own primal, ROADMAP Queue 3)."""
    H, W = hw
    jcfg, cfg = _jax_setup(H, W)
    scene, prm, uni, target, mass = _fit_target(cfg, 7)
    plan = tile_queue.plan_tiles(H, W, 8, 128, 8, "balanced", _work(H, W, 3))
    loss, g_prm, g_uni = _port_tiles_step(scene, prm, uni, target, cfg, plan, wrt_uniforms, frozen)

    jscene = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))
    jleaves, treedef = jax.tree_util.tree_flatten(jscene)
    juni = jax_pack_uniforms(CAM, LIGHT, MAT, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    jplan = jax_tile_queue.plan_tiles(H, W, 8, 128, 8, "balanced", _work(H, W, 3))
    stacks = jax_tile_queue.gather_target_tiles(jnp.asarray(target.numpy()), jplan)  # (8, 3, T·8, 128)
    all_tiles = jnp.concatenate([stacks[r] for r in range(8)], axis=1)
    j_loss, j_gp, j_gu = jax_fit_step_kernel_tiles(
        treedef, tuple(jnp.shape(x) for x in jleaves), jax_scene_param_vector(jscene), juni, all_tiles,
        jnp.asarray(jplan.rows.reshape(-1)), jnp.asarray(jplan.cols.reshape(-1)), jcfg, PC,
        wrt_uniforms=wrt_uniforms, frozen_slots=frozen)
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    check_grads(torch.cat([g_prm, g_uni]), np.concatenate([np.asarray(j_gp), np.asarray(j_gu)]), mass,
                rtol=1e-4, mass_tol=1e-4)
    assert all(float(g_prm[k]) == 0.0 for k in frozen)
    # The whole image's K3 (the same plain arithmetic, summed in another
    # order: 1e-5 of the mass).
    w_loss, w_prm, w_uni = fit_step_kernel_plain(scene, prm, uni, target, cfg, KC, wrt_uniforms, frozen)
    assert float(loss) == pytest.approx(float(w_loss), rel=1e-5)
    check_grads(torch.cat([g_prm, g_uni]), torch.cat([w_prm, w_uni]), mass, rtol=1e-4, mass_tol=1e-5)


def test_partition_invariance_and_dummy_tiles():
    """Any equal-count plan gives the same loss and gradients; a work-list of
    dummy tiles (row0 == H) adds exact zeros."""
    cfg = _cfg(88, 256)
    scene, prm, uni, target, mass = _fit_target(cfg, 11)
    a = _port_tiles_step(scene, prm, uni, target, cfg, tile_queue.plan_tiles(88, 256, 8, 128, 4, "round_robin"))
    b = _port_tiles_step(scene, prm, uni, target, cfg,
                         tile_queue.plan_tiles(88, 256, 8, 128, 8, "balanced", _work(88, 256, 9)))
    assert float(a[0]) == pytest.approx(float(b[0]), rel=1e-5)
    check_grads(torch.cat(a[1:]), torch.cat(b[1:]), mass, rtol=1e-4, mass_tol=1e-5)
    dummies = torch.full((3,), 88, dtype=torch.int32), torch.tensor([0, 128, 0], dtype=torch.int32)
    stack = torch.rand((3, 3 * 8, 128), generator=torch.Generator().manual_seed(0))
    loss, g_prm, g_uni = fit_step_kernel_tiles_plain(scene, prm, uni, stack, *dummies, cfg, KC, True)
    assert float(loss) == 0.0 and not g_prm.any() and not g_uni.any()
    rgb = render_kernel_tiles_forward_plain(scene, prm, uni, *dummies, cfg, KC)[0]
    assert rgb.shape == (3, 24, 128) and bool(torch.isfinite(rgb).all())


def test_rowstride_of_tile_height_is_unsharded():
    """Slot 29 at the tile height maps launch row r to row0 + r: the
    unsharded image bit for bit, in the plain version and in the g++ build
    of K1; an interleaved stride renders other rows."""
    cfg = _cfg(48, 64)
    scene = tt.reference_scene()
    prm, uni = _inputs(scene, cfg)
    kc = KernelConfig(tile_h=8, tile_w=32)
    base = render_kernel_forward_plain(scene, prm, uni, cfg, kc)
    strided = uni.clone()
    strided[29] = 8.0
    for a, b in zip(base, render_kernel_forward_plain(scene, prm, strided, cfg, kc)):
        assert torch.equal(a, b)
    lib = _host_library(scene, cfg, kc)
    host = [_host_render(lib, u, prm, cfg) for u in (uni, strided)]
    for a, b in zip(*host):
        np.testing.assert_array_equal(a, b)
    check_planes(host[0], base, cfg.march.max_distance)
    interleaved = uni.clone()
    interleaved[29] = 16.0
    assert not torch.equal(render_kernel_forward_plain(scene, prm, interleaved, cfg, kc)[0], base[0])


_HOST = {}


def _host_library(scene, cfg, kc, wrt_uniforms=True, frozen=()):
    """The g++ build of the render library's host forms (module cache)."""
    import shutil
    import tempfile

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if "libs" not in _HOST:
        _HOST["libs"] = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_host_"), host=True)
    return _HOST["libs"].load(cuda_scene_source(scene, cfg, kc, wrt_uniforms, frozen))


def _ptr(x):
    return x.numpy().ctypes.data if isinstance(x, torch.Tensor) else x.ctypes.data


def _host_render(lib, uni, prm, cfg):
    out = [np.empty((3, cfg.height, cfg.width), np.float32)]
    out += [np.empty((cfg.height, cfg.width), np.float32) for _ in range(3)]
    assert lib.sdf3d_render_fwd_host(_ptr(uni), _ptr(prm), *(_ptr(o) for o in out), cfg.height, cfg.width) == 0
    return out


@pytest.mark.parametrize("kc", [KernelConfig(tile_h=8, tile_w=32), KernelConfig(tile_h=8, tile_w=8, block_w=8,
                                                                                   block_h=8)],
                         ids=["tile8x32", "tile8x8"])
def test_tiles_kernels_on_cpu_match_plain(kc):
    """K2 and K4 built with g++ (their host forms), over a 3-rank balanced
    plan with dummy tiles (40 rows: 5 tile rows), against their plain
    versions."""
    H, W = 40, 64 if kc.tile_w == 32 else 56
    cfg = _cfg(H, W)
    scene, prm, uni, target, mass = _fit_target(cfg, 13)
    work = np.random.default_rng(4).exponential(size=(H // kc.tile_h, W // kc.tile_w))
    plan = tile_queue.plan_tiles(H, W, kc.tile_h, kc.tile_w, 3, "balanced", work)
    assert (plan.rows == H).any()  # dummies
    stacks = tile_queue.gather_target_tiles(target, plan)
    lib = _host_library(scene, cfg, kc, True, (0, 1))
    for r in range(3):
        trow, tcol = plan.tables(r, "cpu")
        T = int(trow.shape[0])
        got = [np.empty((3, T * kc.tile_h, kc.tile_w), np.float32)]
        got += [np.empty((T * kc.tile_h, kc.tile_w), np.float32) for _ in range(3)]
        assert lib.sdf3d_render_tiles_host(_ptr(uni), _ptr(prm), _ptr(trow), _ptr(tcol), *(_ptr(o) for o in got), T,
                                           H, W) == 0
        want = render_kernel_tiles_forward_plain(scene, prm, uni, trow, tcol, cfg, kc)
        check_planes(got, want, cfg.march.max_distance)
        stack = stacks[r].contiguous()
        n_blocks = T * -(-kc.tile_w // kc.block_w) * -(-kc.tile_h // kc.block_h)
        partials = np.empty((n_blocks, prm.numel() + 31), np.float32)
        totals = np.empty(prm.numel() + 31, np.float64)
        assert lib.sdf3d_fit_step_tiles_host(_ptr(uni), _ptr(prm), _ptr(trow), _ptr(tcol), *(_ptr(c) for c in stack),
                                             None, 0.0, 0.0, _ptr(partials), _ptr(totals), T, H, W) == 0
        out = torch.from_numpy(totals.astype(np.float32))
        loss, g_prm, g_uni = fit_step_kernel_tiles_plain(scene, prm, uni, stack, trow, tcol, cfg, kc, True, (0, 1))
        assert float(out[-1]) == pytest.approx(float(loss), rel=1e-5)
        check_grads(out[:-1], torch.cat([g_prm, g_uni]), mass, rtol=1e-4, mass_tol=1e-4)
        assert float(out[0]) == 0.0 and float(out[1]) == 0.0


def test_layout_rules_and_collectives():
    """``auto`` picks as JAX's rules do; the all-reduce at size 1 is the
    identity, for the ring kernels too."""
    kc = KernelConfig()
    assert shard_render.resolve_layout("auto", 16, 1080, 1920, kc) == "tiles"
    assert shard_render.resolve_layout("auto", 8, 960, 1920, kc) == "interleaved"
    assert shard_render.resolve_layout("auto", 8, 1080, 1920, kc) == "contiguous"  # 1080 % (8·24) != 0
    assert shard_render.resolve_layout("auto", 16, 1080, 1900, kc) == "contiguous"
    assert shard_render.resolve_layout("contiguous", 16, 1080, 1920, kc) == "contiguous"
    with pytest.raises(ValueError, match="layout"):
        shard_render.resolve_layout("rows", 2, 64, 128, kc)
    mesh = make_mesh("cpu")
    x = [torch.ones(3), torch.arange(4.0).reshape(2, 2)]
    for a, b in zip(allreduce_tree(x, "psum", mesh), x):
        assert torch.equal(a, b)
    for ring in ("pallas_ring", "pallas_rs_ag"):
        for a, b in zip(allreduce_tree(x, ring, mesh), x):
            assert a is b
    with pytest.raises(ValueError, match="allreduce"):
        allreduce_tree(x, "nccl", mesh)


@pytest.mark.parametrize("layout", ["tiles", "interleaved", "contiguous"])
def test_fit_scene_mesh_of_one_is_unsharded(layout):
    """``fit_scene(mesh=make_mesh("cpu"))`` at world size 1 computes the
    unsharded fit's trajectory."""
    cfg = _cfg(64, 128)
    target = tt.render(tt.reference_scene(), tt.Camera.reference(), tt.reference_light(), tt.reference_material(),
                       cfg)
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    view = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())
    common = dict(steps=4, learning_rate=1e-2, log_every=1, chunk_steps=3)
    ref = fit_scene(target, scene0, *view, cfg, FitConfig(**common), trainable=(False, False, True, True),
                    device="cpu", kernel_config=KC)
    got = fit_scene(target, scene0, *view, cfg, FitConfig(**common, shard_layout=layout), mesh=make_mesh("cpu"),
                    trainable=(False, False, True, True), kernel_config=KC)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)
    assert abs(got.scene.b.radius.item() - ref.scene.b.radius.item()) <= 1e-6
