"""The row-slab differentiable kernel render and the sharded fits outside the
fused step (the port of JAX's ``render_pallas_rows`` and its route in
``fit.py``), and the torch engine's ``render_sharded``.

- ``render_kernel_rows`` slabs (the row uniforms of the contiguous and
  interleaved layouts, and contiguous slabs whose last tile row is partial)
  stack to the full image bit for bit, and their
  gradients sum to the full render's: ``check_grads`` at 1e-5 of the mass
  (the same planes; the sums group the pixels otherwise; measured 2.9e-6
  and 4.6e-6);
- the quirk of JAX's row route, pinned: its backward is always the fused
  kernel, so under ``shadow.grad == "ad"`` a slab's gradient is the
  "detach" one (here bit for bit), held to ``jax.grad`` through JAX's
  ``render_pallas_rows`` under "ad" at the own-march bar (1e-3 of the mass;
  measured within rtol), and its distance from the unsharded "ad" gradient
  is measured (0.53 of the largest component);
- two gloo processes on the CPU fit with ``fit_scene(mesh=...)`` outside the
  fused step, a scene with emitters, in the contiguous and interleaved
  layouts, under "ad" (the L2 loss) and under a multiscale pyramid that the
  kernel's block cannot hold: losses within 1e-5 relative and parameters
  within 1e-5 of the unsharded fit of the same semantics (under "ad" the
  unsharded "detach" fit, the row route's semantics; measured at most
  1.8e-7 and 2.2e-8);
- ``render_sharded`` over the two processes: the port's ``render`` bit for
  bit, JAX's ``render_sharded`` on its 8-device CPU mesh at the image bar,
  and with ``differentiable=True`` the ranks' gradients summing to
  ``render_diff``'s within 1e-5 of the gradient mass (measured 2.9e-6).
About 40 s on one worker.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.render_pallas import render_pallas_rows as jax_render_pallas_rows
from sdf3d_tpu.parallel import make_mesh as jax_make_mesh
from sdf3d_tpu.parallel.shard_render import render_sharded as jax_render_sharded
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.ops import KernelConfig, pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.fit_kernel import with_rows
from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff, render_kernel_rows
from sdf3d_tpu_torch.ops.render_kernel import pixel_planes
from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
from sdf3d_tpu_torch.parallel import launch
from sdf3d_tpu_torch.utils.parity import check_grads, check_pixel_budget, gradient_mass

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H = 32, 24
CFG = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
KC = KernelConfig(tile_h=4, tile_w=32)
AD = dataclasses.replace(CFG, shadow=dataclasses.replace(CFG.shadow, grad="ad"))
VIEW = (tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), tt.reference_light(), tt.reference_material())


def _slabs(n: int, interleaved: bool, tile_h: int = KC.tile_h):
    """Each rank's ``(row0, rowstride, absolute rows)`` of a row layout."""
    from sdf3d_tpu_torch.parallel.mesh import Mesh
    from sdf3d_tpu_torch.parallel.shard_render import row_layout

    out = []
    for r in range(n):
        mesh = Mesh(size=n, rank=r, device=torch.device("cpu"))
        _, row0, stride = row_layout(CFG, mesh, interleaved, tile_h)
        out.append((row0, stride, launch.rank_rows(mesh, H, interleaved, tile_h)))
    return out


def _grads(scene, cam):
    return torch.cat([x.grad.reshape(-1) for x in [*leaves(scene), cam.position]])


@pytest.mark.parametrize("interleaved,kc", [
    pytest.param(False, KC, id="contiguous"),
    pytest.param(True, KC, id="interleaved"),
    # 12-row slabs in tile rows of 5: a partial last tile row, as the default
    # tiles give 540-row slabs of a 1080-row image on two ranks.
    pytest.param(False, KernelConfig(tile_h=5, tile_w=32), id="contiguous_partial_tile"),
])
def test_slabs_stack_to_the_full_render(interleaved, kc):
    g = torch.from_numpy(np.random.default_rng(11).normal(size=(H, W, 3)).astype(np.float32))
    scene, cam = tt.reference_scene(), dataclasses.replace(VIEW[0], position=VIEW[0].position.clone())
    cam.position.requires_grad_(True)
    full = render_kernel_diff(CFG, KC, scene, cam, *VIEW[1:])
    (full * g).sum().backward()
    want = _grads(scene, cam)
    slab_cfg = dataclasses.replace(CFG, height=H // 2, ndc_height=H)
    img = torch.zeros_like(full)
    scene_s, cam_s = tt.reference_scene(), dataclasses.replace(VIEW[0], position=VIEW[0].position.clone())
    cam_s.position.requires_grad_(True)
    for row0, stride, rows in _slabs(2, interleaved, kc.tile_h):
        slab = render_kernel_rows(scene_s, cam_s, *VIEW[1:], slab_cfg, kc, row0, stride)
        assert slab.shape == (H // 2, W, 3)
        img[torch.from_numpy(rows)] = slab.detach()
        (slab * g[torch.from_numpy(rows)]).sum().backward()
    torch.testing.assert_close(img, full.detach(), rtol=0, atol=0)
    got = _grads(scene_s, cam_s)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(*VIEW, CFG.ray_mode)
    uni[27] = CFG.shadow.k
    _, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, CFG, KC)
    mass = gradient_mass(scene, prm, uni, g.permute(2, 0, 1), t, sh, ao, CFG)[:prm.numel() + 3]
    print("[measured] slabs:", check_grads(got, want, mass, rtol=1e-5, mass_tol=1e-5,
                                           label="slabs against the full render"))


def test_ad_on_the_row_route_is_the_detached_gradient():
    """JAX's ``_pu_bwd`` always runs the fused backward: under "ad" a slab's
    gradient is the "detach" one.  The port keeps that: bit for bit the
    slab's "detach" gradient, within the own-march bar of ``jax.grad``
    through JAX's ``render_pallas_rows`` under "ad", and off the unsharded
    "ad" gradient by the re-march's share (ROADMAP Queue 3)."""
    row0, stride, rows = _slabs(2, True)[1]
    slab_cfg = dataclasses.replace(AD, height=H // 2, ndc_height=H)
    g = np.random.default_rng(13).normal(size=(H // 2, W, 3)).astype(np.float32)

    def port(cfg):
        scene = tt.reference_scene()
        light = dataclasses.replace(VIEW[1], position=VIEW[1].position.clone().requires_grad_(True))
        (render_kernel_rows(scene, VIEW[0], light, VIEW[2], cfg, KC, row0, stride) * torch.from_numpy(g)).sum()\
            .backward()
        return torch.cat([x.grad.reshape(-1) for x in [*leaves(scene), light.position]])

    got_ad = port(slab_cfg)
    got_detach = port(dataclasses.replace(slab_cfg, shadow=CFG.shadow))
    torch.testing.assert_close(got_ad, got_detach, rtol=0, atol=0)

    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H // 2, ndc_height=H,
                               shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, grad="ad"))
    jcam = s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    pc = PallasRenderConfig(tile_h=KC.tile_h, tile_w=128, interpret=True)

    def loss(sc, l):
        return jnp.sum(jax_render_pallas_rows(sc, jcam, l, s.reference_material(), jcfg, pc, row0, stride)
                       * jnp.asarray(g))

    jg = jax.grad(loss, argnums=(0, 1))(s.reference_scene(), s.reference_light())
    want = np.concatenate([np.asarray(jax.flatten_util.ravel_pytree(jg[0])[0]), np.asarray(jg[1].position)])
    scene = tt.reference_scene()
    prm = scene_param_vector(scene)
    uni = with_rows(pack_uniforms(*VIEW, CFG.ray_mode), row0, stride)
    uni[27] = CFG.shadow.k
    cfg_d = dataclasses.replace(slab_cfg, shadow=CFG.shadow)
    _, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, cfg_d, KC)
    pixels = pixel_planes(uni, H // 2, W, KC.tile_h)
    mass = gradient_mass(scene, prm, uni, torch.from_numpy(g).permute(2, 0, 1), t, sh, ao, cfg_d, pixels)
    P = prm.numel()
    print("[measured] rows under 'ad' vs JAX:", check_grads(
        got_ad, want, torch.cat([mass[:P], mass[P + 13:P + 16]]), rtol=1e-4, mass_tol=1e-3,
        label="render_kernel_rows under 'ad' against JAX's render_pallas_rows"))

    # The unsharded "ad" gradient of the same rows (the cotangent zero
    # elsewhere) carries the re-march's share, which the row route drops.
    g_full = torch.zeros((H, W, 3))
    g_full[torch.from_numpy(rows)] = torch.from_numpy(g)
    scene_u = tt.reference_scene()
    light_u = dataclasses.replace(VIEW[1], position=VIEW[1].position.clone().requires_grad_(True))
    (render_kernel_diff(AD, KC, scene_u, VIEW[0], light_u, VIEW[2]) * g_full).sum().backward()
    unsharded_ad = torch.cat([x.grad.reshape(-1) for x in [*leaves(scene_u), light_u.position]])
    rel = float((unsharded_ad - got_ad).abs().max() / unsharded_ad.abs().max())
    print("[measured] rows 'ad' vs unsharded 'ad', of the largest component:", rel)
    assert rel > 1e-3, rel


WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.diff import render_diff
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops import KernelConfig
from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
from sdf3d_tpu_torch.parallel import allreduce_tree, launch, make_mesh, render_sharded

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, device="cpu")
mesh = make_mesh("cpu")
spec = json.load(open(os.path.join(outdir, "spec.json")))
cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=spec["width"], height=spec["height"])
cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
target = np.load(os.path.join(outdir, "target.npy"))
out = {"rank": mesh.rank, "fits": {}}
for name, run in spec["fits"].items():
    rc = dataclasses.replace(cfg, shadow=dataclasses.replace(cfg.shadow, grad=run["grad"]))
    kc = KernelConfig(**run["kc"])
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    res = fit_scene(target, scene0, cam, light, mat, rc, FitConfig(**run["fc"]), mesh=mesh,
                    trainable=(False, False, True, True), kernel_config=kc)
    out["fits"][name] = {"losses": res.losses, "params": scene_param_vector(res.scene).tolist()}
img = render_sharded(tt.reference_scene(), cam, light, mat, cfg, mesh)
out["render_sharded"] = img.numpy().tolist()
scene = tt.reference_scene()
g = torch.from_numpy(np.load(os.path.join(outdir, "cotangent.npy")))
(render_sharded(scene, cam, light, mat, cfg, mesh, differentiable=True) * g).sum().backward()
grads = allreduce_tree([x.grad.reshape(-1) for x in leaves(scene)], "psum", mesh)
out["render_sharded_grad"] = torch.cat(grads).tolist()
json.dump(out, open(os.path.join(outdir, f"out_r{rank}.json"), "w"))
launch.shutdown()
"""

# The fits outside the fused step that run on the row route, and the
# unsharded fit of the same semantics each is held to.
BLOCK = dict(block_w=32, block_h=2, tile_h=4, tile_w=32)  # a 2-level pyramid the 32x2 block cannot hold
FITS = {
    f"{layout}-{kind}": dict(
        grad="ad" if kind == "ad" else "detach", kc=BLOCK,
        fc=dict(steps=3, learning_rate=1e-2, log_every=1, shard_layout=layout,
                **({"loss": "multiscale", "pyramid_levels": 2} if kind == "multiscale" else {})))
    for layout in ("contiguous", "interleaved") for kind in ("ad", "multiscale")
}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _target():
    return tt.render(tt.reference_scene(), tt.Camera.reference(), tt.reference_light(), tt.reference_material(),
                     CFG).numpy()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("rows")
    np.save(outdir / "target.npy", _target())
    np.save(outdir / "cotangent.npy", np.random.default_rng(17).normal(size=(H, W, 3)).astype(np.float32))
    (outdir / "spec.json").write_text(json.dumps(dict(width=W, height=H, fits=FITS)))
    port = _free_port()
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
    return outdir, [json.loads((outdir / f"out_r{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("name", sorted(FITS))
def test_two_rank_fit_outside_the_fused_step_matches_unsharded(name, two_ranks):
    """The row route's fits (K1 + K5 per rank's slab) against the unsharded
    fit of the same semantics: under "ad" the "detach" fit (the fused step),
    under the multiscale pyramid the unsharded differentiable render."""
    _, outs = two_ranks
    r0, r1 = (o["fits"][name] for o in outs)
    assert r0 == r1
    run = FITS[name]
    fc = dict(run["fc"], shard_layout="auto")
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    want = tt.fit_scene(_target(), scene0, tt.Camera.reference(), tt.reference_light(), tt.reference_material(), CFG,
                        tt.FitConfig(**fc), trainable=(False, False, True, True), device="cpu",
                        kernel_config=KernelConfig(**run["kc"]))
    np.testing.assert_allclose(r0["losses"], want.losses, rtol=1e-5)
    np.testing.assert_allclose(r0["params"], scene_param_vector(want.scene).numpy(), rtol=0, atol=1e-5)
    print(f"[measured] {name}:", float(np.max(np.abs(np.asarray(r0["losses"]) / np.asarray(want.losses) - 1))),
          float(np.abs(np.asarray(r0["params"]) - scene_param_vector(want.scene).numpy()).max()))


def test_render_sharded_matches_render_and_jax(two_ranks, cpu_devices):
    _, outs = two_ranks
    imgs = [np.asarray(o["render_sharded"], np.float32) for o in outs]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    mine = tt.render(tt.reference_scene(), tt.Camera.reference(), tt.reference_light(), tt.reference_material(), CFG)
    np.testing.assert_array_equal(imgs[0], mine.numpy())
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    want = jax_render_sharded(s.reference_scene(), s.Camera.reference(), s.reference_light(), s.reference_material(),
                              jcfg, jax_make_mesh(cpu_devices, n_devices=8))
    check_pixel_budget(torch.from_numpy(imgs[0]), torch.from_numpy(np.array(want)), "render_sharded",
                       channel_axis=-1)


def test_render_sharded_gradients_sum_to_render_diff(two_ranks):
    """The ranks' gradients, summed, against ``render_diff``'s on the whole
    image: the same per-pixel terms grouped otherwise, held at 1e-5 of the
    gradient mass (the planar re-trace's per-pixel terms, as phase 48 of
    ``chip_smoke.py`` measures ``render_diff``'s)."""
    outdir, outs = two_ranks
    got = [np.asarray(o["render_sharded_grad"], np.float32) for o in outs]
    np.testing.assert_array_equal(got[0], got[1])
    g = torch.from_numpy(np.load(outdir / "cotangent.npy"))
    scene, view = tt.reference_scene(), (tt.Camera.reference(), tt.reference_light(), tt.reference_material())
    (tt.render_diff(scene, *view, CFG) * g).sum().backward()
    want = torch.cat([x.grad.reshape(-1) for x in leaves(scene)])
    prm = scene_param_vector(scene)
    uni = pack_uniforms(*view, CFG.ray_mode)
    uni[27] = CFG.shadow.k
    _, t, sh, ao = render_kernel_forward_plain(scene, prm, uni, CFG)
    mass = gradient_mass(scene, prm, uni, g.permute(2, 0, 1), t, sh, ao, CFG)[:prm.numel()]
    print("[measured] render_sharded grads:", check_grads(got[0], want, mass, rtol=1e-5, mass_tol=1e-5,
                                                          label="render_sharded's summed gradients"))
