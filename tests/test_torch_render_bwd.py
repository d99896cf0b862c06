"""The render backward's plain PyTorch version against the JAX package's Pallas
backward kernel (``render_kernel_backward``, run in interpret mode on the CPU),
both fed the same t/shadow/ao planes (JAX's interpret-mode forward kernel) and
the same cotangent."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.render_bwd_kernel import render_kernel_backward as jax_render_kernel_backward
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward, render_kernel_backward_plain
from sdf3d_tpu_torch.ops.render_kernel import pack_uniforms
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.utils.parity import FLAGSHIP_SAME, check_grads, conditioned, gradient_mass
from test_torch_scene_program import transform_sampler

torch.set_num_threads(1)

W, H = 128, 96
BASE = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
CAMERAS = {
    "reference": s.Camera.reference,
    "orbit": lambda: s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0),
}
# (ray form, normals, AO, camera): every option on both cameras.
CASES = [
    (True, "central", False, "reference"),
    (True, "central", False, "orbit"),
    (False, "central", True, "reference"),
    (True, "tetrahedron", False, "orbit"),
    (False, "tetrahedron", True, "orbit"),
    (True, "tetrahedron", True, "reference"),
    # The flagship at 128x96 and a ragged 120x90.
    (True, "central", False, "orbit", "flagship", (W, H)),
    (False, "central", False, "reference", "flagship", (120, 90)),
]
SCENES = {"reference": s.reference_scene, "flagship": s.flagship_scene}


def _id(case):
    ray_sdf, normals, ao, cam = case[:4]
    head = f"{case[4]}-{case[5][0]}x{case[5][1]}-" if len(case) > 4 else ""
    return f"{head}{'ray' if ray_sdf else 'point'}-{normals}-{'ao' if ao else 'noao'}-{cam}"


@pytest.mark.parametrize("wrt_uniforms", [True, False], ids=["uniforms", "params"])
@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_plain_backward_matches_jax_kernel(case, wrt_uniforms):
    """With ``wrt_uniforms`` the whole (P + 30) gradient against JAX's; without
    it ``g_prm`` alone, at the same bar, and no ``g_uni``."""
    ray_sdf, normals, ao, cam_name = case[:4]
    scene_name, (w, h) = case[4:] if len(case) > 4 else ("reference", (W, H))
    jcfg = dataclasses.replace(BASE, width=w, height=h, normals=normals, ao=dataclasses.replace(BASE.ao, enabled=ao))
    jscene, jcam, jlight, jmat = SCENES[scene_name](), CAMERAS[cam_name](), s.reference_light(), s.reference_material()
    pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True, ray_sdf=ray_sdf)
    _, t, shadow, ao_plane = (np.asarray(x) for x in jax_render_kernel_forward(
        jscene, jcam, jlight, jmat, jcfg, pc, planar=True))

    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    planes = [torch.from_numpy(x.copy()) for x in (t, shadow, ao_plane)]
    # A seeded cotangent, zero where a grazing ray makes the gradient
    # ill-conditioned (utils/parity.py::conditioned).
    keep = conditioned(scene, prm, uni, planes[0], cfg).numpy()
    g_rgb = np.random.default_rng(1).normal(size=(3, h, w)).astype(np.float32) * keep

    leaves, treedef = jax.tree_util.tree_flatten(jscene)
    juni = jax_pack_uniforms(jcam, jlight, jmat, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    want = jax_render_kernel_backward(
        treedef, tuple(jnp.shape(l) for l in leaves), jax_scene_param_vector(jscene), juni,
        jnp.asarray(g_rgb), *(jnp.asarray(x) for x in (t, shadow, ao_plane)), jcfg, pc)
    got = render_kernel_backward_plain(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg,
                                       wrt_uniforms=wrt_uniforms)

    mass = gradient_mass(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg)
    # The flagship's bar is 1e-4 of the mass (ROADMAP Queue 3): a ray
    # at |∇f·d| = 0.01005, on the edge of ``conditioned``'s floor, grazes a
    # rounded corner, and float32 rounding moves its term 6e-4 (the port)
    # and 1e-4 (JAX) off float64's: 1.4e-5 of the mass.
    mass_tol = 1e-5 if scene_name == "reference" else 1e-4
    if wrt_uniforms:
        check_grads(torch.cat(got), np.concatenate([np.asarray(w) for w in want]), mass, rtol=1e-4,
                    mass_tol=mass_tol)
        # Slot 27 (shadow k, a detached factor) and the row slots read exactly 0.
        assert float(got[1][27:].abs().max()) == 0.0
    else:
        assert got[1] is None
        check_grads(got[0], np.asarray(want[0]), mass[:prm.numel()], rtol=1e-4, mass_tol=mass_tol)
    # The wrapper on CPU tensors is the same plain version.
    again = render_kernel_backward(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg, wrt_uniforms=wrt_uniforms)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


# The scenes of ROADMAP item 13b at 96x72 (the cameras of
# test_torch_fit_kernel.py's 13b cases).
SCENES_13B = {"transform_sampler": (transform_sampler, CAMERAS["orbit"]),
              "capsule_chain": (s.capsule_chain, lambda: s.Camera.orbit(0, 25, 2.2)),
              "csg_showcase": (s.csg_showcase, lambda: s.Camera.orbit(25, 25, 2.4))}


@pytest.mark.parametrize("name", sorted(SCENES_13B))
def test_plain_backward_matches_jax_kernel_13b_scenes(name):
    """Both forms of the plain K5 (P + 30 and P columns) against JAX's
    interpret-mode backward on the same planes and cotangent, at the
    flagship's bar (``FLAGSHIP_SAME``: 1e-4 of the mass); on
    ``csg_showcase`` non-finite in the same slots as JAX's (every one)."""
    w, h = 96, 72
    jcfg = dataclasses.replace(BASE, width=w, height=h)
    scene_fn, cam_fn = SCENES_13B[name]
    jscene, jcam, jlight, jmat = scene_fn(), cam_fn(), s.reference_light(), s.reference_material()
    pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
    _, t, shadow, ao_plane = (np.asarray(x) for x in jax_render_kernel_forward(
        jscene, jcam, jlight, jmat, jcfg, pc, planar=True))
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    planes = [torch.from_numpy(x.copy()) for x in (t, shadow, ao_plane)]
    keep = conditioned(scene, prm, uni, planes[0], cfg).numpy()
    g_rgb = np.random.default_rng(1).normal(size=(3, h, w)).astype(np.float32) * keep
    leaves, treedef = jax.tree_util.tree_flatten(jscene)
    juni = jax_pack_uniforms(jcam, jlight, jmat, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    want = [np.asarray(x) for x in jax_render_kernel_backward(
        treedef, tuple(jnp.shape(l) for l in leaves), jax_scene_param_vector(jscene), juni,
        jnp.asarray(g_rgb), *(jnp.asarray(x) for x in (t, shadow, ao_plane)), jcfg, pc)]
    got = render_kernel_backward_plain(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg, wrt_uniforms=True)
    got_p, none = render_kernel_backward_plain(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg,
                                               wrt_uniforms=False)
    assert none is None
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()), np.isfinite(want[0]))
    np.testing.assert_array_equal(np.isfinite(got_p.numpy()), np.isfinite(want[0]))
    if name == "csg_showcase":
        assert not np.isfinite(want[0]).any()
        return
    mass = gradient_mass(scene, prm, uni, torch.from_numpy(g_rgb), *planes, cfg)
    check_grads(torch.cat(got), np.concatenate(want), mass, rtol=1e-4, mass_tol=FLAGSHIP_SAME)
    check_grads(got_p, want[0], mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME)


def test_background_misses_carry_no_gradient():
    """With a background colour a miss composites to it: its cotangent
    reaches nothing."""
    cfg = dataclasses.replace(convert.from_jax(BASE), background=(0.1, 0.2, 0.3))
    scene, cam = convert.from_jax(s.reference_scene()), convert.from_jax(CAMERAS["reference"]())
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, convert.from_jax(s.reference_light()), convert.from_jax(s.reference_material()))
    uni[27] = cfg.shadow.k
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward_plain

    _, t, shadow, ao = render_kernel_forward_plain(scene, prm, uni, cfg)
    miss = (t > cfg.march.max_distance).float()
    assert 0 < float(miss.mean()) < 1
    g_p, g_u = render_kernel_backward_plain(scene, prm, uni, miss.expand(3, H, W).contiguous(), t, shadow, ao, cfg)
    assert float(g_p.abs().max()) == 0.0 and float(g_u.abs().max()) == 0.0
