"""The render kernel's plain PyTorch version against the JAX package's Pallas
kernel (``_render_tile_kernel``, run in interpret mode on the CPU as the JAX
package's own tests run it): all four output planes, with the pixel budget."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.ops import KernelConfig, pack_uniforms, render_kernel_forward, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.utils.parity import CREASE_BAR, check_planes
from test_torch_scene_program import transform_sampler

torch.set_num_threads(1)

W, H = 128, 96
BASE = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
# (ray form, normals, AO, scene, size): every option on the reference scene,
# and the flagship in both forms at 128x96 and a ragged 120x90.
CASES = [c + ("reference", (W, H)) for c in itertools.product([True, False], ["central", "tetrahedron"],
                                                             [False, True])] + [
    (True, "central", False, "flagship", (W, H)),
    (False, "central", False, "flagship", (W, H)),
    (True, "central", False, "flagship", (120, 90)),
]
SCENES = {"reference": s.reference_scene, "flagship": s.flagship_scene}
# The scenes of ROADMAP item 13b in the ray form at 128x96, each under its
# camera of the JAX gallery (examples/render_gallery.py), the transform
# sampler under the reference camera.
GALLERY = {
    "csg_showcase": (s.csg_showcase, lambda: s.Camera.orbit(25, 25, 2.4)),
    "lattice_scene": (s.lattice_scene, lambda: s.Camera.orbit(15, 18, 3.0)),
    "capsule_chain": (s.capsule_chain, lambda: s.Camera.orbit(0, 25, 2.2)),
    "random_blobs": (lambda: s.random_blobs(n=8), lambda: s.Camera.orbit(40, 22, 2.4)),
    "transform_sampler": (transform_sampler, s.Camera.reference),
}


def _ids(case):
    ray_sdf, normals, ao, scene, (w, h) = case
    head = "" if scene == "reference" else f"{scene}-{w}x{h}-"
    return f"{head}{'ray' if ray_sdf else 'point'}-{normals}-{'ao' if ao else 'noao'}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plain_matches_jax_pallas_kernel(case):
    ray_sdf, normals, ao, scene_name, (w, h) = case
    jcfg = dataclasses.replace(BASE, width=w, height=h, normals=normals, ao=dataclasses.replace(BASE.ao, enabled=ao))
    jcam = s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    jscene = SCENES[scene_name]()
    pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True, ray_sdf=ray_sdf)
    want = jax_render_kernel_forward(
        jscene, jcam, s.reference_light(), s.reference_material(), jcfg, pc, planar=True
    )

    scene, cam, light, mat, cfg = (
        convert.from_jax(o) for o in (jscene, jcam, s.reference_light(), s.reference_material(), jcfg)
    )
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    got = render_kernel_forward_plain(scene, prm, uni, cfg, KernelConfig(ray_sdf=ray_sdf))
    check_planes(got, [np.asarray(w) for w in want], cfg.march.max_distance)
    # The wrapper on CPU tensors is the same plain version, image-major.
    rgb, t, _, _ = render_kernel_forward(scene, cam, light, mat, cfg, KernelConfig(ray_sdf=ray_sdf))
    torch.testing.assert_close(rgb, got[0].permute(1, 2, 0), rtol=0, atol=0)
    torch.testing.assert_close(t, got[1], rtol=0, atol=0)



@pytest.mark.parametrize("name", sorted(GALLERY))
def test_plain_matches_jax_pallas_kernel_13b_scenes(name):
    """The plain version of K1 (ray form) against JAX's interpret-mode kernel
    on each 13b scene, all four planes within ``docs/parity.md``'s budget.
    ``csg_showcase`` is held to ``CREASE_BAR``: 28 of 12288 shadow pixels
    (0.23%, at most 4.6e-4) are over 1e-4 here, on the hard Subtraction's
    and Intersection's creases; in the point form none is."""
    scene_fn, cam_fn = GALLERY[name]
    jcfg, jscene, jcam = BASE, scene_fn(), cam_fn()
    pc = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
    want = jax_render_kernel_forward(jscene, jcam, s.reference_light(), s.reference_material(), jcfg, pc, planar=True)
    scene, cam, light, mat, cfg = (
        convert.from_jax(o) for o in (jscene, jcam, s.reference_light(), s.reference_material(), jcfg)
    )
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    got = render_kernel_forward_plain(scene, prm, uni, cfg, KernelConfig())
    check_planes(got, [np.asarray(w) for w in want], cfg.march.max_distance,
                 **(CREASE_BAR if name == "csg_showcase" else {}))
