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
from sdf3d_tpu_torch.utils.parity import check_planes

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

