"""The CUDA render kernel against its plain PyTorch version, on the card.

Marked ``cuda``; each test skips without a CUDA device.  On a machine with a
card and without JAX (``tests/conftest.py`` imports JAX) run:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import pytest
import torch

import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.render_kernel import (
    KernelConfig,
    pack_uniforms,
    render_kernel_forward,
    render_kernel_forward_plain,
    render_kernel_launch,
)
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.utils.parity import check_planes

torch.set_num_threads(1)
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


def _compare(scene, cam, cfg, kc, dev):
    prm, uni = _inputs(scene, cam, cfg, dev)
    got = render_kernel_launch(scene, prm, uni, cfg, kc)
    want = render_kernel_forward_plain(scene, prm, uni, cfg, kc)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    check_planes(got, want, cfg.march.max_distance)


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
