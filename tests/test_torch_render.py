"""The port's plain PyTorch render path against the JAX package's XLA path and
the NumPy oracle, and the port's entry points on the CPU."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.oracle.numpy_oracle import render_reference_numpy
from sdf3d_tpu_torch import cli, convert
from sdf3d_tpu_torch.ops import render_kernel_forward
from sdf3d_tpu_torch.utils.parity import check_pixel_budget

torch.set_num_threads(1)

W, H = 128, 96
JCFG = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
TCFG = convert.from_jax(JCFG)


def _rot_y(deg):
    t = np.radians(deg)
    V = np.eye(4, dtype=np.float32)
    V[0, 0], V[0, 2], V[2, 0], V[2, 2] = np.cos(t), np.sin(t), -np.sin(t), np.cos(t)
    return V


CAMERAS = {
    "identity": lambda: s.Camera.reference(),
    "orbit": lambda: s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0),
    "view_matrix": lambda: s.Camera.reference(view_matrix=_rot_y(25.0)),
}


def _render_port(jcam, cfg=TCFG, scene=None):
    return tt.render(
        scene if scene is not None else tt.reference_scene(), convert.from_jax(jcam),
        tt.reference_light(), tt.reference_material(), cfg,
    ).numpy()


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_render_matches_jax_xla(cam):
    jcam = CAMERAS[cam]()
    want = np.asarray(s.render(s.reference_scene(), jcam, s.reference_light(), s.reference_material(), JCFG))
    check_pixel_budget(_render_port(jcam), want, "rgb", channel_axis=-1)


@pytest.mark.parametrize("view", [None, 25.0], ids=["identity", "rotated"])
def test_render_matches_numpy_oracle(view):
    V = None if view is None else _rot_y(view)
    jcam = s.Camera.reference(view_matrix=V)
    check_pixel_budget(_render_port(jcam), render_reference_numpy(W, H, view_matrix=V), "rgb", channel_axis=-1)


def test_render_options_match_jax_xla():
    """Tetrahedron normals, AO, Lambert shading and a background colour on a
    three-leaf scene."""
    jscene = s.sdf.union(
        s.sdf.ground_plane(), s.sdf.sphere((0.0, 0.4, 0.0), 0.2), s.sdf.sphere((0.35, 0.15, 0.1), 0.15)
    )
    jcfg = dataclasses.replace(
        JCFG, normals="tetrahedron", shading="lambert", background=(0.3, 0.2, 0.1),
        ao=dataclasses.replace(JCFG.ao, enabled=True),
    )
    jcam = CAMERAS["orbit"]()
    want = np.asarray(s.render(jscene, jcam, s.reference_light(), s.reference_material(), jcfg))
    got = _render_port(jcam, convert.from_jax(jcfg), convert.from_jax(jscene))
    check_pixel_budget(got, want, "rgb", channel_axis=-1)


def test_render_batch_on_cpu_runs_both_engines():
    cfg = dataclasses.replace(TCFG, width=48, height=32)
    cams = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0) for i in range(3)]
    light, mat = tt.reference_light(), tt.reference_material()
    before = render_kernel_forward.launches
    kern = tt.render_batch(tt.reference_scene(), cams, light, mat, cfg, engine="kernel", device="cpu")
    plain = tt.render_batch(tt.reference_scene(), cams, light, mat, cfg, engine="torch", device="cpu")
    assert render_kernel_forward.launches == before  # the CPU runs the plain version, no kernel
    assert kern.shape == (3, 32, 48, 3) and torch.isfinite(kern).all()
    for i in range(3):
        check_pixel_budget(kern[i], plain[i], f"frame {i}", channel_axis=-1)
    with pytest.raises(ValueError, match="engine"):
        tt.render_batch(tt.reference_scene(), cams, light, mat, cfg, engine="xla", device="cpu")


@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_cli_render_writes_png(engine, tmp_path):
    out = tmp_path / "out.png"
    rc = cli.main(["render", "--width", "40", "--height", "30", "--azimuth", "20",
                   "--engine", engine, "--device", "cpu", "--out", str(out)])
    data = out.read_bytes()
    assert rc == 0 and data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (40, 30)


def test_cli_scene_file_from_jax_package(tmp_path):
    """A setup written by the JAX package drives the port's CLI; the image
    matches the JAX render of the same file."""
    path, out = tmp_path / "setup.json", tmp_path / "out.png"
    jcfg = dataclasses.replace(JCFG, width=40, height=30)
    jcam = CAMERAS["orbit"]()
    s.sdf.save_setup(path, s.reference_scene(), jcam, s.reference_light(), s.reference_material(), jcfg)
    assert cli.main(["render", "--scene-file", str(path), "--device", "cpu", "--out", str(out)]) == 0
    from sdf3d_tpu.utils.image_io import encode_png

    want = np.asarray(s.render(s.reference_scene(), jcam, s.reference_light(), s.reference_material(), jcfg))
    assert out.read_bytes() == encode_png(want)
