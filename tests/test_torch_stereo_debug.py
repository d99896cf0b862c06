"""Stereo, the turbo colormap, ``cli render --depth`` and the debug checks
against the JAX package (``stereo.py``, ``viz/colormap.py``, ``cli.py``,
``debug.py``).

Bars, each beside the error measured here:
- ``stereo_cameras``: 1e-6 absolute (the eyes' rotations are products of
  rotation matrices, summed in another order);
- ``render_stereo`` in every mode and on both engines against JAX's on its
  XLA engine: the image bar (``check_pixel_budget``); on the kernel engine
  ``"sbs"`` is two ``render_batch(engine="kernel")`` frames bit for bit;
- ``turbo``, ``turbo_lut``, ``apply_colormap``: 1e-6 absolute (the same
  polynomial in the same order);
- ``cli render --depth``: the floats at the image bar against JAX's
  ``turbo(clip(render_depth / 5, 0, 1))``, the PNG the port's encoding of
  them byte for byte;
- the debug checks give JAX's verdicts on a good scene, an unnormalised
  plane and a NaN parameter.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu import debug as jax_debug
from sdf3d_tpu.viz import apply_colormap as jax_apply_colormap
from sdf3d_tpu.viz import turbo as jax_turbo
from sdf3d_tpu.viz import turbo_lut as jax_turbo_lut
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import cli, convert, debug
from sdf3d_tpu_torch.utils import encode_png
from sdf3d_tpu_torch.utils.parity import check_pixel_budget
from sdf3d_tpu_torch.viz import apply_colormap, turbo, turbo_lut

torch.set_num_threads(1)

W, H = 32, 24
JCFG = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
RIGS = {"parallel": dict(baseline=0.065), "toe-in": dict(baseline=0.3, convergence=1.7)}


def _cam_np(cam):
    return [np.asarray(getattr(cam, f), np.float32) if not isinstance(getattr(cam, f), torch.Tensor)
            else getattr(cam, f).detach().numpy() for f in ("position", "c2w", "fov_deg")]


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_stereo_cameras_match_jax(rig):
    jcam = s.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0)
    want = s.stereo_cameras(jcam, **RIGS[rig])
    got = tt.stereo_cameras(convert.from_jax(jcam), **RIGS[rig])
    for g, w in zip(got, want):
        for a, b in zip(_cam_np(g), _cam_np(w)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # The toe-in rig's optical axes meet at the convergence distance.
    if "convergence" in RIGS[rig]:
        fwd = [-c.c2w[:, 2] for c in got]
        centre = convert.from_jax(jcam)
        point = centre.position - centre.c2w[:, 2] * RIGS[rig]["convergence"]
        for c, f in zip(got, fwd):
            to_point = point - c.position
            torch.testing.assert_close(f, to_point / torch.linalg.vector_norm(to_point), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["sbs", "cross", "anaglyph"])
def test_render_stereo_matches_jax(mode):
    jcam = s.Camera.reference()
    want = np.array(s.render_stereo(s.reference_scene(), jcam, s.reference_light(), s.reference_material(), JCFG,
                                    mode=mode, baseline=0.2, convergence=2.0))
    args = (tt.reference_scene(), convert.from_jax(jcam), tt.reference_light(), tt.reference_material(),
            convert.from_jax(JCFG))
    for engine in ("kernel", "torch"):
        got = tt.render_stereo(*args, mode=mode, baseline=0.2, convergence=2.0, engine=engine, device="cpu")
        assert got.shape == want.shape == ((H, 2 * W, 3) if mode != "anaglyph" else (H, W, 3))
        check_pixel_budget(got, torch.from_numpy(want), f"render_stereo {mode} {engine}", channel_axis=-1)
    if mode == "sbs":
        eyes = tt.stereo_cameras(args[1], 0.2, 2.0)
        frames = tt.render_batch(args[0], list(eyes), *args[2:], engine="kernel", device="cpu")
        torch.testing.assert_close(got_kernel := tt.render_stereo(*args, baseline=0.2, convergence=2.0,
                                                                  device="cpu"),
                                   torch.cat([frames[0], frames[1]], dim=1), rtol=0, atol=0)
        assert got_kernel.shape == (H, 2 * W, 3)
    with pytest.raises(ValueError, match="stereo mode"):
        tt.render_stereo(*args, mode="wiggle", device="cpu")


def test_colormap_matches_jax():
    x = np.concatenate([np.linspace(-0.2, 1.2, 301), np.random.default_rng(4).uniform(size=200)]).astype(np.float32)
    np.testing.assert_allclose(turbo(torch.from_numpy(x)).numpy(), np.asarray(jax_turbo(jnp.asarray(x))), rtol=0,
                               atol=1e-6)
    for n in (256, 17):
        np.testing.assert_allclose(turbo_lut(n).numpy(), np.asarray(jax_turbo_lut(n)), rtol=0, atol=1e-6)
    # Indices at the half-way points round half to even, as jnp.round.
    y = np.concatenate([x, (np.arange(256) + 0.5) / 255.0]).astype(np.float32)
    np.testing.assert_allclose(apply_colormap(torch.from_numpy(y)).numpy(), np.asarray(jax_apply_colormap(
        jnp.asarray(y))), rtol=0, atol=1e-6)
    lut = jax_turbo_lut(9)
    np.testing.assert_allclose(apply_colormap(torch.from_numpy(y), torch.from_numpy(np.array(lut))).numpy(),
                               np.asarray(jax_apply_colormap(jnp.asarray(y), lut)), rtol=0, atol=1e-6)


def test_cli_render_depth_matches_jax(tmp_path):
    out = tmp_path / "depth.png"
    assert cli.main(["render", "--depth", "--device", "cpu", "--width", str(W), "--height", str(H),
                     "--out", str(out)]) == 0
    floats = turbo(torch.clamp(tt.render_depth(tt.reference_scene(), tt.Camera.reference(),
                                               convert.from_jax(JCFG)) / 5.0, 0.0, 1.0))
    assert out.read_bytes() == encode_png(floats.numpy())
    want = jax_turbo(np.clip(np.asarray(s.render_depth(s.reference_scene(), s.Camera.reference(), JCFG)) / 5.0,
                             0.0, 1.0))
    check_pixel_budget(floats, torch.from_numpy(np.array(want)), "cli render --depth", channel_axis=-1)


def _scenes():
    """(name, JAX scene) for the debug checks: a good scene, an unnormalised
    plane (|n| = 2: twice the distance, Lipschitz 2) and a NaN radius."""
    return {
        "good": s.reference_scene(),
        "unnormalised_plane": s.sdf.union(s.sdf.plane(normal=(0.0, 2.0, 0.0), offset=0.0),
                                          s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)),
        "nan_parameter": s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=np.nan)),
    }


@pytest.mark.parametrize("name", ["good", "unnormalised_plane", "nan_parameter"])
def test_debug_checks_agree_with_jax(name):
    jscene = _scenes()[name]
    scene = convert.from_jax(jscene)
    view = [convert.from_jax(o) for o in (s.Camera.reference(), s.reference_light(), s.reference_material())]
    assert debug.finite_params(scene) == jax_debug.finite_params(jscene)
    ok, worst = debug.check_lipschitz(scene)
    j_ok, j_worst = jax_debug.check_lipschitz(jscene)
    assert ok == j_ok
    if name == "unnormalised_plane":
        assert worst == pytest.approx(j_worst, rel=0.05) and worst > 1.5  # both near 2
    problems = debug.validate_scene(scene)
    assert [p.split(" (")[0] for p in problems] == [p.split(" (")[0] for p in jax_debug.validate_scene(jscene)]
    if problems:
        with pytest.raises(ValueError):
            debug.validate_scene(scene, strict=True)
    err, img = debug.checked_render(scene, *view, convert.from_jax(JCFG))
    j_err, _ = jax_debug.checked_render(jscene, s.Camera.reference(), s.reference_light(), s.reference_material(),
                                        JCFG)
    assert (err.get() is None) == (j_err.get() is None)
    assert img.shape == (H, W, 3)
    if name == "nan_parameter":
        assert "scene parameters" in err.get()
        with pytest.raises(FloatingPointError, match="scene parameters"):
            err.throw()
    else:
        err.throw()
        torch.testing.assert_close(img, tt.render(scene, *view, convert.from_jax(JCFG)), rtol=0, atol=0)


def test_nan_debugging_is_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    with debug.nan_debugging():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan|NaN"):
            (torch.sqrt(x) * 0.0).sum().backward()
    assert not torch.is_anomaly_enabled()
