"""The port's interactive runtime (``sdf3d_tpu_torch/interact``) held to the
JAX package's: the native navigation controllers of both packages bit for
bit on the same event scripts (one source, one compiler, the same flags),
the loader's order (a prebuilt library from ``$SDF3D_NATIVE_DIR`` first, as
the JAX package's), the port's Python controller against its native one, the JAX cases of
``tests/test_interact.py`` and ``tests/test_devices.py`` on both packages,
and one headless session through both, each on its own plain render."""

import dataclasses
import importlib
import io
import pathlib
import struct
import subprocess

import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.interact import NavigationController as JaxNav
from sdf3d_tpu_torch.interact import InteractiveSession, NavigationController, navigation_available
from sdf3d_tpu_torch.ops import render_kernel_forward
from sdf3d_tpu_torch.utils.parity import check_pixel_budget

torch.set_num_threads(1)

PACKAGES = ("sdf3d_tpu", "sdf3d_tpu_torch")
CFGS = {"sdf3d_tpu": dataclasses.replace(s.REFERENCE_CONFIG, width=48, height=32),
        "sdf3d_tpu_torch": dataclasses.replace(tt.REFERENCE_CONFIG, width=48, height=32)}


def interact(pkg):
    return importlib.import_module(f"{pkg}.interact")


def devices(pkg):
    return importlib.import_module(f"{pkg}.interact.devices")


def session_kwargs(pkg):
    return {"device": "cpu"} if pkg == "sdf3d_tpu_torch" else {}


def render_fn(pkg):
    """Each package's plain render of the reference scene at 48×32: JAX's
    ``render`` and the port's render kernel's plain version (the CPU side
    of the path the card runs)."""
    cfg = CFGS[pkg]
    if pkg == "sdf3d_tpu":
        light, mat, scene = s.reference_light(), s.reference_material(), s.reference_scene()
        return lambda cam: s.render(scene, cam, light, mat, cfg)
    light, mat, scene = tt.reference_light(), tt.reference_material(), tt.reference_scene()
    return lambda cam: render_kernel_forward(scene, cam, light, mat, cfg, device="cpu")[0]


# Event scripts: (kind, *args) per call, "step" advancing the filter.
SCRIPTS = {
    "drags": [("drag", 0.05, 0.01, False)] * 3 + [("step", 1 / 60)] * 10 + [("drag", -0.2, 0.07, False)]
    + [("step", 1 / 30)] * 12,
    "pan_scroll": [("drag", 0.03, -0.02, True), ("scroll", 0.5), ("step", 1 / 60), ("scroll", -1.25)]
    + [("step", 1 / 60)] * 20 + [("drag", -0.4, 0.1, True), ("step", 0.1), ("step", 0.2)],
    "gamepad": [("gamepad", 0.6, 0.1, -0.5, 0.45, 0.35)] + [("step", 1 / 60)] * 8
    + [("gamepad", 0.2, -0.9, 0.31, -0.29, -0.8), ("step", 1 / 60), ("gamepad", -1.0, 1.0, 1.0, -1.0, 1.0)]
    + [("step", 1 / 30)] * 15,
    "clamp_and_zoom": [("drag", 0.0, 0.5, False), ("step", 1 / 30)] * 40 + [("scroll", 30.0)]
    + [("step", 1 / 30)] * 30,
}


def replay(nav, script, pose=(0.2, 0.1, 2.0, (0.0, 0.2, 0.0)), **tuning):
    nav.configure(**tuning).set_pose(*pose)
    out = []
    for kind, *a in script:
        if kind == "drag":
            nav.mouse_drag(a[0], a[1], pan=a[2])
        elif kind == "scroll":
            nav.scroll(a[0])
        elif kind == "gamepad":
            nav.gamepad(*a)
        else:
            nav.step(a[0])
            az, el, dist, target = nav.pose()
            out.append((np.float32([az, el, dist, *target]), nav.view_matrix().copy()))
    return out


needs_native = pytest.mark.skipif(not navigation_available(), reason="no C++ compiler")


@needs_native
@pytest.mark.parametrize("tuning", [{}, dict(orbit_rate=0.7, pan_rate=3.0, decay=2.0, deadzone=0.2)],
                         ids=["reference", "tuned"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_native_controllers_bit_for_bit(script, tuning):
    jax_nav, port_nav = JaxNav(), NavigationController()
    assert jax_nav.is_native and port_nav.is_native
    got, want = replay(port_nav, SCRIPTS[script], **tuning), replay(jax_nav, SCRIPTS[script], **tuning)
    assert len(got) == len(want) > 0
    for (pg, vg), (pw, vw) in zip(got, want):
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_array_equal(vg, vw)


@needs_native
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_python_controller_matches_native(script):
    """The port's pure-Python controller against its native one, at JAX's
    tolerance (``tests/test_interact.py``: poses 1e-4 relative, view
    matrices 1e-5)."""
    nat, py = NavigationController(), NavigationController(prefer_native=False)
    assert nat.is_native and not py.is_native
    for (pn, vn), (pp, vp) in zip(replay(nat, SCRIPTS[script]), replay(py, SCRIPTS[script])):
        np.testing.assert_allclose(pn[:3], pp[:3], rtol=1e-4)
        np.testing.assert_allclose(vn, vp, atol=1e-5)


def test_loader_builds_into_the_ports_build_directory(tmp_path):
    from sdf3d_tpu_torch.interact import controller
    from sdf3d_tpu_torch.ops import _build

    if not navigation_available():
        pytest.skip(f"no C++ compiler: {controller.navigation_error()}")
    lib = pathlib.Path(controller._load()._name)
    assert lib.parent == _build.BUILD_DIR / "native" and lib.name.startswith("navigation_")
    # Keyed by the source: a changed source builds a library of its own.
    src = tmp_path / "navigation.cpp"
    src.write_bytes(controller._SRC.read_bytes() + b"\n// changed\n")
    other = pathlib.Path(_build.load_native(src, tmp_path / "build")._name)
    assert other.parent == tmp_path / "build" / "native" and other.name != lib.name
    assert _build.NATIVE_FLAGS == ("-O2", "-std=c++17", "-shared", "-fPIC")


@needs_native
@pytest.mark.parametrize("where", ["prebuilt", "unset", "empty_dir"])
def test_loader_takes_the_prebuilt_library_from_sdf3d_native_dir(where, tmp_path, monkeypatch):
    """``$SDF3D_NATIVE_DIR/libsdf3d_navigation.so`` (the CMake tree's name)
    comes first, as in the JAX package's loader: with it and no C++
    compiler the controller is native, loaded from that file, and its poses
    are JAX's native controller's bit for bit.  With the variable unset or
    naming a directory without the file, the build path is taken as
    before."""
    from sdf3d_tpu_torch.interact import controller
    from sdf3d_tpu_torch.ops import _build

    if where == "prebuilt":
        prebuilt = tmp_path / "libsdf3d_navigation.so"
        subprocess.run([_build.find_cxx(), *_build.NATIVE_FLAGS, str(controller._SRC), "-o", str(prebuilt)],
                       check=True, capture_output=True)
        monkeypatch.setenv("SDF3D_NATIVE_DIR", str(tmp_path))

        def no_compiler():
            raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")

        monkeypatch.setattr(_build, "find_cxx", no_compiler)
    elif where == "unset":
        monkeypatch.delenv("SDF3D_NATIVE_DIR", raising=False)
    else:
        (tmp_path / "empty").mkdir()
        monkeypatch.setenv("SDF3D_NATIVE_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(controller, "_LIB", None)
    monkeypatch.setattr(controller, "_BUILD_ERROR", None)
    nav = NavigationController()
    assert nav.is_native, controller.navigation_error()
    loaded = pathlib.Path(controller._LIB._name)
    if where == "prebuilt":
        assert loaded == prebuilt
    else:
        assert loaded.parent == _build.BUILD_DIR / "native" and loaded.name.startswith("navigation_")
    got, want = replay(nav, SCRIPTS["pan_scroll"]), replay(JaxNav(), SCRIPTS["pan_scroll"])
    assert len(got) == len(want) > 0
    for (pg, vg), (pw, vw) in zip(got, want):
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_array_equal(vg, vw)


# ---- tests/test_interact.py's controller and session cases, on both packages ----

@pytest.mark.parametrize("pkg", PACKAGES)
def test_drag_decays(pkg):
    nav = interact(pkg).NavigationController().configure()
    nav.set_pose(distance=2.0)
    nav.mouse_drag(0.1, 0.0)
    az = []
    for _ in range(40):
        nav.step(1 / 60)
        az.append(nav.pose()[0])
    assert az[-1] > 0
    assert abs(az[-1] - az[-2]) < 0.1 * abs(az[1] - az[0])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_gamepad_deadzone(pkg):
    nav = interact(pkg).NavigationController().configure(deadzone=0.3)
    nav.set_pose()
    nav.gamepad(lx=0.2)
    nav.step(1 / 60)
    assert nav.pose()[0] == 0.0
    nav.gamepad(lx=0.9)
    nav.step(1 / 60)
    assert nav.pose()[0] != 0.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_elevation_clamped(pkg):
    nav = interact(pkg).NavigationController().configure()
    nav.set_pose()
    for _ in range(100):
        nav.mouse_drag(0.0, 0.5)
        nav.step(1 / 30)
    assert abs(nav.pose()[1]) <= 1.56


@pytest.mark.parametrize("pkg", PACKAGES)
def test_view_matrix_orthonormal(pkg):
    nav = interact(pkg).NavigationController().configure()
    nav.set_pose(azimuth=0.7, elevation=0.4, distance=3.0, target=(0.1, 0.2, 0.3))
    R = nav.view_matrix()[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_session_frames_move_with_input(pkg):
    sess = interact(pkg).InteractiveSession(render_fn(pkg), CFGS[pkg], **session_kwargs(pkg))
    sess.nav.set_pose(azimuth=0.3, elevation=0.3, distance=2.0, target=(0, 0.2, 0))
    frames = sess.run([lambda n: n.mouse_drag(0.1, 0.0)] * 3 + [None] * 2)
    assert len(frames) == 5 and all(isinstance(f, np.ndarray) and f.shape == (32, 48, 3) for f in frames)
    assert np.abs(frames[0] - frames[-1]).max() > 1e-3
    assert len(sess.stats) == 5 and sess.stats[0].rays_per_second > 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_session_writes_frames(pkg, tmp_path):
    sess = interact(pkg).InteractiveSession(render_fn(pkg), CFGS[pkg], **session_kwargs(pkg))
    sess.nav.set_pose(distance=2.0, target=(0, 0.2, 0))
    sess.run([None, None], out_dir=str(tmp_path))
    assert (tmp_path / "frame_00000.png").exists() and (tmp_path / "frame_00001.png").exists()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_turntable(pkg, tmp_path):
    frames = interact(pkg).render_turntable(render_fn(pkg), CFGS[pkg], n_frames=4, out_dir=str(tmp_path),
                                            **session_kwargs(pkg))
    assert len(frames) == 4 and (tmp_path / "frame_00003.png").exists()
    assert np.abs(frames[0] - frames[2]).max() > 1e-3


@needs_native
def test_session_script_through_both_packages():
    """One gesture script at 48×32 through both packages' sessions: the
    cameras within 1e-6 (the same native controller, the same numpy pose
    math), the frames within ``utils/parity.py``'s image bar (JAX's render
    against the port's render kernel's plain version)."""
    script = ([lambda n: n.mouse_drag(0.06, 0.02)] * 2 + [None, lambda n: n.mouse_drag(0.02, -0.01, pan=True),
              lambda n: n.scroll(0.6), lambda n: n.gamepad(0.7, 0.0, 0.0, 0.5, 0.0), None,
              lambda n: n.mouse_drag(-0.1, 0.05)])
    sessions, cams = {}, {}
    for pkg in PACKAGES:
        sess = interact(pkg).InteractiveSession(render_fn(pkg), CFGS[pkg], **session_kwargs(pkg))
        sess.nav.set_pose(azimuth=0.3, elevation=0.25, distance=2.2, target=(0.0, 0.2, 0.0))
        seen = []
        fn = sess.render_fn
        sess.render_fn = lambda cam, fn=fn, seen=seen: seen.append(cam) or fn(cam)
        sessions[pkg], cams[pkg] = sess.run(script), seen
    assert len(cams["sdf3d_tpu"]) == len(cams["sdf3d_tpu_torch"]) == len(script)
    for cj, ct in zip(cams["sdf3d_tpu"], cams["sdf3d_tpu_torch"]):
        for f in ("position", "c2w", "fov_deg"):
            np.testing.assert_allclose(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), rtol=0, atol=1e-6)
    for k, (want, got) in enumerate(zip(sessions["sdf3d_tpu"], sessions["sdf3d_tpu_torch"])):
        check_pixel_budget(got, np.asarray(want), f"frame {k}", channel_axis=-1)
    assert np.abs(sessions["sdf3d_tpu_torch"][0] - sessions["sdf3d_tpu_torch"][-1]).max() > 1e-3


def test_session_camera_on_the_sessions_device():
    sess = InteractiveSession(lambda cam: np.zeros((2, 2, 3), np.float32), CFGS["sdf3d_tpu_torch"], device="cpu")
    cam = sess.camera()
    assert all(getattr(cam, f).device.type == "cpu" and getattr(cam, f).dtype == torch.float32
               for f in ("position", "c2w", "fov_deg"))
    # The default is the card: without one the first camera fails loudly.
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            InteractiveSession(lambda cam: None, CFGS["sdf3d_tpu_torch"]).camera()


# ---- tests/test_devices.py's cases, on both packages ----

def _js(value, etype, number, t=0):
    return struct.pack("<IhBB", t, value, etype, number)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_joystick_parses_axis_and_button_events(pkg):
    dv = devices(pkg)
    data = (_js(32767, dv._JS_EVENT_AXIS, 0) + _js(-16384, dv._JS_EVENT_AXIS, 1) + _js(1, dv._JS_EVENT_BUTTON, 3)
            + _js(8192, dv._JS_EVENT_AXIS | dv._JS_EVENT_INIT, 3))
    js = dv.JoystickReader(fileobj=io.BytesIO(data))
    assert js.poll() == 4
    assert js.axes[0] == 1.0 and js.axes[1] == float(np.float64(-16384) / 32767.0) and js.buttons[3] is True
    lx, ly, rx, ry, zoom = js.state()
    assert lx == 1.0 and rx == js.axes[3] and zoom == 0.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_joystick_trigger_zoom(pkg):
    dv = devices(pkg)
    js = dv.JoystickReader(fileobj=io.BytesIO(_js(32767, dv._JS_EVENT_AXIS, 5) + _js(-32767, dv._JS_EVENT_AXIS, 2)))
    js.poll()
    assert js.state()[-1] == 1.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_joystick_moves_camera_through_deadzone_filter(pkg):
    dv = devices(pkg)
    nav = interact(pkg).NavigationController().configure()
    p0 = nav.pose()
    dv.JoystickReader(fileobj=io.BytesIO(_js(32767, dv._JS_EVENT_AXIS, 0))).apply(nav)
    for _ in range(8):
        nav.step(1 / 30)
    assert nav.pose()[0] != p0[0]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_joystick_below_deadzone_is_filtered(pkg):
    dv = devices(pkg)
    nav = interact(pkg).NavigationController().configure()
    dv.JoystickReader(fileobj=io.BytesIO(_js(int(0.2 * 32767), dv._JS_EVENT_AXIS, 0))).apply(nav)
    for _ in range(8):
        nav.step(1 / 30)
    az, el, _, _ = nav.pose()
    assert az == 0.0 and el == 0.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_apply_key_bindings(pkg):
    dv = devices(pkg)
    nav = interact(pkg).NavigationController().configure()
    assert dv.apply_key(nav, "d") and dv.apply_key(nav, "arrowup") and dv.apply_key(nav, "-")
    assert not dv.apply_key(nav, "q")
    for _ in range(8):
        nav.step(1 / 30)
    az, el, dist, target = nav.pose()
    assert az != 0.0 and dist > 2.0 and tuple(target) != (0.0, 0.0, 0.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_keyboard_reader_decodes_escape_sequences(pkg):
    assert devices(pkg).KeyboardReader(fileobj=io.StringIO("a\x1b[Cz+")).keys() == ["a", "arrowright", "z", "+"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_keyboard_reader_apply_counts_bound_keys(pkg):
    nav = interact(pkg).NavigationController().configure()
    assert devices(pkg).KeyboardReader(fileobj=io.StringIO("wq\x1b[D")).apply(nav) == 2


def test_key_bindings_are_the_jax_packages():
    import sdf3d_tpu.interact.devices as jd
    import sdf3d_tpu_torch.interact.devices as td

    assert td.KEY_BINDINGS == jd.KEY_BINDINGS and td.DEFAULT_AXIS_MAP == jd.DEFAULT_AXIS_MAP
    assert td._ESCAPES == jd._ESCAPES


@pytest.mark.parametrize("example", ["live_view", "turntable"])
def test_examples_run_on_the_cpu(example, tmp_path, capsys):
    """The two entry points with ``--device cpu`` (the kernel's plain
    version): ``live_view`` serves 2 frames on a free port and stops,
    ``turntable`` writes its PNG frames."""
    import importlib

    mod = importlib.import_module(f"sdf3d_tpu_torch.examples.{example}")
    if example == "live_view":
        argv = ["--device", "cpu", "--frames", "2", "--width", "32", "--height", "24", "--port", "0"]
    else:
        argv = ["--device", "cpu", "--frames", "2", "--scene", "reference", "--out", str(tmp_path)]
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    if example == "live_view":
        assert "live viewer: http://127.0.0.1:" in out and "frames 2," in out and "launches 0" in out
    else:
        assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_00000.png", "frame_00001.png"]
