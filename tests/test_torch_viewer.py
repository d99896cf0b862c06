"""The port's live viewer (``sdf3d_tpu_torch/interact/viewer.py``): the JAX
cases of ``tests/test_viewer.py`` on both packages, driven with urllib as
the page's script drives it, and the port's own: the served PNG is the
session's frame, and the HTTP threads never call into torch."""

import dataclasses
import importlib
import io
import json
import struct
import threading
import urllib.request
import zlib

import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt

PACKAGES = ("sdf3d_tpu", "sdf3d_tpu_torch")


def _make_viewer(pkg):
    app = importlib.import_module(f"{pkg}.interact.app")
    viewer_mod = importlib.import_module(f"{pkg}.interact.viewer")
    cfg = dataclasses.replace((s if pkg == "sdf3d_tpu" else tt).REFERENCE_CONFIG, width=32, height=24)
    calls = []

    def render_fn(cam):
        calls.append(np.asarray(cam.position))
        # A cheap deterministic "render": a gradient keyed on the camera's x.
        base = float(np.asarray(cam.position)[0])
        img = np.zeros((24, 32, 3), np.float32)
        img[..., 0] = np.linspace(0, 1, 32)[None, :] + base
        return torch.from_numpy(img) if pkg == "sdf3d_tpu_torch" else img

    kwargs = {"device": "cpu"} if pkg == "sdf3d_tpu_torch" else {}
    session = app.InteractiveSession(render_fn, cfg, **kwargs)
    viewer = viewer_mod.LiveViewer(session, host="127.0.0.1", port=0)
    viewer.start()
    host, port = viewer.address
    return viewer, f"http://{host}:{port}", calls


def _get(url, binary=False):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read() if binary else r.read().decode()


def _post(base, ev):
    req = urllib.request.Request(base + "/event", data=json.dumps(ev).encode(), method="POST")
    urllib.request.urlopen(req, timeout=10).read()


def decode_png(png: bytes) -> np.ndarray:
    """An 8-bit RGB PNG of ``utils/image_io.encode_png`` (filter 0 rows) as
    an (H, W, 3) uint8 array."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        n, tag = struct.unpack(">I4s", png[pos:pos + 8])
        body = png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_viewer_serves_page_frames_and_stats(pkg):
    viewer, base, calls = _make_viewer(pkg)
    try:
        page = _get(base + "/")
        assert "/stream" in page and "mousedown" in page
        viewer.step()
        assert _get(base + "/frame.png", binary=True).startswith(b"\x89PNG\r\n\x1a\n")
        stats = json.loads(_get(base + "/stats"))
        assert stats["frame"] == 0 and stats["rays_per_second"] > 0
    finally:
        viewer.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("events", [
    ({"type": "drag", "dx": 0.4, "dy": 0.0}, {"type": "scroll", "amount": 1.0}),
    ({"type": "key", "key": "d"}, {"type": "gamepad", "lx": 0.9, "ly": 0.0, "rx": 0.0, "ry": 0.0, "zoom": 0.0}),
], ids=["drag_scroll", "key_gamepad"])
def test_viewer_events_drive_navigation(pkg, events):
    viewer, base, calls = _make_viewer(pkg)
    try:
        viewer.step()
        p0 = calls[-1].copy()
        for ev in events:
            _post(base, ev)
        for _ in range(8):
            viewer.step(dt=1 / 30)
        assert not np.allclose(p0, calls[-1]), "navigation events did not move the camera"
    finally:
        viewer.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_viewer_stats_history_and_metrics(pkg):
    viewer, base, calls = _make_viewer(pkg)
    try:
        for _ in range(5):
            viewer.step()
        viewer.push_metric("loss", 3.0)
        viewer.push_metric("loss", 1.5)
        stats = json.loads(_get(base + "/stats"))
        assert len(stats["history"]["rays_per_second"]) == 5 and stats["metrics"]["loss"] == [3.0, 1.5]
        page = _get(base + "/")
        assert "canvas" in page and "getGamepads" in page and "keydown" in page
    finally:
        viewer.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_viewer_local_device_reader_polled_per_frame(pkg):
    dv = importlib.import_module(f"{pkg}.interact.devices")
    viewer, base, calls = _make_viewer(pkg)
    try:
        viewer.step()
        p0 = calls[-1].copy()
        viewer.device_readers.append(dv.JoystickReader(fileobj=io.BytesIO(
            struct.pack("<IhBB", 0, 32767, dv._JS_EVENT_AXIS, 0))))
        for _ in range(8):
            viewer.step(dt=1 / 30)
        assert not np.allclose(p0, calls[-1]), "local joystick did not move the camera"
    finally:
        viewer.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_viewer_stream_yields_multipart_frames(pkg):
    viewer, base, calls = _make_viewer(pkg)
    try:
        viewer.step()
        got = {}

        def reader():
            req = urllib.request.urlopen(base + "/stream", timeout=10)
            got["head"] = req.headers.get("Content-Type", "")
            got["chunk"] = req.read(64)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for _ in range(20):
            viewer.step()
            t.join(timeout=0.05)
            if not t.is_alive():
                break
        assert "multipart/x-mixed-replace" in got.get("head", "")
        assert b"--frame" in got.get("chunk", b"") and b"image/png" in got["chunk"]
    finally:
        viewer.stop()


def test_served_frame_is_the_sessions_frame():
    """``GET /frame.png`` decodes to the frame ``step()`` returned (8-bit,
    as ``to_uint8`` rounds it), and the pages of both packages are one."""
    from sdf3d_tpu.interact import viewer as jax_viewer
    from sdf3d_tpu_torch.interact import viewer as port_viewer
    from sdf3d_tpu_torch.utils.image_io import to_uint8

    viewer, base, calls = _make_viewer("sdf3d_tpu_torch")
    try:
        _post(base, {"type": "drag", "dx": 0.3, "dy": 0.1})
        for _ in range(3):
            img = viewer.step()
        assert isinstance(img, np.ndarray) and img.dtype == np.float32
        np.testing.assert_array_equal(decode_png(_get(base + "/frame.png", binary=True)), to_uint8(img))
        assert json.loads(_get(base + "/stats"))["frame"] == 2
    finally:
        viewer.stop()
    assert port_viewer._PAGE.replace("sdf3d_tpu_torch live", "sdf3d-tpu live") == jax_viewer._PAGE


def test_http_threads_never_call_torch():
    """The threading rule: only the thread that calls ``step`` renders, so
    every render call comes from the test's thread while the server's
    threads answer requests."""
    viewer, base, calls = _make_viewer("sdf3d_tpu_torch")
    threads = []
    fn = viewer.session.render_fn
    viewer.session.render_fn = lambda cam: threads.append(threading.get_ident()) or fn(cam)
    try:
        for _ in range(3):
            _post(base, {"type": "pan", "dx": 0.1, "dy": 0.0})
            viewer.step()
            _get(base + "/frame.png", binary=True)
            _get(base + "/stats")
        assert set(threads) == {threading.get_ident()} and len(threads) == 3
    finally:
        viewer.stop()


def test_stop_without_start_returns():
    from sdf3d_tpu_torch.interact.app import InteractiveSession
    from sdf3d_tpu_torch.interact.viewer import LiveViewer

    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=8, height=8)
    viewer = LiveViewer(InteractiveSession(lambda cam: np.zeros((8, 8, 3), np.float32), cfg, device="cpu"), port=0)
    done = threading.Event()
    t = threading.Thread(target=lambda: (viewer.stop(), done.set()), daemon=True)
    t.start()
    assert done.wait(5.0), "stop() of a viewer that never started blocked"
