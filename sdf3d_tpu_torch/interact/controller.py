"""ctypes binding for the native navigation controller (the port of
``sdf3d_tpu/interact/controller.py``).

``native_src/navigation.cpp`` is the JAX package's source, copied byte for
byte, loaded by the port's own loader (``ops/_build.py::load_native``): the
CMake tree's ``libsdf3d_navigation.so`` from ``$SDF3D_NATIVE_DIR`` where it
is there, as the JAX package's loader takes it, else built at first use with
the C++ compiler (the JAX loader's flags, the port's build directory, keyed
by the source's hash), so both packages' controllers give the same floats.
``prefer_native=False`` (or a failed build, which
:func:`navigation_available` reports) selects the pure-Python controller of
the same filter semantics.  The controller is host code: it turns input
events into a 4×4 view matrix that the session turns into a camera.
"""

from __future__ import annotations

import ctypes
import math
import pathlib

import numpy as np

_SRC = pathlib.Path(__file__).parent / "native_src" / "navigation.cpp"
_LIB = None
_BUILD_ERROR = None


def _load():
    global _LIB, _BUILD_ERROR
    if _LIB is not None or _BUILD_ERROR is not None:
        return _LIB
    try:
        from sdf3d_tpu_torch.ops._build import load_native

        lib = load_native(_SRC, prebuilt_name="libsdf3d_navigation.so")
        f = ctypes.c_float
        fp = ctypes.POINTER(f)
        vp = ctypes.c_void_p
        lib.sdf3d_nav_create.restype = vp
        lib.sdf3d_nav_destroy.argtypes = [vp]
        lib.sdf3d_nav_configure.argtypes = [vp, f, f, f, f]
        lib.sdf3d_nav_set_pose.argtypes = [vp, f, f, f, f, f, f]
        lib.sdf3d_nav_mouse_drag.argtypes = [vp, f, f, ctypes.c_int]
        lib.sdf3d_nav_scroll.argtypes = [vp, f]
        lib.sdf3d_nav_gamepad.argtypes = [vp, f, f, f, f, f]
        lib.sdf3d_nav_step.argtypes = [vp, f]
        lib.sdf3d_nav_view_matrix.argtypes = [vp, fp]
        lib.sdf3d_nav_get_pose.argtypes = [vp, fp]
        _LIB = lib
    except Exception as e:  # pragma: no cover - environment-dependent
        _BUILD_ERROR = e
    return _LIB


def navigation_available() -> bool:
    """True when the native controller compiled and loaded."""
    return _load() is not None


def navigation_error() -> Exception | None:
    """Why the native controller is not available (its build or load
    error), or None."""
    _load()
    return _BUILD_ERROR


class _PyController:
    """Pure-Python fallback with the same filter semantics as navigation.cpp."""

    def __init__(self):
        self.azimuth = 0.0
        self.elevation = 0.0
        self.distance = 2.0
        self.target = np.zeros(3, np.float32)
        self.v = np.zeros(3, np.float32)  # az, el, dist
        self.v_pan = np.zeros(2, np.float32)
        self.orbit_rate, self.pan_rate, self.decay, self.deadzone = 1.0, 5.0, 1.25, 0.30

    def configure(self, orbit_rate, pan_rate, decay, deadzone):
        self.orbit_rate, self.pan_rate, self.decay, self.deadzone = orbit_rate, pan_rate, decay, deadzone

    def set_pose(self, az, el, dist, target):
        self.azimuth, self.elevation, self.distance = az, el, dist
        self.target = np.asarray(target, np.float32).copy()
        self.v[:] = 0
        self.v_pan[:] = 0

    def mouse_drag(self, dx, dy, pan=False):
        if pan:
            self.v_pan += np.float32([self.pan_rate * dx, self.pan_rate * dy])
        else:
            self.v[0] += self.orbit_rate * dx * math.pi
            self.v[1] += self.orbit_rate * dy * math.pi

    def scroll(self, amount):
        self.v[2] -= amount

    def _dz(self, x):
        a = abs(x)
        if a < self.deadzone:
            return 0.0
        s = (a - self.deadzone) / (1.0 - self.deadzone)
        return -s if x < 0 else s

    def gamepad(self, lx, ly, rx, ry, zoom):
        self.v[0] += self.orbit_rate * self._dz(lx)
        self.v[1] += self.orbit_rate * self._dz(ly)
        self.v_pan += np.float32([self.pan_rate * 0.2 * self._dz(rx), self.pan_rate * 0.2 * self._dz(ry)])
        self.v[2] += self._dz(zoom)

    def step(self, dt):
        self.azimuth += self.v[0] * dt
        self.elevation = float(np.clip(self.elevation + self.v[1] * dt, -1.55, 1.55))
        self.distance = max(self.distance * math.exp(self.v[2] * dt), 0.05)
        ca, sa = math.cos(self.azimuth), math.sin(self.azimuth)
        ce, se = math.cos(self.elevation), math.sin(self.elevation)
        eye_dir = np.float32([ce * sa, se, ce * ca])
        fwd = -eye_dir
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= max(np.linalg.norm(right), 1e-12)
        up = np.cross(right, fwd)
        self.target = self.target + (self.v_pan[0] * dt * self.distance) * right + (
            self.v_pan[1] * dt * self.distance
        ) * up
        k = math.exp(-self.decay * dt * 10.0)
        self.v *= k
        self.v_pan *= k

    def pose(self):
        return (self.azimuth, self.elevation, self.distance, tuple(self.target.tolist()))

    def view_matrix(self):
        ca, sa = math.cos(self.azimuth), math.sin(self.azimuth)
        ce, se = math.cos(self.elevation), math.sin(self.elevation)
        eye = self.target + self.distance * np.float32([ce * sa, se, ce * ca])
        fwd = self.target - eye
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right = right / max(np.linalg.norm(right), 1e-12)
        up = np.cross(right, fwd)
        V = np.eye(4, dtype=np.float32)
        V[0, :3], V[0, 3] = right, -np.dot(right, eye)
        V[1, :3], V[1, 3] = up, -np.dot(up, eye)
        V[2, :3], V[2, 3] = -fwd, np.dot(fwd, eye)
        return V


class NavigationController:
    """Arcball orbit/pan/zoom with low-pass decay (native C++ when available).

    Usage per frame (the reference's ``mouse_navigation`` /
    ``gamepad_navigation`` pattern, ``main.cpp:93-94``):

    >>> nav = NavigationController()
    >>> nav.mouse_drag(0.02, 0.0)      # events since last frame
    >>> nav.step(1 / 60)               # advance + decay filters
    >>> V = nav.view_matrix()          # InteractiveSession.camera() inverts it
    """

    def __init__(self, prefer_native: bool = True):
        self._native = prefer_native and navigation_available()
        if self._native:
            self._lib = _load()
            self._h = self._lib.sdf3d_nav_create()
        else:
            self._py = _PyController()

    def __del__(self):
        if getattr(self, "_native", False) and getattr(self, "_h", None):
            self._lib.sdf3d_nav_destroy(self._h)
            self._h = None

    @property
    def is_native(self) -> bool:
        return self._native

    def configure(self, orbit_rate=1.0, pan_rate=5.0, decay=1.25, deadzone=0.30):
        """Reference tuning defaults (``main.cpp:37-45,93-94``)."""
        if self._native:
            self._lib.sdf3d_nav_configure(self._h, orbit_rate, pan_rate, decay, deadzone)
        else:
            self._py.configure(orbit_rate, pan_rate, decay, deadzone)
        return self

    def set_pose(self, azimuth=0.0, elevation=0.0, distance=2.0, target=(0.0, 0.0, 0.0)):
        if self._native:
            self._lib.sdf3d_nav_set_pose(self._h, azimuth, elevation, distance, *map(float, target))
        else:
            self._py.set_pose(azimuth, elevation, distance, target)
        return self

    def mouse_drag(self, dx: float, dy: float, pan: bool = False):
        if self._native:
            self._lib.sdf3d_nav_mouse_drag(self._h, dx, dy, int(pan))
        else:
            self._py.mouse_drag(dx, dy, pan)

    def scroll(self, amount: float):
        if self._native:
            self._lib.sdf3d_nav_scroll(self._h, amount)
        else:
            self._py.scroll(amount)

    def gamepad(self, lx=0.0, ly=0.0, rx=0.0, ry=0.0, zoom=0.0):
        if self._native:
            self._lib.sdf3d_nav_gamepad(self._h, lx, ly, rx, ry, zoom)
        else:
            self._py.gamepad(lx, ly, rx, ry, zoom)

    def step(self, dt: float):
        if self._native:
            self._lib.sdf3d_nav_step(self._h, dt)
        else:
            self._py.step(dt)

    def view_matrix(self) -> np.ndarray:
        if self._native:
            out = np.empty(16, np.float32)
            self._lib.sdf3d_nav_view_matrix(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return out.reshape(4, 4)
        return self._py.view_matrix()

    def pose(self):
        """(azimuth, elevation, distance, target) — for tests/telemetry."""
        if self._native:
            out = np.empty(6, np.float32)
            self._lib.sdf3d_nav_get_pose(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return (float(out[0]), float(out[1]), float(out[2]), tuple(out[3:6].tolist()))
        return self._py.pose()
