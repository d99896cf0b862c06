"""Physical input devices → navigation events (a copy of
``sdf3d_tpu/interact/devices.py``, which uses the standard library only).

The reference reads live gamepads through GLFW every frame (its
``main.cpp:94`` → Neutrino's ``gamepad_navigation``) and mouse buttons
through the window system.  On a headless GPU server there is no GLFW; the
native device surfaces are:

- **Linux joystick API** (``/dev/input/js*``): :class:`JoystickReader`
  parses the kernel's 8-byte ``js_event`` records non-blockingly and feeds
  stick axes into :meth:`NavigationController.gamepad` (whose native filter
  applies the reference's 30% deadzone, ``navigation.cpp``).
- **Terminal keyboard**: :class:`KeyboardReader` puts the controlling tty in
  cbreak mode and maps keys to orbit/pan/zoom impulses (:func:`apply_key` is
  the pure mapping, usable without a tty).
- The **browser Gamepad API** path lives in viewer.py: the page polls
  ``navigator.getGamepads()`` per frame and POSTs ``{"type": "gamepad"}``
  events — a real physical gamepad reaches the render loop through the same
  queue.

All three converge on the one per-frame pattern the reference uses
(``poll events → navigate → render``): call ``reader.apply(nav)`` before
``nav.step(dt)``.
"""

from __future__ import annotations

import os
import struct
import sys
from typing import IO

# Linux kernel joystick API (linux/joystick.h): 8-byte records
#   __u32 time (ms), __s16 value, __u8 type, __u8 number
_JS_EVENT = struct.Struct("<IhBB")
_JS_EVENT_BUTTON = 0x01
_JS_EVENT_AXIS = 0x02
_JS_EVENT_INIT = 0x80
_AXIS_MAX = 32767.0

#: Default axis map (the de-facto standard layout: Xbox-style pads under the
#: Linux xpad module): left stick = axes 0/1 (orbit), right stick = 3/4 (pan),
#: right trigger − left trigger = zoom (axes 5/2, idle at −1).
DEFAULT_AXIS_MAP = {
    "lx": 0,
    "ly": 1,
    "rx": 3,
    "ry": 4,
    "zoom_in": 5,
    "zoom_out": 2,
}


class JoystickReader:
    """Non-blocking reader for a Linux joystick device.

    >>> js = JoystickReader()            # /dev/input/js0
    >>> while running:
    ...     js.apply(nav)                # drain events -> nav.gamepad(...)
    ...     nav.step(dt); render(...)

    ``fileobj`` lets tests (or alternative transports) inject a pipe that
    yields raw ``js_event`` records.  Axis values are normalized to [−1, 1];
    the deadzone is applied downstream by the navigation controller exactly
    like the reference's ``gamepad_navigation(..., 0.30)``.
    """

    def __init__(
        self,
        path: str = "/dev/input/js0",
        fileobj: IO[bytes] | None = None,
        axis_map: dict | None = None,
    ):
        self.axis_map = dict(DEFAULT_AXIS_MAP if axis_map is None else axis_map)
        self.axes: dict[int, float] = {}
        self.buttons: dict[int, bool] = {}
        if fileobj is not None:
            self._f = fileobj
            self._fd = None
        else:
            self._fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
            self._f = None

    @staticmethod
    def available(path: str = "/dev/input/js0") -> bool:
        return os.path.exists(path)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def _read_chunk(self) -> bytes:
        if self._f is not None:
            data = self._f.read(_JS_EVENT.size * 64)
            return data or b""
        try:
            return os.read(self._fd, _JS_EVENT.size * 64)
        except BlockingIOError:
            return b""

    def poll(self) -> int:
        """Drain pending kernel events into the axis/button state; returns
        the number of events consumed."""
        n = 0
        while True:
            data = self._read_chunk()
            if not data:
                return n
            for off in range(0, len(data) - _JS_EVENT.size + 1, _JS_EVENT.size):
                _, value, etype, number = _JS_EVENT.unpack_from(data, off)
                etype &= ~_JS_EVENT_INIT  # init events carry current state
                if etype == _JS_EVENT_AXIS:
                    self.axes[number] = value / _AXIS_MAX
                elif etype == _JS_EVENT_BUTTON:
                    self.buttons[number] = bool(value)
                n += 1
            if len(data) < _JS_EVENT.size * 64:
                return n

    def state(self) -> tuple[float, float, float, float, float]:
        """(lx, ly, rx, ry, zoom) from the current axis state."""
        m = self.axis_map
        ax = self.axes.get
        # Triggers idle at -1 and reach +1 fully pressed -> [0, 1] each.
        zin = (ax(m["zoom_in"], -1.0) + 1.0) * 0.5
        zout = (ax(m["zoom_out"], -1.0) + 1.0) * 0.5
        return (
            ax(m["lx"], 0.0),
            ax(m["ly"], 0.0),
            ax(m["rx"], 0.0),
            ax(m["ry"], 0.0),
            zin - zout,
        )

    def apply(self, nav) -> int:
        """Poll the device and feed the stick state into the controller."""
        n = self.poll()
        lx, ly, rx, ry, zoom = self.state()
        nav.gamepad(lx, ly, rx, ry, zoom)
        return n


#: Keyboard → navigation impulse map (per keypress; the controller's
#: low-pass decay smooths repeats into continuous motion).
KEY_BINDINGS = {
    "a": ("drag", -0.05, 0.0),
    "d": ("drag", 0.05, 0.0),
    "w": ("drag", 0.0, -0.05),
    "s": ("drag", 0.0, 0.05),
    "arrowleft": ("pan", -0.02, 0.0),
    "arrowright": ("pan", 0.02, 0.0),
    "arrowup": ("pan", 0.0, -0.02),
    "arrowdown": ("pan", 0.0, 0.02),
    "+": ("zoom", 0.5),
    "=": ("zoom", 0.5),
    "-": ("zoom", -0.5),
}

_ESCAPES = {"\x1b[A": "arrowup", "\x1b[B": "arrowdown", "\x1b[C": "arrowright", "\x1b[D": "arrowleft"}


def apply_key(nav, key: str) -> bool:
    """Apply one (case-insensitive) key to the controller; True if bound.

    The pure mapping shared by the tty reader and the browser page's
    keydown forwarding (viewer.py) — one binding table for every source.
    """
    binding = KEY_BINDINGS.get(key.lower())
    if binding is None:
        return False
    kind = binding[0]
    if kind == "drag":
        nav.mouse_drag(binding[1], binding[2])
    elif kind == "pan":
        nav.mouse_drag(binding[1], binding[2], pan=True)
    else:
        nav.scroll(binding[1])
    return True


class KeyboardReader:
    """Terminal keyboard → navigation events (cbreak tty, non-blocking).

    >>> with KeyboardReader() as kb:
    ...     while running:
    ...         kb.apply(nav); nav.step(dt); render(...)

    ``fileobj`` injects a non-tty byte stream for tests.  Arrow keys arrive
    as 3-byte CSI escapes and are decoded to ``arrowleft`` etc.
    """

    def __init__(self, fileobj: IO | None = None):
        self._f = fileobj if fileobj is not None else sys.stdin
        self._is_tty = fileobj is None and sys.stdin.isatty()
        self._saved = None

    def __enter__(self):
        if self._is_tty:
            import termios
            import tty

            self._saved = termios.tcgetattr(self._f.fileno())
            tty.setcbreak(self._f.fileno())
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(self._f.fileno(), termios.TCSADRAIN, self._saved)
            self._saved = None
        return False

    def _pending(self) -> str:
        import select

        out = []
        fd = self._f.fileno() if self._is_tty else None
        while True:
            if self._is_tty:
                r, _, _ = select.select([fd], [], [], 0)
                if not r:
                    break
                ch = os.read(fd, 1).decode(errors="ignore")
            else:
                ch = self._f.read(1)
                if isinstance(ch, bytes):
                    ch = ch.decode(errors="ignore")
            if not ch:
                break
            out.append(ch)
        return "".join(out)

    def keys(self) -> list[str]:
        """Decode pending bytes into key names (escape-sequence aware)."""
        buf = self._pending()
        keys: list[str] = []
        i = 0
        while i < len(buf):
            matched = False
            for seq, name in _ESCAPES.items():
                if buf.startswith(seq, i):
                    keys.append(name)
                    i += len(seq)
                    matched = True
                    break
            if not matched:
                keys.append(buf[i])
                i += 1
        return keys

    def apply(self, nav) -> int:
        """Apply all pending keys; returns how many were bound."""
        return sum(apply_key(nav, k) for k in self.keys())
