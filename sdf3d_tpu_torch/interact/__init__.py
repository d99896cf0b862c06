"""Interactive runtime: native navigation controller + headless frame loop
(the port of ``sdf3d_tpu/interact``).

The reference's interactivity lives in the external Neutrino C++ runtime
(window, arcball, gamepad — its ``main.cpp:87-98``).  Here the same
capability is a headless session: a native C++ navigation controller (event
filtering + view-matrix synthesis, ``native_src/navigation.cpp``) driving
the render kernel K1 on the card, frames going to PNG sinks or a browser
(``viewer.LiveViewer``) instead of a swapchain.
"""

from sdf3d_tpu_torch.interact.controller import NavigationController, navigation_available
from sdf3d_tpu_torch.interact.app import InteractiveSession, render_turntable
from sdf3d_tpu_torch.interact.devices import JoystickReader, KeyboardReader, apply_key

__all__ = [
    "NavigationController",
    "navigation_available",
    "InteractiveSession",
    "render_turntable",
    "JoystickReader",
    "KeyboardReader",
    "apply_key",
]
