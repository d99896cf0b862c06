"""Live interactive viewer: orbit a scene from a browser (the port of
``examples/live_view.py``).

The reference app's windowed loop (its ``main.cpp:87-98``) on the card:
each frame is one launch of the render kernel K1
(``ops.render_kernel_forward``), streamed to the browser as a multipart PNG
stream, and mouse orbit/pan/zoom come back as JSON events into the native
navigation controller (arcball + low-pass decay) the headless session uses.

    python -m sdf3d_tpu_torch.examples.live_view [--port 8000] [--width 800] [--height 600]
        [--scene reference|flagship|fractal] [--profile fast|parity] [--frames N] [--device cuda|cpu]

then open http://127.0.0.1:8000/ — drag to orbit, shift-drag to pan,
wheel to zoom.  It runs on the card; without one it fails.  ``--device cpu``
renders with the kernel's plain PyTorch version instead, as asked.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


def main(argv=None) -> int:
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.interact.app import InteractiveSession
    from sdf3d_tpu_torch.interact.devices import JoystickReader
    from sdf3d_tpu_torch.interact.viewer import LiveViewer
    from sdf3d_tpu_torch.ops import KernelConfig, render_kernel_forward

    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.examples.live_view", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--scene", default="reference", choices=["reference", "flagship", "fractal"])
    ap.add_argument("--profile", default="fast", choices=["parity", "fast"],
                    help="'fast' (default here: interactivity over parity) = config.fast_config")
    ap.add_argument("--frames", type=int, default=None, help="stop after N frames (default: run until ctrl-C)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the kernel) or 'cpu' (its plain version)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the live viewer renders on the card and no CUDA device is visible "
                           "(--device cpu runs the kernel's plain version)")
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=args.width, height=args.height)
    if args.profile == "fast":
        cfg = tt.fast_config(cfg)
    scene = {"reference": tt.reference_scene, "flagship": tt.flagship_scene,
             "fractal": tt.fractal_scene}[args.scene]().to(dev)
    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    kc = KernelConfig()

    def render(cam):
        return render_kernel_forward(scene, cam, light, mat, cfg, kc, device=dev)[0]

    session = InteractiveSession(render, cfg, device=dev)
    # A physical gamepad plugged into this host drives the loop directly
    # (the browser's Gamepad API covers pads on the viewing machine).
    readers = []
    if JoystickReader.available():
        readers.append(JoystickReader())
        print("gamepad: /dev/input/js0 connected", flush=True)
    LiveViewer(session, host=args.host, port=args.port, device_readers=readers).run(max_frames=args.frames)
    if session.stats:
        print(f"frames {session.frame_count}, last {session.stats[-1].seconds * 1e3:.3f} ms, "
              f"launches {render_kernel_forward.launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
