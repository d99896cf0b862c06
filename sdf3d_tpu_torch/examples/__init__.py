"""Entry points of the interactive path (the port of ``examples/live_view.py``
and ``examples/turntable.py``): ``python -m sdf3d_tpu_torch.examples.live_view``
and ``python -m sdf3d_tpu_torch.examples.turntable``."""
