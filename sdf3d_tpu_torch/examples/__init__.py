"""Entry points of the JAX package's example scripts (``examples/``), one
module each: ``python -m sdf3d_tpu_torch.examples.<name>`` for ``live_view``,
``turntable``, ``inverse_fit``, ``pose_fit``, ``render_gallery``,
``neural_sdf``, ``grid_fit`` and ``sharded_render`` (``README.md`` here)."""
