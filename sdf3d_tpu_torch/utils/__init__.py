"""Utilities: image output and metrics logging."""

from sdf3d_tpu_torch.utils.image_io import encode_png, to_uint8, write_png, write_ppm
from sdf3d_tpu_torch.utils.logging import MetricsLogger

__all__ = ["MetricsLogger", "encode_png", "to_uint8", "write_png", "write_ppm"]
