"""Utilities: image output."""

from sdf3d_tpu_torch.utils.image_io import encode_png, to_uint8, write_png, write_ppm

__all__ = ["encode_png", "to_uint8", "write_png", "write_ppm"]
