"""Visualization helpers: colormaps for scalar-field debug views (the port of
``sdf3d_tpu/viz``)."""

from sdf3d_tpu_torch.viz.colormap import apply_colormap, turbo, turbo_lut

__all__ = ["turbo", "turbo_lut", "apply_colormap"]
