"""Canonical scenes (the port of ``sdf3d_tpu/scenes.py``)."""

from __future__ import annotations

from sdf3d_tpu_torch.sdf import SDFNode, ground_plane, sphere, union


def reference_scene() -> SDFNode:
    """``min(plane_y0, sphere((0, 0.4, 0), r=0.2))``, union order kept:
    parameters ``[0,1,0,0, 0,0.4,0,0.2]``."""
    return union(ground_plane(), sphere(center=(0.0, 0.4, 0.0), radius=0.2))


def sphere_scene() -> SDFNode:
    """Single sphere."""
    return sphere(center=(0.0, 0.4, 0.0), radius=0.2)
