"""Canonical scenes (the port of ``sdf3d_tpu/scenes.py``)."""

from __future__ import annotations

from sdf3d_tpu_torch.sdf import SDFNode, ground_plane, round_box, smooth_union, sphere, torus, union


def reference_scene() -> SDFNode:
    """``min(plane_y0, sphere((0, 0.4, 0), r=0.2))``, union order kept:
    parameters ``[0,1,0,0, 0,0.4,0,0.2]``."""
    return union(ground_plane(), sphere(center=(0.0, 0.4, 0.0), radius=0.2))


def flagship_scene() -> SDFNode:
    """The headline CSG scene (the JAX package's BASELINE config 2): a sphere
    and a rounded box blended by a smooth union (k = 0.15), and a torus, on
    the ground plane; the sphere, box, plane, min and smooth-min CSG of the
    north star.  21 parameters: plane 4, sphere 4, rounded box 7 (center,
    half extents, corner radius), k 1, torus 5."""
    blob = smooth_union(
        sphere(center=(-0.25, 0.4, 0.0), radius=0.22),
        round_box(half_extents=(0.2, 0.2, 0.2), corner_radius=0.03, center=(0.25, 0.3, 0.0)),
        k=0.15,
    )
    ring = torus(major=0.45, minor=0.06, center=(0.0, 0.12, 0.35))
    return union(ground_plane(), blob, ring)


def sphere_scene() -> SDFNode:
    """Single sphere."""
    return sphere(center=(0.0, 0.4, 0.0), radius=0.2)
