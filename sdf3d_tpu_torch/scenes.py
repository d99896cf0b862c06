"""Canonical scenes (the port of ``sdf3d_tpu/scenes.py``)."""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.sdf import (
    SDFNode,
    box,
    capsule,
    cylinder,
    ground_plane,
    mandelbulb,
    onion,
    repeat_infinite,
    round_box,
    smooth_union,
    sphere,
    subtraction,
    torus,
    union,
)


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


def materials_scene() -> SDFNode:
    """The flagship's geometry with per-object materials (``Shaded``): a
    gold blob, a red rounded box, a teal torus and a warm grey floor, the
    blob and the box blended by the smooth union, so their seam shades with
    a blended material.  61 parameters: the flagship's 21 and 10 material
    channels for each of the four tags."""
    from sdf3d_tpu_torch.lighting import material
    from sdf3d_tpu_torch.sdf.materials import shaded

    floor = shaded(ground_plane(),
                   material(ambient=(0.12, 0.11, 0.10), diffuse=(0.45, 0.42, 0.38), specular=(0.1, 0.1, 0.1)))
    blob = shaded(sphere(center=(-0.25, 0.4, 0.0), radius=0.22),
                  material(ambient=(0.2, 0.15, 0.02), diffuse=(0.85, 0.65, 0.13), specular=(0.9, 0.8, 0.4),
                           shininess=48.0))
    cube = shaded(round_box(half_extents=(0.2, 0.2, 0.2), corner_radius=0.03, center=(0.25, 0.3, 0.0)),
                  material(ambient=(0.2, 0.02, 0.02), diffuse=(0.8, 0.1, 0.1)))
    ring = shaded(torus(major=0.45, minor=0.06, center=(0.0, 0.12, 0.35)),
                  material(ambient=(0.02, 0.15, 0.15), diffuse=(0.1, 0.7, 0.7), specular=(0.6, 0.6, 0.6),
                           shininess=24.0))
    return union(floor, smooth_union(blob, cube, k=0.15), ring)


def sphere_scene() -> SDFNode:
    """Single sphere."""
    return sphere(center=(0.0, 0.4, 0.0), radius=0.2)


def csg_showcase() -> SDFNode:
    """Hard and smooth CSG sampler: a box carved by a sphere, a shelled
    sphere cut by a box, a cylinder blended into a sphere (a pillar), on the
    ground plane.  Its bare box and cylinder have no guard on their outside
    length, so a reverse-pass tap in their cores gives NaN gradients, as in
    the JAX package (ROADMAP Queue 3)."""
    carved = subtraction(
        box(half_extents=(0.25, 0.25, 0.25), center=(-0.6, 0.3, 0.0)),
        sphere(center=(-0.6, 0.45, 0.2), radius=0.22),
    )
    shell = onion(sphere(center=(0.0, 0.35, 0.0), radius=0.25), 0.02) & box(
        half_extents=(0.3, 0.18, 0.3), center=(0.0, 0.22, 0.0)
    )
    pillar = smooth_union(
        cylinder(radius=0.1, half_height=0.3, center=(0.6, 0.3, 0.0)),
        sphere(center=(0.6, 0.65, 0.0), radius=0.15),
        k=0.1,
    )
    return union(ground_plane(), carved, shell, pillar)


def lattice_scene(period: float = 1.2, radius: float = 0.18) -> SDFNode:
    """An infinite xz lattice of spheres over the ground plane: the
    march-depth stress scene (many occluders, long shadow rays)."""
    field = repeat_infinite(sphere(center=(0.0, 0.35, 0.0), radius=radius), (period, 0.0, period))
    return union(ground_plane(), field)


def fractal_scene(iterations: int = 6) -> SDFNode:
    """A power-8 Mandelbulb over the ground plane: the eval-dominated stress
    scene (about 300 operations an evaluation against the reference scene's
    10), where a step's cost dwarfs the march's bookkeeping."""
    return union(ground_plane(), mandelbulb(center=(0.0, 0.55, 0.0), scale=0.45, iterations=iterations))


def capsule_chain(n: int = 5) -> SDFNode:
    """A smooth-blended chain of ``n`` capsules on the ground plane: a deep
    CSG tree (2n + 1 nodes) for scene-compiler and march scaling."""
    out = None
    for i in range(n):
        a = (-0.6 + 1.2 * i / max(n - 1, 1), 0.25 + 0.12 * (i % 2), 0.0)
        b = (-0.6 + 1.2 * (i + 0.7) / max(n - 1, 1), 0.3, 0.1)
        link = capsule(a, b, 0.08)
        out = link if out is None else smooth_union(out, link, k=0.08)
    return union(ground_plane(), out)


def random_blobs(generator: torch.Generator | None = None, n: int = 8, seed: int = 0, centers=None,
                 radii=None) -> SDFNode:
    """``n`` randomly placed spheres, smooth-blended (k = 0.12) on the ground
    plane: the parameterisable workload of the scene-cost sweep (the
    distance's cost grows linearly with ``n``).

    Centers are uniform in [-0.6, 0.6]³ scaled by (1, 0.4, 1) and lifted by
    0.45 in y, radii uniform in [0.08, 0.2], drawn from ``generator`` (a CPU
    ``torch.Generator``; seeded from ``seed`` when None), or given as
    ``centers`` (n, 3) and ``radii`` (n,).  The JAX package draws from
    ``jax.random``, so ``random_blobs(n=n, seed=s)`` gives other spheres than
    its namesake for the same seed, with the same structure; hand both the
    same ``centers`` and ``radii`` to build the same scene."""
    if centers is None or radii is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        u = torch.rand((n, 3), generator=generator) * 1.2 - 0.6
        centers = u * torch.tensor([1.0, 0.4, 1.0]) + torch.tensor([0.0, 0.45, 0.0])
        radii = torch.rand((n,), generator=generator) * 0.12 + 0.08
    centers = torch.as_tensor(centers, dtype=torch.float32).reshape(-1, 3)
    radii = torch.as_tensor(radii, dtype=torch.float32).reshape(-1)
    out = None
    for c, r in zip(centers, radii):
        s_i = sphere(center=c, radius=r)
        out = s_i if out is None else smooth_union(out, s_i, k=0.12)
    return union(ground_plane(), out)
