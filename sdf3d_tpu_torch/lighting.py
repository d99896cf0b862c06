"""Point light and Blinn-Phong material (the port of ``sdf3d_tpu/lighting.py``).

Plain dataclasses of float32 tensors.  ``PointLight.color`` is carried but,
as in the reference shader, never used in shading.
"""

from __future__ import annotations

import dataclasses

import torch

from sdf3d_tpu_torch.sdf.node import as_f32, tensors_to


@dataclasses.dataclass
class PointLight:
    position: torch.Tensor  # (3,)
    color: torch.Tensor  # (3,)
    ambient: torch.Tensor  # ()

    def to(self, device) -> "PointLight":
        return tensors_to(self, device)


@dataclasses.dataclass
class Material:
    ambient: torch.Tensor  # (3,)
    diffuse: torch.Tensor  # (3,)
    specular: torch.Tensor  # (3,)
    shininess: torch.Tensor  # ()

    def to(self, device) -> "Material":
        return tensors_to(self, device)


def point_light(position=(5.0, 5.0, 0.0), color=(0.7, 0.7, 0.7), ambient=0.1, device=None) -> PointLight:
    return PointLight(as_f32(position, device), as_f32(color, device), as_f32(ambient, device))


def material(ambient=(0.0, 0.2, 0.8), diffuse=(0.0, 0.2, 0.8), specular=(0.5, 0.5, 0.5), shininess=12.0, device=None) -> Material:
    return Material(
        as_f32(ambient, device), as_f32(diffuse, device), as_f32(specular, device), as_f32(shininess, device)
    )


def reference_light(device=None) -> PointLight:
    """The reference's light: position (5, 5, 0), ambient 0.1."""
    return point_light(device=device)


def reference_material(device=None) -> Material:
    """The reference's blue material."""
    return material(device=device)
