"""Shading: Blinn-Phong with soft shadows, and Lambert (the port of
``sdf3d_tpu/shade.py``).  Term for term with the reference shader: only the
scalar light intensities modulate the material colours (the light colour is
unused), and there is no miss branch (the caller composites misses)."""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.lighting import Material, PointLight
from sdf3d_tpu_torch.sdf.node import vdot, vnormalize


def blinn_phong(
    points: torch.Tensor,
    normals: torch.Tensor,
    eye: torch.Tensor,
    light: PointLight,
    mat: Material,
    shadow: torch.Tensor,
    ao: torch.Tensor | None = None,
) -> torch.Tensor:
    """``amb·M.amb + clamp(N·I,0,1)·shadow·M.dif + max(N·H,0)^shn·M.ref``,
    RGB of shape ``(..., 3)``; AO scales the ambient term when given."""
    view = vnormalize(eye - points)
    incident = vnormalize(light.position - points)
    halfway = vnormalize(incident + view)
    spec_i = torch.clamp(vdot(normals, halfway), min=0.0) ** mat.shininess
    diff_i = torch.clamp(vdot(normals, incident), 0.0, 1.0) * shadow
    if ao is None:
        ambient = light.ambient * mat.ambient
    else:
        ambient = (light.ambient * ao)[..., None] * mat.ambient
    return ambient + diff_i[..., None] * mat.diffuse + spec_i[..., None] * mat.specular


def lambert(
    points: torch.Tensor,
    normals: torch.Tensor,
    light: PointLight,
    mat: Material,
    shadow: torch.Tensor,
) -> torch.Tensor:
    """Ambient plus shadowed diffuse."""
    incident = vnormalize(light.position - points)
    diff_i = torch.clamp(vdot(normals, incident), 0.0, 1.0) * shadow
    return light.ambient * mat.ambient + diff_i[..., None] * mat.diffuse
