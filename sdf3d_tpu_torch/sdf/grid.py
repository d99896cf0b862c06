"""Dense voxel-grid SDF (the port of ``sdf3d_tpu/sdf/grid.py``).

A regular grid of distance samples, trilinearly interpolated, every sample a
parameter: the free-form, fittable shape family.  ``values`` is ``(Nz, Ny,
Nx)`` indexed ``[z, y, x]``; sample ``[0, 0, 0]`` sits at ``origin`` and
neighbours are ``spacing`` apart.  Inside the sample box the field is the
trilinear interpolation of the eight surrounding samples; outside, the
clamped boundary sample plus the Euclidean distance to the box, so the field
is continuous across the boundary and far rays march at full speed.

``distance`` is JAX's step for step: the clamps (``torch.maximum`` and
``torch.minimum`` with tensor bounds, whose adjoints split at a tie as lax's
do), the eight gathers as plain indexing (their backward a scatter-add into
``values``), the lerps in JAX's order and the exterior term through
``vlength_safe``.  A NaN point gives a NaN distance (its cell index is read
as 0 first, as XLA converts NaN to the integer 0).  No kernel takes a grid:
the CUDA kernels raise for it, as JAX's ``compile_scene`` does, and it
renders and differentiates on the torch paths (``render``,
``render_banded``, ``diff.render_diff``) and through
``ops.render_kernel_diff``'s banded route.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdf3d_tpu_torch.sdf.node import SDFNode, as_f32, linspace_f32, vlength_safe


def _full(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=x.dtype, device=x.device)


@functools.lru_cache(maxsize=None)
def _sample_bounds(nx: int, ny: int, nz: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dims - 1, dims - 2)`` of a grid's sample box in ``(x, y, z)``, made
    once per shape and device (no host-to-device copy inside a march)."""
    dims = torch.tensor([nx, ny, nz], dtype=torch.float32, device=device)
    return dims - 1.0, dims - 2.0


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with lax's tie rule."""
    lo = lo if isinstance(lo, torch.Tensor) else _full(x, lo)
    hi = hi if isinstance(hi, torch.Tensor) else _full(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


class VoxelGrid(SDFNode):
    """Trilinearly interpolated SDF sample grid (all samples differentiable)."""

    fields = ("values", "origin", "spacing")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        values = self.values
        nz, ny, nx = values.shape
        spacing = torch.maximum(self.spacing, _full(self.spacing, 1e-12))
        u = (p - self.origin) / spacing  # (..., 3) in sample coordinates (x, y, z)

        # Cell index and fraction, clamped so the boundary cell extrapolates
        # flatly (the exterior term carries the far field).
        last, last_cell = _sample_bounds(nx, ny, nz, p.device)
        uc = _clip(u, 0.0, last)
        i0 = _clip(torch.floor(uc), 0.0, last_cell)
        f = _clip(uc - i0, 0.0, 1.0)
        idx = torch.nan_to_num(i0.detach(), nan=0.0).to(torch.int64)
        ix, iy, iz = idx[..., 0], idx[..., 1], idx[..., 2]
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

        def at(dz, dy, dx):
            return values[iz + dz, iy + dy, ix + dx]

        c00 = at(0, 0, 0) * (1 - fx) + at(0, 0, 1) * fx
        c01 = at(0, 1, 0) * (1 - fx) + at(0, 1, 1) * fx
        c10 = at(1, 0, 0) * (1 - fx) + at(1, 0, 1) * fx
        c11 = at(1, 1, 0) * (1 - fx) + at(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c01 * fy
        c1 = c10 * (1 - fy) + c11 * fy
        inside = c0 * (1 - fz) + c1 * fz

        # Exterior: the Euclidean distance to the sample box, added to the
        # clamped boundary sample.
        lo = self.origin
        hi = self.origin + spacing * last
        q = torch.maximum(torch.maximum(lo - p, p - hi), _full(p, 0.0))
        return inside + vlength_safe(q)


def voxel_grid(values, origin=(-1.0, -1.0, -1.0), spacing=None, extent=None) -> VoxelGrid:
    """A :class:`VoxelGrid` from raw samples ``(Nz, Ny, Nx)``.  Give either
    ``spacing`` (the node distance) or ``extent`` (the world size of the
    whole box along its longest axis); the default is extent 2.0."""
    values = as_f32(values)
    if values.dim() != 3:
        raise ValueError(f"values must be (Nz, Ny, Nx), got shape {tuple(values.shape)}")
    if spacing is None:
        if extent is None:
            extent = 2.0
        n_max = max(values.shape) - 1
        spacing = float(extent) / max(n_max, 1)
    return VoxelGrid(values=values, origin=as_f32(origin, values.device), spacing=as_f32(spacing, values.device))


@torch.no_grad()
def voxelize(scene: SDFNode, resolution: int = 64, lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0)) -> VoxelGrid:
    """Bake any scene into a :class:`VoxelGrid`: ``scene.distance`` sampled
    on a regular ``resolution³`` node grid over the cubic box ``[lo, hi]``,
    on the device of the scene's parameters.  Author with analytic CSG, bake,
    then fit the grid freely (every sample is a parameter)."""
    device = next(iter(scene.parameters())).device
    lo, hi = as_f32(lo, device), as_f32(hi, device)
    n = int(resolution)
    if n < 2:
        raise ValueError("resolution must be >= 2")
    spans = (hi - lo).cpu().numpy()
    if not np.allclose(spans, spans[0]):
        raise ValueError(
            f"voxelize needs a cubic box (uniform spacing), got spans {spans}; "
            "use different resolutions per axis via voxel_grid() directly"
        )
    xs, ys, zs = (linspace_f32(lo[k], hi[k], n) for k in range(3))
    # points[z, y, x]: the (Nz, Ny, Nx) storage order.
    pz, py, px = torch.meshgrid(zs, ys, xs, indexing="ij")
    values = scene.distance(torch.stack([px, py, pz], dim=-1))
    spacing = (hi[0] - lo[0]) / float(n - 1)
    return VoxelGrid(values=values, origin=lo, spacing=spacing)
