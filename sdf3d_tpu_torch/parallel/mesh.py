"""The device mesh of the sharded path (the port of ``sdf3d_tpu/parallel/mesh.py``).

One logical axis, ``"tiles"``: the image's pixels are split over the ranks of
a ``torch.distributed`` process group, one process and one device per rank,
while the scene, camera, light and material are replicated.  A :class:`Mesh`
is what every sharded entry point takes where the JAX package takes a
``jax.sharding.Mesh``: the process group, its size, this process's rank and
its device.  A mesh of size 1 needs no process group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

#: The single data-parallel axis name used across the framework.
tile_axis = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``size`` ranks of ``group`` (``None``: the default group, or no group
    at size 1); this process is rank ``rank`` and renders on ``device``."""

    size: int
    rank: int
    device: torch.device
    group: object = None

    @property
    def shape(self) -> dict:
        """``{tile_axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return {tile_axis: self.size}


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of the process group that ``launch.initialize`` set up
    (``group``, default the default group), or a mesh of size 1 when no
    group is initialized.  ``device``: this rank's device, by default the
    card of index ``rank % device_count`` (two ranks on one card share it);
    ``"cpu"`` runs the kernels' plain versions."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        if group is not None:
            raise ValueError("a process group was given but torch.distributed is not initialized")
        size, rank = 1, 0
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(size=size, rank=rank, device=device, group=group)
