"""Sharded execution over ``torch.distributed`` (the port of ``sdf3d_tpu/parallel``).

The image's pixels are split over the ranks of a process group, one process
per rank, while the scene, camera, light and material stay replicated; a fit
all-reduces its loss and gradients once a step (``dist.all_reduce``, or the
ring kernels K7 and K8 of :mod:`sdf3d_tpu_torch.parallel.ring_kernel`).  Row layouts run the render
and fit kernels (K1, K3) on each rank's rows, the tile queue runs their
tile-queue forms (K2, K4) on each rank's work-list; ``render_sharded`` is
the torch engine's sharded render; a fit outside the fused step renders each
rank's rows differentiably, on K1 and K5 or through ``diff.render_rays_diff``
(:func:`loss_and_grad_sharded`).  The multi-process
bootstrap, the per-rank data and the primary-only writer are in
:mod:`sdf3d_tpu_torch.parallel.launch`.
"""

from sdf3d_tpu_torch.parallel.collectives import allreduce_tree, pallas_psum, pallas_psum_tree
from sdf3d_tpu_torch.parallel.mesh import Mesh, make_mesh, tile_axis
from sdf3d_tpu_torch.parallel.shard_render import (
    fused_loss_and_grad_sharded,
    loss_and_grad_sharded,
    render_sharded,
    render_sharded_kernel,
)
from sdf3d_tpu_torch.parallel.tile_queue import TilePlan, plan_tiles, render_tiles

__all__ = [
    "Mesh",
    "make_mesh",
    "tile_axis",
    "render_sharded",
    "render_sharded_kernel",
    "fused_loss_and_grad_sharded",
    "loss_and_grad_sharded",
    "allreduce_tree",
    "pallas_psum",
    "pallas_psum_tree",
    "TilePlan",
    "plan_tiles",
    "render_tiles",
]
