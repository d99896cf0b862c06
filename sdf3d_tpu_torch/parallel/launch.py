"""Multi-process execution (the port of ``sdf3d_tpu/parallel/launch.py``).

A sharded run is one process per rank, each with its own device (or, for a
check on one card, several ranks sharing it).  This module supplies what
such a run needs beyond the sharded entry points:

1. **Bootstrap** (:func:`initialize`): every process joins one
   ``torch.distributed`` process group before the first collective.  NCCL
   joins ranks on distinct cards; gloo joins CPU ranks and ranks that share
   a card (NCCL refuses two ranks on one device).  The choice is made from
   the arguments, and a backend that fails raises: neither falls back to the
   other.
2. **Per-rank data** (:func:`rank_rows`, :func:`fit_arrays`): a rank builds
   only its own rays and target rows, never the full image's, since it
   marches only those.
3. **Primary-only side effects** (:func:`is_primary`): checkpoints and
   metrics are written by rank 0 alone (``checkpoint.py`` gates on it).

Launch, one command per rank (ranks on one host, any free port)::

    # fit_job.py
    from sdf3d_tpu_torch.parallel import launch, make_mesh
    launch.initialize("tcp://localhost:29511", world_size=2, rank=rank)
    fit_scene(target, scene0, cam, light, mat, cfg, fit_cfg, mesh=make_mesh())
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from sdf3d_tpu_torch.parallel.mesh import Mesh


def initialize(address: str | None = None, world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, device="cuda") -> None:
    """Join the default process group (a no-op when it exists).

    ``address``: the rendezvous, ``"tcp://host:port"`` or ``"host:port"``;
    ``None`` reads the ``env://`` variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as ``torchrun`` sets them.
    ``backend``: by default ``"nccl"`` when the ranks run on cards and there
    are at least as many cards as ranks, else ``"gloo"`` (CPU ranks, or
    ranks sharing a card).  Under NCCL this rank's current card becomes
    ``rank % device_count``."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    device = torch.device(device)
    if backend is None:
        on_cards = device.type == "cuda" and torch.cuda.is_available()
        backend = "nccl" if on_cards and world_size <= torch.cuda.device_count() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if address is None:
        init_method = "env://"
    else:
        init_method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def shutdown() -> None:
    """Free the ring kernels' buffers, then leave the default process group
    (a no-op without one)."""
    from sdf3d_tpu_torch.parallel import ring_kernel

    ring_kernel.close_all()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on exactly one process (rank 0): the checkpoint and metrics
    writer.  Also true without a process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def abs_rows_for_block(row_lo: int, row_hi: int, height: int, n: int,
                       interleaved: bool = False, tile_h: int = 0) -> np.ndarray:
    """Absolute image rows held by row block ``[row_lo, row_hi)`` of the
    device-slab order.

    Contiguous layout: ``arange(row_lo, row_hi)``.  Interleaved layout
    (``shard_render.py``): slab order row ``g = d·slab + i·tile_h + r``
    holds absolute row ``i·(n·tile_h) + d·tile_h + r``."""
    g = np.arange(row_lo, row_hi)
    if not interleaved:
        return g
    if tile_h <= 0:
        raise ValueError("interleaved layout needs tile_h > 0")
    slab = height // n
    d, rem = g // slab, g % slab
    i, r = rem // tile_h, rem % tile_h
    return i * (n * tile_h) + d * tile_h + r


def rank_rows(mesh: Mesh, height: int, interleaved: bool = False, tile_h: int = 0) -> np.ndarray:
    """The absolute image rows this rank renders under a row layout, in its
    launch order: its slab of the device-slab order."""
    if height % mesh.size:
        raise ValueError(f"height {height} not divisible by mesh size {mesh.size}")
    slab = height // mesh.size
    return abs_rows_for_block(mesh.rank * slab, (mesh.rank + 1) * slab, height, mesh.size, interleaved, tile_h)


def fit_arrays(mesh: Mesh, camera, render_config, target=None, target_fn=None,
               interleaved: bool = False, tile_h: int = 0):
    """This rank's ``(origins, directions, target)`` rows under a row layout,
    each (H/n, W, ·) on ``mesh.device``: the rays of its rows
    (``camera.camera_rays_for_rows``) and its target rows, from
    ``target_fn(abs_rows) -> (len(abs_rows), W, C)`` (each rank loads only
    its rows) or sliced from the array ``target`` (H, W, C)."""
    from sdf3d_tpu_torch.camera import camera_rays_for_rows

    H, W = render_config.height, render_config.width
    rows = rank_rows(mesh, H, interleaved, tile_h)
    if target_fn is None:
        if target is None:
            raise ValueError("pass target or target_fn")
        target_fn = lambda abs_rows: torch.as_tensor(target)[torch.as_tensor(abs_rows)]  # noqa: E731
    origins, directions = camera_rays_for_rows(camera.to(mesh.device), W, H, rows, render_config.ray_mode)
    target_rows = torch.as_tensor(target_fn(rows), dtype=torch.float32).to(mesh.device)
    return origins, directions, target_rows
