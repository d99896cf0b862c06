"""Sharded rendering and all-reduced gradients over a :class:`~sdf3d_tpu_torch.parallel.mesh.Mesh`
(the port of ``sdf3d_tpu/parallel/shard_render.py``).

Data parallelism over pixels: each rank renders its own pixels with the
kernels, and the scene, camera, light and material are replicated.  Three
layouts:

- ``contiguous``: rank ``d`` renders the row slab ``[d·H/n, (d+1)·H/n)``;
- ``interleaved``: rank ``d`` renders the tile-height row blocks
  ``d·TH + b·(n·TH)``, so every rank sees a mix of sky, ground and object
  rows (``row0 = d·TH``, ``rowstride = n·TH`` in the uniforms);
- ``tiles``: a tile-queue work-list per rank (``tile_queue.py``).

A forward render gathers the ranks' pieces (``dist.all_gather``): the
kernels' (:func:`render_sharded_kernel`) or the torch engine's
(:func:`render_sharded`); a fit
all-reduces loss and gradients once a step (one flat vector, through one
``dist.all_reduce`` or one ring kernel), and the optimizer runs replicated:
the fused fit kernels' gradients (:func:`fused_loss_and_grad_sharded`) or
autograd's of a per-rank loss (:func:`loss_and_grad_sharded`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from sdf3d_tpu_torch.parallel.collectives import allreduce_tree
from sdf3d_tpu_torch.parallel.mesh import Mesh
from sdf3d_tpu_torch.parallel.tile_queue import all_gather_stacks, render_tiles

LAYOUTS = ("auto", "contiguous", "interleaved", "tiles")


def interleave_rows(x: torch.Tensor, n: int, th: int) -> torch.Tensor:
    """Permute leading-axis rows from absolute order to device-slab order:
    absolute row ``i·(n·th) + d·th + r`` lands at ``d·(H/n) + i·th + r``,
    so contiguous slab ``d`` holds the row blocks rank ``d`` renders under
    the interleaved layout."""
    H = x.shape[0]
    if H % (n * th) != 0:
        raise ValueError(f"rows {H} not divisible by n_devices*tile_h = {n * th}")
    blocks = H // (n * th)
    return x.reshape((blocks, n, th) + tuple(x.shape[1:])).transpose(0, 1).reshape(x.shape)


def deinterleave_rows(x: torch.Tensor, n: int, th: int) -> torch.Tensor:
    """Inverse of :func:`interleave_rows` (device-slab order → absolute)."""
    H = x.shape[0]
    if H % (n * th) != 0:
        raise ValueError(f"rows {H} not divisible by n_devices*tile_h = {n * th}")
    blocks = H // (n * th)
    return x.reshape((n, blocks, th) + tuple(x.shape[1:])).transpose(0, 1).reshape(x.shape)


def resolve_layout(layout: str, n: int, height: int, width: int, kc, tiles_ok: bool = True) -> str:
    """The layout ``"auto"`` stands for (JAX's rule): the tile queue once the
    mesh is large enough that row layouts fall under the scaling bar
    (n ≥ 16) and the image divides into tiles (and, for a fit, the fused
    kernel applies: ``tiles_ok``), else interleaved rows when the height
    divides into n·TH, else contiguous slabs.  Other values pass through."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if layout != "auto":
        return layout
    if n >= 16 and tiles_ok and height % kc.tile_h == 0 and width % kc.tile_w == 0:
        return "tiles"
    if height % (n * kc.tile_h) == 0:
        return "interleaved"
    return "contiguous"


def row_layout(config, mesh: Mesh, interleaved: bool, tile_h: int):
    """A rank's share of a row layout: ``(slab_cfg, row0, rowstride)``, its
    launch config (``height`` its rows, ``ndc_height`` the image's) and its
    row slots."""
    n = mesh.size
    if config.height % n != 0:
        raise ValueError(
            f"height {config.height} not divisible by mesh size {n}; pick a slab-aligned height"
        )
    slab = config.height // n
    if interleaved and slab % tile_h != 0:
        raise ValueError(
            f"interleaved sharding needs height divisible by n_devices*tile_h "
            f"({config.height} % {n * tile_h} != 0)"
        )
    slab_cfg = dataclasses.replace(config, height=slab, ndc_height=config.height)
    if interleaved:
        return slab_cfg, mesh.rank * tile_h, n * tile_h
    return slab_cfg, mesh.rank * slab, tile_h


def render_sharded(scene, camera, light, mat, config, mesh: Mesh, differentiable: bool = False) -> torch.Tensor:
    """Torch-engine sharded render (the port of JAX's ``render_sharded``):
    ``(H, W, 3)`` on every rank.  Rank ``d`` marches and shades the
    contiguous row slab ``[d·H/n, (d+1)·H/n)`` with ``render.render_rays``
    (``diff.render_rays_diff`` when ``differentiable``) and the slabs are
    gathered in rank order.  The scene, camera, light and material are on
    ``mesh.device``.  With ``differentiable`` this rank's slab keeps its
    graph and the other ranks' are constants, so the gradient of a loss of
    the image reaches this rank's pixels only: the sum over the mesh of the
    ranks' gradients (``collectives.allreduce_tree``) is the whole image's,
    as in :func:`loss_and_grad_sharded`."""
    from sdf3d_tpu_torch.camera import camera_rays_for_rows
    from sdf3d_tpu_torch.diff import render_rays_diff
    from sdf3d_tpu_torch.parallel.launch import rank_rows
    from sdf3d_tpu_torch.render import render_rays

    rows = rank_rows(mesh, config.height)
    o, d = camera_rays_for_rows(camera, config.width, config.height, rows, config.ray_mode)
    slab = (render_rays_diff if differentiable else render_rays)(scene, o, d, light, mat, config)
    parts = list(all_gather_stacks(slab.detach()[None], mesh)[0].split(len(rows)))
    parts[mesh.rank] = slab
    return torch.cat(parts)


def render_sharded_kernel(scene, camera, light, mat, config, mesh: Mesh, kc=None, interleaved: bool = False,
                          planar: bool = False, layout: str | None = None, policy: str = "round_robin",
                          work=None) -> torch.Tensor:
    """Kernel-sharded render (the counterpart of ``render_pallas_sharded``):
    ``(H, W, 3)`` (``(3, H, W)`` with ``planar``) on every rank, on
    ``mesh.device``.

    ``layout``: ``"contiguous"``, ``"interleaved"``, ``"tiles"`` (with
    ``policy``/``work`` as in ``plan_tiles``) or ``"auto"``
    (:func:`resolve_layout`); ``None`` keeps the ``interleaved`` flag.  Row
    layouts run K1 on the rank's rows, the tile queue runs K2 on its
    work-list.  ``kc``: the kernel settings and tile (``KernelConfig``).
    """
    from sdf3d_tpu_torch.ops.fit_kernel import with_rows
    from sdf3d_tpu_torch.ops.render_kernel import _U_K, KernelConfig, pack_uniforms, render_kernel_run
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    kc = kc or KernelConfig()
    n = mesh.size
    if layout is not None:
        layout = resolve_layout(layout, n, config.height, config.width, kc)
        if layout == "tiles":
            return render_tiles(scene, camera, light, mat, config, mesh, kc, policy=policy, work=work, planar=planar)
        interleaved = layout == "interleaved"
    th = kc.tile_h
    slab_cfg, row0, stride = row_layout(config, mesh, interleaved, th)
    dev = mesh.device
    uni = pack_uniforms(camera, light, mat, config.ray_mode, dev)
    uni[_U_K] = float(config.shadow.k)
    rgb = render_kernel_run(scene, scene_param_vector(scene, dev), with_rows(uni, row0, stride), slab_cfg, kc)[0]
    out = all_gather_stacks(rgb, mesh)  # (3, H, W), rows in slab order
    if interleaved:
        out = deinterleave_rows(out.transpose(0, 1), n, th).transpose(0, 1)
    return out if planar else out.permute(1, 2, 0)


def fused_loss_and_grad_sharded(vag_fn: Callable[..., tuple], mesh: Mesh, allreduce: str = "psum"):
    """Mesh-parallelize a per-rank ``(loss, grads)`` function.

    ``vag_fn(*args)`` returns its rows' (or work-list's) summed loss and its
    gradients, a sequence of tensors (the fused fit kernels, K3 or K4).  The
    returned function sums both over the mesh as one flat vector
    (``collectives.allreduce_tree``: ``dist.all_reduce`` under ``"psum"``,
    a ring kernel under ``"pallas_ring"``/``"pallas_rs_ag"``), so every rank
    holds the same values and the optimizer runs replicated with no further
    communication.
    """

    def sharded(*args):
        loss, grads = vag_fn(*args)
        loss, *grads = allreduce_tree([loss, *grads], allreduce, mesh)
        return loss, grads

    return sharded


def loss_and_grad_sharded(loss_fn: Callable[..., torch.Tensor], mesh: Mesh, allreduce: str = "psum"):
    """Mesh-parallelize a per-rank loss (the counterpart of JAX's
    ``loss_and_grad_sharded``).

    ``loss_fn(*args)`` returns the **sum** of its rows' pixel losses (a sum,
    so the sum over the mesh is the whole image's loss), recorded by
    autograd.  The returned ``sharded(params, *args)`` gives ``(loss,
    grads)``: the loss and its gradients with respect to ``params`` (tensors
    that require grad; one that the loss does not reach gets zeros), both
    summed over the mesh through :func:`fused_loss_and_grad_sharded`'s one
    flat all-reduce, so every rank holds the same values."""

    def vag_fn(params, *args):
        params = list(params)
        loss = loss_fn(*args)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    return fused_loss_and_grad_sharded(vag_fn, mesh, allreduce)
