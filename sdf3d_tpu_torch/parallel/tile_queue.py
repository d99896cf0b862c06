"""Load-balanced 2-D tile-queue sharding: equal-count static tile work-lists
(the port of ``sdf3d_tpu/parallel/tile_queue.py``).

The image is cut into ``(tile_h × tile_w)`` tiles, and every rank gets
exactly ``ceil(n_tiles / n)`` of them, chosen by a policy, which it renders
with the tile-queue kernels: K2 (``ops/render_kernel.render_kernel_tiles_forward``)
and K4 (``ops/fit_kernel.fit_step_kernel_tiles``).  The tiles' absolute
origins are run-time kernel arguments, so a new plan never rebuilds.
Policies:

- ``round_robin`` (independent of the scene): tile index mod n, so each
  rank's share spreads over rows and columns;
- ``balanced``: greedy longest-processing-time over per-tile work estimates
  under the equal-count cap (:func:`estimate_tile_work`, a march at 1/8 of
  the resolution).

Dummy tiles (the pad to an equal count) sit at ``row0 == height``: the
forward never gathers them back, and K4's mask in absolute pixels makes
their loss and gradient exact zeros.  ``TilePlan``, :func:`plan_tiles` and
:func:`pool_work_to_tiles` are the JAX package's numpy code, copied, so the
two packages' plans are equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from sdf3d_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A static assignment of image tiles to ranks.

    ``rows``/``cols``: (n, T_local) float32 absolute tile origins in
    work-list order (exact integers; dummies = (height, 0)).
    ``gather_index``: (nh, nw) int32: for image block (bi, bj), the
    position of its tile in the rank-major gathered stack
    (``rank * T_local + slot``); reassembly is one index gather.
    """

    tile_h: int
    tile_w: int
    height: int
    width: int
    n: int
    rows: np.ndarray
    cols: np.ndarray
    gather_index: np.ndarray

    @property
    def tiles_per_device(self) -> int:
        return self.rows.shape[1]

    def tables(self, rank: int, device) -> tuple:
        """Rank ``rank``'s origin tables ``(trow, tcol)``: contiguous (T,)
        int32 tensors on ``device``, the kernels' arguments."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a[rank], np.int32)).to(device)
                     for a in (self.rows, self.cols))


def plan_tiles(
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    n_devices: int,
    policy: str = "round_robin",
    work: np.ndarray | None = None,
) -> TilePlan:
    """Build the static tile → rank assignment.

    ``policy``: ``"round_robin"`` (row-major index mod n) or ``"balanced"``
    (greedy LPT on ``work`` under the equal-count cap).  ``work`` is an
    (nh, nw) per-tile cost array, required for ``balanced``; see
    :func:`estimate_tile_work`.
    """
    if height % tile_h or width % tile_w:
        raise ValueError(
            f"tile-queue sharding needs height/width divisible by the tile "
            f"({height}x{width} vs {tile_h}x{tile_w})"
        )
    nh, nw = height // tile_h, width // tile_w
    ntiles = nh * nw
    n = n_devices
    t_local = -(-ntiles // n)

    if policy == "round_robin":
        dev = np.arange(ntiles) % n
    elif policy == "balanced":
        if work is None:
            raise ValueError("policy='balanced' needs a per-tile work array")
        w = np.asarray(work, np.float64).reshape(ntiles)
        order = np.argsort(w)[::-1]  # largest first (LPT)
        loads = np.zeros(n)
        counts = np.zeros(n, np.int64)
        dev = np.empty(ntiles, np.int64)
        for t in order:
            elig = np.flatnonzero(counts < t_local)
            d = elig[np.argmin(loads[elig])]
            dev[t] = d
            loads[d] += w[t]
            counts[d] += 1
    else:
        raise ValueError(f"unknown tile policy {policy!r}")

    rows = np.full((n, t_local), np.float32(height), np.float32)  # dummies
    cols = np.zeros((n, t_local), np.float32)
    gather = np.empty((nh, nw), np.int32)
    slot = np.zeros(n, np.int64)
    for t in range(ntiles):
        d = int(dev[t])
        s = int(slot[d])
        bi, bj = t // nw, t % nw
        rows[d, s] = np.float32(bi * tile_h)
        cols[d, s] = np.float32(bj * tile_w)
        gather[bi, bj] = d * t_local + s
        slot[d] = s + 1
    return TilePlan(
        tile_h=tile_h, tile_w=tile_w, height=height, width=width, n=n,
        rows=rows, cols=cols, gather_index=gather,
    )


def estimate_tile_work(scene, camera, config, light=None, scale: int = 8) -> np.ndarray:
    """Per-pixel march work of a 1/``scale``-resolution pre-pass, (h, w)
    float64: the step counts of ``march.march_step_map`` on a downsampled
    ray grid (about 1/scale² of a frame's marching), doubled on hit rays
    when a lit shadow follows.  :func:`pool_work_to_tiles` pools it onto
    the tile grid for ``plan_tiles(policy="balanced")``; the estimate only
    has to rank tiles.  Runs on the scene's device."""
    from sdf3d_tpu_torch.camera import camera_rays
    from sdf3d_tpu_torch.march import march_step_map

    h = max(config.height // scale, 1)
    w = max(config.width // scale, 1)
    with torch.no_grad():
        o, d = camera_rays(camera, w, h, config.ray_mode)
        mc = config.march
        dist_, steps = march_step_map(scene.distance, o, d, mc)
        if config.shadow.enabled and light is not None:
            # Shadow work: hit rays march about twice.
            steps = steps + steps * (dist_ <= mc.max_distance).to(steps.dtype)
    return steps.cpu().numpy().astype(np.float64)


def pool_work_to_tiles(steps: np.ndarray, height: int, width: int, tile_h: int, tile_w: int) -> np.ndarray:
    """Pool an (h, w) work map (any resolution, e.g. the 1/8-scale pre-pass)
    onto the (nh, nw) tile grid of a ``height × width`` image by
    nearest-pixel accumulation."""
    h, w = steps.shape
    nh, nw = height // tile_h, width // tile_w
    bi = np.minimum((np.arange(h) * height // h) // tile_h, nh - 1)
    bj = np.minimum((np.arange(w) * width // w) // tile_w, nw - 1)
    out = np.zeros((nh, nw), np.float64)
    np.add.at(out, (np.broadcast_to(bi[:, None], (h, w)), np.broadcast_to(bj[None, :], (h, w))), steps)
    return out


def gather_target_tiles(target_planar: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Gather a planar (C, H, W) target into per-rank tile stacks
    ``(n, C, T_local·TH, TW)`` in work-list order (zero blocks for dummy
    tiles): row ``n`` is exactly the stack rank ``n``'s fit kernel reads.
    Accepts (H, W) for a mask."""
    squeeze = target_planar.dim() == 2
    if squeeze:
        target_planar = target_planar[None]
    C = target_planar.shape[0]
    TH, TW = plan.tile_h, plan.tile_w
    nh, nw = plan.height // TH, plan.width // TW
    flat = target_planar.reshape(C, nh, TH, nw, TW).permute(1, 3, 0, 2, 4).reshape(nh * nw, C, TH, TW)
    n, t_local = plan.rows.shape
    stacks = torch.zeros((n * t_local, C, TH, TW), dtype=target_planar.dtype, device=target_planar.device)
    order = torch.from_numpy(np.asarray(plan.gather_index, np.int64).reshape(-1)).to(target_planar.device)
    stacks[order] = flat  # tile t -> rank * T_local + slot
    out = stacks.reshape(n, t_local, C, TH, TW).permute(0, 2, 1, 3, 4).reshape(n, C, t_local * TH, TW)
    return out[:, 0] if squeeze else out


def all_gather_stacks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The equal-size stacks ``x`` of every rank, concatenated in rank order
    along dimension 1 (the stacks' rows).  Under gloo a card's tensor goes
    through host memory."""
    if mesh.size == 1:
        return x
    via = x.cpu() if dist.get_backend(mesh.group) == "gloo" else x
    parts = [torch.empty_like(via) for _ in range(mesh.size)]
    dist.all_gather(parts, via.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=1).to(x.device)


def render_tiles(scene, camera, light, mat, config, mesh: Mesh, kc=None, plan: TilePlan | None = None,
                 policy: str = "round_robin", work: np.ndarray | None = None, planar: bool = False):
    """Tile-queue sharded forward render: each rank runs K2 once over its
    work-list; the ranks' equal-size stacks are gathered (``dist.all_gather``
    above size 1) and one index gather by ``plan.gather_index`` reassembles
    the image.  Returns ``(H, W, 3)`` (``(3, H, W)`` with ``planar``) on
    every rank, on ``mesh.device``.  ``kc``: the kernel settings and the
    tile (``KernelConfig``, default its (24, 640) tile)."""
    from sdf3d_tpu_torch.ops.render_kernel import _U_K, KernelConfig, pack_uniforms, render_kernel_tiles_forward
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    kc = kc or KernelConfig()
    n, dev = mesh.size, mesh.device
    if plan is None:
        plan = plan_tiles(config.height, config.width, kc.tile_h, kc.tile_w, n, policy, work)
    if plan.n != n or plan.tile_h != kc.tile_h or plan.tile_w != kc.tile_w:
        raise ValueError("tile plan does not match the mesh or the kernel's tile shape")
    prm = scene_param_vector(scene, dev)
    uni = pack_uniforms(camera, light, mat, config.ray_mode, dev)
    uni[_U_K] = float(config.shadow.k)
    trow, tcol = plan.tables(mesh.rank, dev)
    rgb = render_kernel_tiles_forward(scene, prm, uni, trow, tcol, config, kc)[0]  # (3, T·TH, TW)
    rgb = all_gather_stacks(rgb, mesh)
    TH, TW = plan.tile_h, plan.tile_w
    tiles = rgb.reshape(3, n * plan.tiles_per_device, TH, TW)
    img = tiles[:, torch.from_numpy(plan.gather_index.astype(np.int64)).to(dev)]  # (3, nh, nw, TH, TW)
    img = img.permute(0, 1, 3, 2, 4).reshape(3, config.height, config.width)
    return img if planar else img.permute(1, 2, 0)
