"""Inverse rendering: fit scene parameters to a target image (the port of
``sdf3d_tpu/fit.py``).

Each step renders, takes the pixel loss and its gradient, and updates the
scene with a ``torch.optim`` optimizer.  Two engines:

- ``engine="kernel"`` (JAX's ``"pallas"``) takes one of two routes: the
  fused fit step (``ops/fit_kernel.py``, one kernel launch per step) when
  :func:`~sdf3d_tpu_torch.ops.fit_kernel.fused_l2_eligible` holds (the plain
  L2 loss, the multiscale pyramid whose groups fit the kernel's block and
  tile, and the silhouette coverage term, in one launch); otherwise the
  differentiable kernel render (``ops/render_autograd.py``: forward kernel,
  backward kernel; for a neural scene the neural kernel forward) and
  :func:`pixel_loss` under autograd, plus the silhouette term of
  ``diff.coverage`` on the camera's rays;
- ``engine="torch"`` (JAX's ``"xla"``): ``diff.py``'s implicit-function
  render (the torch march, its gradient one distance evaluation), the pixel
  loss and the coverage term under autograd.

:func:`fit_view` fits the camera, light and material to an image with the
scene fixed, on the fused fit step's uniforms' gradient where it applies.
:func:`fit_scene_multiview` fits the scene to several views at once: one
launch of the fused fit step a step for all of them (its view axis).

With a ``mesh`` (``parallel/``) the fused step is sharded: each rank runs
K3 on its rows (the contiguous and interleaved layouts) or K4 on its tile
work-list (the tile queue), loss and gradients are all-reduced once a step,
and the optimizer runs replicated on every rank.  Outside the fused step
each rank renders its rows differentiably and autograd's gradients are
all-reduced (``parallel.loss_and_grad_sharded``): on the kernel engine
through ``ops.render_kernel_rows`` (K1 and K5 on its row slab) for a scene
whose every node has an emitter, else (a NeuralSDF, a VoxelGrid, and every
scene on the torch engine) through ``diff.render_rays_diff``.

On a CPU device the kernels' plain PyTorch versions run.  Steps run in
chunks; the losses stay on the device and are read once per chunk.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import time
import warnings

import numpy as np
import torch

from sdf3d_tpu_torch.camera import Camera, camera_rays, camera_rays_for_rows
from sdf3d_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.diff import coverage, render_diff, render_rays_diff
from sdf3d_tpu_torch.lighting import Material, PointLight
from sdf3d_tpu_torch.ops.fit_kernel import (
    fit_step_kernel,
    fit_step_kernel_tiles,
    fused_l2_eligible,
    multiview_inputs,
    with_rows,
)
from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff, render_kernel_rows
from sdf3d_tpu_torch.ops.render_kernel import _U_K, KernelConfig, check_settings, pack_uniforms
from sdf3d_tpu_torch.ops.scene_program import describe, has_emitters, leaves, scene_param_vector
from sdf3d_tpu_torch.parallel import launch
from sdf3d_tpu_torch.parallel.collectives import broadcast_object, check_allreduce
from sdf3d_tpu_torch.parallel.mesh import Mesh
from sdf3d_tpu_torch.parallel.shard_render import (
    LAYOUTS,
    fused_loss_and_grad_sharded,
    loss_and_grad_sharded,
    row_layout,
)
from sdf3d_tpu_torch.parallel.tile_queue import estimate_tile_work, gather_target_tiles, plan_tiles, pool_work_to_tiles
from sdf3d_tpu_torch.render import render_rays_banded
from sdf3d_tpu_torch.sdf.node import SDFNode
from sdf3d_tpu_torch.utils.logging import MetricsLogger


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool over the leading (H, W) axes of an (H, W, C) image
    (an odd last row or column is dropped)."""
    h, w, c = img.shape
    h2, w2 = h - h % 2, w - w % 2
    return img[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, c).mean(dim=(1, 3))


def pixel_loss(img: torch.Tensor, target: torch.Tensor, kind: str, levels: int = 3) -> torch.Tensor:
    """Sum-of-squares pixel loss, optionally over an average-pool pyramid
    whose level ``l`` is scaled by ``4**l`` (each level weighs the same per
    original pixel)."""
    loss = torch.sum((img - target) ** 2)
    if kind == "l2":
        return loss
    if kind != "multiscale":
        raise ValueError(f"unknown loss {kind!r}")
    a, b = img, target
    for level in range(1, levels + 1):
        if min(a.shape[0], a.shape[1]) < 2:
            break
        a, b = _avg_pool2(a), _avg_pool2(b)
        loss = loss + (4.0**level) * torch.sum((a - b) ** 2)
    return loss


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Fit settings, with the JAX package's field names (``convert.from_jax``
    carries a JAX ``FitConfig`` over)."""

    steps: int = 200
    learning_rate: float = 1e-2
    optimizer: str = "adam"  # adam | sgd
    log_every: int = 10
    checkpoint_every: int = 0  # 0 disables
    checkpoint_dir: str | None = None
    #: "kernel": the CUDA kernels (their plain versions on a CPU device);
    #: JAX's "pallas".  "torch": ``diff.py``'s implicit-function render on
    #: the torch march; JAX's "xla" (``convert.from_jax`` maps the names).
    engine: str = "kernel"
    #: "l2", or "multiscale": L2 summed over an average-pool pyramid.
    loss: str = "l2"
    pyramid_levels: int = 3
    #: Steps per chunk (losses are read once per chunk); 0 = ``log_every``.
    #: Chunks also end at checkpoint boundaries.
    chunk_steps: int = 0
    #: Weight of the soft-silhouette (coverage) term; 0 disables.  It
    #: compares ``sigmoid((2ε − min_sdf)/β)`` along each ray with the
    #: target's object mask (``target_coverage``, or the pixels off
    #: ``render_config.background``).
    silhouette_weight: float = 0.0
    #: Softness (world units) of the coverage sigmoid; None = epsilon/2.5.
    silhouette_beta: float | None = None
    #: With ``mesh``: under ``shard_layout="auto"``, shard the image as
    #: interleaved tile-height row blocks, so every rank sees a mix of sky,
    #: ground and object rows.
    shard_interleaved: bool = False
    #: With ``mesh``: "contiguous" or "interleaved" row layouts, the "tiles"
    #: work queue, or "auto": the tile queue at n >= 16 when the image
    #: divides into tiles, else interleaved if ``shard_interleaved``, else
    #: contiguous (the JAX package's rule).
    shard_layout: str = "auto"
    #: Tile-queue policy: "round_robin" or "balanced" (greedy LPT on a
    #: 1/8-resolution march pre-pass).
    shard_policy: str = "round_robin"
    #: With the balanced tile queue: re-estimate the work from the current
    #: scene and re-plan every N steps (0: plan once).  Any equal-count plan
    #: computes the same loss and gradients, so a re-plan only rebalances.
    replan_every: int = 0
    #: The all-reduce of sharded fits: "psum" (one ``dist.all_reduce`` a
    #: step), "pallas_ring" (the ring kernels, K7 or K8 by payload),
    #: "pallas_rs_ag" (K8), or either with "_interpret" (their plain
    #: versions on any device); ``parallel/collectives.py``.
    allreduce: str = "psum"


@dataclasses.dataclass
class FitResult:
    scene: SDFNode
    losses: list
    steps_run: int
    rays_per_second: float


@dataclasses.dataclass
class ViewFitResult:
    camera: Camera
    light: PointLight
    mat: Material
    losses: list
    steps_run: int


def _frozen_param_slots(scene0: SDFNode, trainable) -> tuple:
    """Flat parameter-vector slots of the frozen leaves.  ``trainable`` has
    one bool per leaf of ``scene0`` (``scene_program.leaves`` order, the
    JAX package's ``tree_leaves`` order).  ``()`` when everything is
    trainable, or when everything is frozen (as in the JAX package)."""
    if trainable is None:
        return ()
    leaf_list = list(leaves(scene0))
    if len(trainable) != len(leaf_list):
        raise ValueError(f"trainable has {len(trainable)} entries for {len(leaf_list)} scene leaves")
    idx, off = [], 0
    for tr, leaf in zip(trainable, leaf_list):
        n = max(1, int(np.prod(leaf.shape)))
        if not bool(tr):
            idx.extend(range(off, off + n))
        off += n
    if len(idx) == off:
        return ()
    return tuple(idx)


def _trainable_scene(scene0: SDFNode, trainable, fit_config: FitConfig, device):
    """``(scene, leaves, optimizer, frozen slots, set_grads)`` of a scene
    fit: a copy of ``scene0`` on ``device`` whose frozen leaves
    (``trainable``) need no gradient, the optimizer over the others, and
    ``set_grads(g_prm)``, which hands the trained leaves their slices of a
    flat gradient."""
    scene = copy.deepcopy(scene0).to(device)
    leaf_list = list(leaves(scene))
    flags = [True] * len(leaf_list) if trainable is None else [bool(x) for x in trainable]
    frozen = _frozen_param_slots(scene0, trainable)
    if not any(flags):
        raise ValueError("trainable freezes every scene parameter")
    for leaf, tr in zip(leaf_list, flags):
        leaf.requires_grad_(tr)
    opt = _make_optimizer(fit_config, [leaf for leaf, tr in zip(leaf_list, flags) if tr])
    sizes = [int(leaf.numel()) for leaf in leaf_list]

    def set_grads(g_prm):
        for leaf, g, tr in zip(leaf_list, torch.split(g_prm, sizes), flags):
            if tr:
                leaf.grad = g.view_as(leaf)

    return scene, leaf_list, opt, frozen, set_grads


def _make_optimizer(cfg: FitConfig, params) -> torch.optim.Optimizer:
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _check_engine(fit_config: FitConfig, render_config: RenderConfig) -> None:
    """Raise for an unknown engine, and for what the kernel engine does not
    take: autodiff normals (JAX's ``ValueError``); the torch engine takes
    them.  A shadow under ``shadow.grad == "ad"`` runs on both engines."""
    if fit_config.engine not in ("kernel", "torch"):
        raise ValueError(f"unknown engine {fit_config.engine!r}; choose 'kernel' or 'torch'")
    if fit_config.engine == "kernel":
        check_settings(render_config)


def _check_supported(fit_config: FitConfig, render_config: RenderConfig, mesh, scene0, kc: KernelConfig) -> None:
    """Raise for what the fit does not take (before any work)."""
    _check_engine(fit_config, render_config)
    if fit_config.loss not in ("l2", "multiscale"):
        raise ValueError(f"unknown loss {fit_config.loss!r}")
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh()), not {type(mesh).__name__}")
        if fit_config.shard_layout not in LAYOUTS:
            raise ValueError(f"unknown shard_layout {fit_config.shard_layout!r}")
        if fit_config.shard_policy not in ("round_robin", "balanced"):
            raise ValueError(f"unknown tile policy {fit_config.shard_policy!r}")
        check_allreduce(fit_config.allreduce)
        fused = _fused(fit_config, render_config, scene0, kc)
        layout = _sharded_layout(fit_config, render_config, kc, mesh.size, fused)
        if fit_config.loss == "multiscale":
            _check_multiscale_alignment(fit_config, render_config, kc, mesh.size, layout)
        if fit_config.engine == "kernel" and not fused and layout == "tiles":
            raise ValueError("shard_layout='tiles' needs the fused fit kernel (fused_l2_eligible); use a row "
                             "layout for this config")


def _fused(fit_config: FitConfig, render_config: RenderConfig, scene, kc: KernelConfig) -> bool:
    """Whether a kernel-engine fit of ``scene`` runs on the fused fit step."""
    return fit_config.engine == "kernel" and fused_l2_eligible(
        render_config, scene, fit_config.loss, fit_config.pyramid_levels, fit_config.silhouette_weight, kc)


def _check_multiscale_alignment(fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig,
                                n: int, layout: str) -> None:
    """JAX's gate of a sharded multiscale fit: the pyramid pools within each
    rank's rows, so its groups are the unsharded objective's only when every
    rank's row run starts and ends on a ``2**pyramid_levels`` boundary."""
    H = render_config.height
    if layout != "tiles" and H % n != 0:
        raise ValueError(f"height {H} not divisible by mesh size {n}")
    run = kc.tile_h if layout in ("interleaved", "tiles") else H // n
    lv = 1 << fit_config.pyramid_levels
    if run % lv != 0:
        what = "tile_h" if layout in ("interleaved", "tiles") else "slab height (height/n_devices)"
        raise ValueError(
            f"multiscale loss under row sharding needs the {what} ({run}) divisible by 2**pyramid_levels ({lv}) so "
            "pooled blocks align with the unsharded objective; adjust height/pyramid_levels/tile or fit unsharded")


def _resolve_layout(fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig, n: int,
                    tiles_ok: bool = True) -> str:
    """The layout of a sharded fit (JAX's ``fit.py::_resolve_layout``):
    ``tiles_ok`` says whether the fused fit step applies."""
    layout = fit_config.shard_layout
    if layout != "auto":
        return layout
    if fit_config.shard_interleaved:
        return "interleaved"
    if n >= 16 and tiles_ok and render_config.height % kc.tile_h == 0 and render_config.width % kc.tile_w == 0:
        return "tiles"
    return "contiguous"


def _sharded_layout(fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig, n: int,
                    fused: bool) -> str:
    """The layout a sharded fit runs in (``fused``: on the fused fit step):
    the torch engine's ranks hold contiguous row slabs whatever
    ``shard_layout`` says (JAX's ``"xla"`` engine has no layout)."""
    if fit_config.engine == "torch":
        return "contiguous"
    return _resolve_layout(fit_config, render_config, kc, n, fused)


def _sharded_step(mesh: Mesh, fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig, scene, uni,
                  target, camera, light, frozen: tuple, coverage):
    """The per-step ``(loss, [g_prm])`` of a sharded fit, summed over the
    mesh, and the re-plan callable of a balanced tile queue (``None``
    otherwise).  Each rank prepares only its own share: its rows' target and
    row slots, or its work-list's tables and target stack.  The sums stay in
    float64 through the all-reduce and are rounded to float32 once, so every
    layout and world size rounds the same totals alike.  ``coverage(rgb,
    rows)``: the coverage target of the silhouette term for the target rows
    ``rgb`` of the absolute ``rows`` (``None`` without the term); it rides
    beside the target as a fourth channel, through the same row layout or
    tile gather."""
    H, W = render_config.height, render_config.width
    layout = _resolve_layout(fit_config, render_config, kc, mesh.size)
    loss = dict(loss_kind=fit_config.loss, levels=fit_config.pyramid_levels, sil_w=fit_config.silhouette_weight,
                sil_beta=fit_config.silhouette_beta)
    replan = None
    if layout == "tiles":
        if callable(target):
            raise ValueError("shard_layout='tiles' gathers tile stacks from a target array, not a row loader")
        target_planar = target.permute(2, 0, 1)
        if coverage is not None:
            target_planar = torch.cat([target_planar, coverage(target, np.arange(H))[None]])
        policy = fit_config.shard_policy

        def plan_inputs():
            work = None
            if policy == "balanced":
                # Rank 0's estimate, so every rank builds the same plan.
                est = None
                if mesh.rank == 0:
                    est = pool_work_to_tiles(estimate_tile_work(scene, camera, render_config, light), H, W,
                                             kc.tile_h, kc.tile_w)
                work = broadcast_object(est, mesh)
            plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, mesh.size, policy, work)
            trow, tcol = plan.tables(mesh.rank, mesh.device)
            return trow, tcol, gather_target_tiles(target_planar, plan)[mesh.rank].contiguous()

        tiles = list(plan_inputs())

        def vag():
            trow, tcol, stack = tiles
            loss_, g_prm, _ = fit_step_kernel_tiles(scene, scene_param_vector(scene), uni, stack[:3].contiguous(),
                                                    trow, tcol, render_config, kc, wrt_uniforms=False,
                                                    frozen_slots=frozen, sum_dtype=torch.float64,
                                                    coverage_tiles=stack[3].contiguous() if coverage else None,
                                                    **loss)
            return loss_, [g_prm]

        if policy == "balanced" and fit_config.replan_every > 0:
            def replan():
                tiles[:] = plan_inputs()
    else:
        # Everything the step reads is fixed here, before the chunk loop:
        # the row stride is this layout's, never a name the loop rebinds
        # (JAX's fix b5b8b61 of an interleaved stride that took the chunk
        # length).
        interleaved = layout == "interleaved"
        slab_cfg, row0, rowstride = row_layout(render_config, mesh, interleaved, kc.tile_h)
        rows = launch.rank_rows(mesh, H, interleaved, kc.tile_h)
        rows_rgb = target(rows) if callable(target) else target[torch.from_numpy(rows).to(target.device)]
        rows_rgb = torch.as_tensor(rows_rgb, dtype=torch.float32).to(mesh.device)
        slab_target = rows_rgb.permute(2, 0, 1).contiguous()
        slab_cov = coverage(rows_rgb, rows).contiguous() if coverage is not None else None
        slab_uni = with_rows(uni, row0, rowstride)

        def vag():
            loss_, g_prm, _ = fit_step_kernel(scene, scene_param_vector(scene), slab_uni, slab_target, slab_cfg, kc,
                                              wrt_uniforms=False, frozen_slots=frozen, sum_dtype=torch.float64,
                                              target_coverage=slab_cov, **loss)
            return loss_, [g_prm]

    return fused_loss_and_grad_sharded(vag, mesh, fit_config.allreduce), replan


def _diff_render(fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig, scene, camera, light, mat):
    """The differentiable image (H, W, 3) of a fit outside the fused step:
    ``diff.render_diff`` on the torch engine, the kernels'
    ``render_kernel_diff`` on the kernel engine."""
    if fit_config.engine == "torch":
        return render_diff(scene, camera, light, mat, render_config)
    return render_kernel_diff(render_config, kc, scene, camera, light, mat)


def _sil_term(fit_config: FitConfig, render_config: RenderConfig, scene, origins, directions, cov_target):
    """The silhouette term outside the fused step (JAX's ``_sil_term``):
    ``silhouette_weight · Σ (coverage − cov_target)²`` over the rays, with
    ``diff.coverage``'s gradient; 0 without a coverage target."""
    if cov_target is None:
        return 0.0
    cov = coverage(render_config.march, scene, origins, directions, fit_config.silhouette_beta)
    return fit_config.silhouette_weight * torch.sum((cov - cov_target) ** 2)


def _sharded_diff_step(mesh: Mesh, fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig, target,
                       camera, light, mat, cov_rows, rows_on_kernels: bool):
    """The per-step ``sharded(params, scene) -> (loss, grads)`` of a sharded
    fit outside the fused step (JAX's ``loss_and_grad_sharded`` route): each
    rank renders its rows, adds the silhouette term on their rays, and the
    summed loss and the parameters' gradients are all-reduced once a step.
    A rank renders its rows with ``ops.render_kernel_rows`` (K1 forward, K5
    backward on its slab: the row uniforms of the contiguous or interleaved
    layout) where ``rows_on_kernels`` (the kernel engine on a scene whose
    every node has an emitter: JAX's ``render_pallas_rows``), else through
    ``diff.render_rays_diff``, in bands of rows on the kernel engine (a
    scene without emitters: JAX's ``render_rays_banded(...,
    inner=render_rays_diff)``)."""
    H, W = render_config.height, render_config.width
    interleaved = _sharded_layout(fit_config, render_config, kc, mesh.size, False) == "interleaved"
    slab_cfg, row0, rowstride = row_layout(render_config, mesh, interleaved, kc.tile_h)
    rows = launch.rank_rows(mesh, H, interleaved, kc.tile_h)
    rows_rgb = target(rows) if callable(target) else target[torch.from_numpy(rows).to(target.device)]
    rows_rgb = torch.as_tensor(rows_rgb, dtype=torch.float32).to(mesh.device)
    cov = cov_rows(rows_rgb, rows) if cov_rows is not None else None
    o, d = camera_rays_for_rows(camera, W, H, rows, render_config.ray_mode)

    def slab_loss(scene):
        if fit_config.engine == "torch":
            img = render_rays_diff(scene, o, d, light, mat, render_config)
        elif rows_on_kernels:
            img = render_kernel_rows(scene, camera, light, mat, slab_cfg, kc, row0, rowstride)
        else:
            img = render_rays_banded(scene, o, d, light, mat, render_config, inner=render_rays_diff)
        loss = pixel_loss(img, rows_rgb, fit_config.loss, fit_config.pyramid_levels)
        return loss + _sil_term(fit_config, render_config, scene, o, d, cov)

    return loss_and_grad_sharded(slab_loss, mesh, fit_config.allreduce)


def fit_scene(
    target,
    scene0: SDFNode,
    camera,
    light,
    mat,
    render_config: RenderConfig,
    fit_config: FitConfig = FitConfig(),
    mesh: Mesh | None = None,
    logger: MetricsLogger | None = None,
    trainable=None,
    target_coverage=None,
    device="cuda",
    kernel_config: KernelConfig | None = None,
) -> FitResult:
    """Fit ``scene0``'s parameters so its render matches ``target`` (H, W, 3).

    Runs on ``device`` (default the card; without one it fails rather than
    move to the CPU).  ``scene0`` is not modified: the fitted scene is
    ``FitResult.scene``.  ``trainable``: one bool per scene leaf; frozen
    leaves keep their values (their gradient slots read exactly 0 in the
    fused step).  With ``fit_config.checkpoint_dir`` a checkpoint written by
    the same fit setup is resumed before the first step (another setup's is
    ignored with a warning and overwritten), and snapshots are written
    every ``checkpoint_every`` steps.  ``kernel_config``: the kernels'
    block and tile (``KernelConfig``).  ``target_coverage``: the (H, W)
    object mask in [0, 1] of the silhouette term
    (``fit_config.silhouette_weight``); inferred from the pixels off
    ``render_config.background`` where not given (under a row loader it may
    be a callable of the absolute rows too).

    ``mesh`` (``parallel.make_mesh()``): shard the fit over its ranks, on
    ``mesh.device`` (``device`` is then not read), in the layout
    ``fit_config.shard_layout`` picks (:class:`FitConfig`).  Every rank calls
    ``fit_scene`` with the same arguments and gets the same result.  Under a
    row layout ``target`` may be a callable ``(abs_rows) -> (len(abs_rows),
    W, 3)`` so a rank loads only its rows.  Only rank 0 logs and writes
    checkpoints; on resume rank 0's state, step and losses are broadcast.
    """
    kc = kernel_config or KernelConfig()
    _check_supported(fit_config, render_config, mesh, scene0, kc)
    sil_w = fit_config.silhouette_weight
    device = mesh.device if mesh is not None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_scene: no CUDA device; pass device='cpu' to run the kernels' plain versions")
    if mesh is not None and not launch.is_primary():
        logger = None  # exactly one metrics writer (checkpoint.py gates its own)
    scene, leaf_list, opt, frozen, set_grads = _trainable_scene(scene0, trainable, fit_config, device)
    camera, light, mat = camera.to(device), light.to(device), mat.to(device)
    if callable(target) and mesh is None:
        raise TypeError("a row-loader target (a callable) needs a mesh; pass the (H, W, 3) image")
    if not callable(target):
        if not isinstance(target, torch.Tensor):
            target = torch.from_numpy(np.array(target, np.float32))
        target = target.detach().to(device, torch.float32)

    cov_rows = _coverage_rows(render_config, target_coverage, device) if sil_w > 0.0 else None
    replan = None
    if _fused(fit_config, render_config, scene, kc):
        uni = pack_uniforms(camera, light, mat, render_config.ray_mode, device)
        uni[_U_K] = float(render_config.shadow.k)
        loss = dict(loss_kind=fit_config.loss, levels=fit_config.pyramid_levels, sil_w=sil_w,
                    sil_beta=fit_config.silhouette_beta)
        if mesh is not None:
            sharded, replan = _sharded_step(mesh, fit_config, render_config, kc, scene, uni, target, camera, light,
                                            frozen, cov_rows)

            def step_loss():
                loss, (g_prm,) = sharded()
                set_grads(g_prm.to(torch.float32))
                return loss.to(torch.float32)
        else:
            target_planar = target.permute(2, 0, 1).contiguous()
            cov = cov_rows(target, np.arange(render_config.height)).contiguous() if cov_rows is not None else None

            def step_loss():
                loss_, g_prm, _ = fit_step_kernel(scene, scene_param_vector(scene), uni, target_planar,
                                                  render_config, kc, wrt_uniforms=False, frozen_slots=frozen,
                                                  target_coverage=cov, **loss)
                set_grads(g_prm)
                return loss_
    elif mesh is not None:
        sharded = _sharded_diff_step(mesh, fit_config, render_config, kc, target, camera, light, mat, cov_rows,
                                     fit_config.engine == "kernel" and has_emitters(scene0))
        trained = [leaf for leaf in leaf_list if leaf.requires_grad]

        def step_loss():
            loss, grads = sharded(trained, scene)
            for leaf, g in zip(trained, grads):
                leaf.grad = g
            return loss
    else:
        # The differentiable render (the kernels' or diff.py's) and the
        # silhouette term on the camera's rays, under autograd.
        o, d = camera_rays(camera, render_config.width, render_config.height, render_config.ray_mode)
        cov = cov_rows(target, np.arange(render_config.height)) if cov_rows is not None else None

        def step_loss():
            img = _diff_render(fit_config, render_config, kc, scene, camera, light, mat)
            loss = pixel_loss(img, target, fit_config.loss, fit_config.pyramid_levels)
            loss = loss + _sil_term(fit_config, render_config, scene, o, d, cov)
            loss.backward()
            return loss.detach()

    # The fingerprint ties a checkpoint to the fit setup; the step count,
    # cadences and paths may change across resumes.
    fingerprint = repr((
        fit_config.learning_rate, fit_config.optimizer, fit_config.engine, fit_config.loss,
        fit_config.pyramid_levels, fit_config.silhouette_weight, fit_config.silhouette_beta,
        render_config, describe(scene0), frozen,
    ))
    start_step, losses = 0, []
    if fit_config.checkpoint_dir:
        resume = _load_resume(fit_config.checkpoint_dir, fingerprint, device)
        if mesh is not None and mesh.size > 1:
            # Only rank 0 writes checkpoints, so its view is authoritative: a
            # rank that found none (or a stale one) would otherwise start at
            # another step and issue mismatched collectives, a hang.
            resume = _unpack_resume(broadcast_object(_pack_resume(resume) if mesh.rank == 0 else None, mesh),
                                    device)
        if resume is not None:
            state, start_step, losses = resume
            scene.load_state_dict(state["scene"])
            opt.load_state_dict(state["optimizer"])

    n_pixels = render_config.width * render_config.height
    ckpt_every = fit_config.checkpoint_every if fit_config.checkpoint_dir else 0
    chunk_cap = fit_config.chunk_steps or max(fit_config.log_every, 1)
    step, steps_run = start_step, 0
    t0 = time.perf_counter()
    while step < fit_config.steps:
        end = min(fit_config.steps, step + chunk_cap)
        if ckpt_every:
            end = min(end, ((step // ckpt_every) + 1) * ckpt_every)
        if replan is not None:
            # Chunks also end at re-plan boundaries, so new work-lists take
            # effect on schedule.
            end = min(end, ((step // fit_config.replan_every) + 1) * fit_config.replan_every)
        chunk = []
        for _ in range(step, end):
            opt.zero_grad(set_to_none=True)
            chunk.append(step_loss())
            opt.step()
        chunk_losses = torch.stack(chunk).tolist()  # one host sync per chunk
        steps_run += end - step
        if replan is not None and end < fit_config.steps and end % fit_config.replan_every == 0:
            replan()  # new equal-count work-lists from the current scene's work
        for i, loss_val in enumerate(chunk_losses):
            gstep = step + i
            if gstep % fit_config.log_every == 0 or gstep == fit_config.steps - 1:
                losses.append(loss_val)
                if logger is not None:
                    logger.log(step=gstep, loss=loss_val)
        step = end
        if ckpt_every and step % ckpt_every == 0:
            save_checkpoint(
                fit_config.checkpoint_dir, {"scene": scene.state_dict(), "optimizer": opt.state_dict()}, step,
                meta={"losses": [float(x) for x in losses], "fingerprint": fingerprint},
            )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    for leaf in leaf_list:
        leaf.requires_grad_(True)
    return FitResult(scene=scene, losses=losses, steps_run=steps_run,
                     rays_per_second=n_pixels * steps_run / max(elapsed, 1e-9))


def _coverage_missing() -> ValueError:
    return ValueError(
        "silhouette_weight > 0 needs an object mask: pass target_coverage, or set render_config.background so the "
        "mask can be inferred from non-background pixels")


def _coverage_rows(render_config: RenderConfig, target_coverage, device):
    """``coverage(rgb, rows)``: the silhouette term's coverage target (the
    rows' (R, W) float32 plane on ``device``) for the target rows ``rgb``
    (R, W, 3) of the absolute image ``rows``: ``target_coverage``'s rows (an
    array, or a callable of the rows), else the pixels whose largest channel
    differs from ``render_config.background`` by more than 1e-3 (JAX's
    rule).  Raises JAX's ``ValueError`` when there is neither."""
    if target_coverage is None:
        if render_config.background is None:
            raise _coverage_missing()
        bg = torch.tensor(render_config.background, dtype=torch.float32, device=device)
        return lambda rgb, rows: ((rgb - bg).abs().amax(-1) > 1e-3).to(torch.float32)
    if callable(target_coverage):
        return lambda rgb, rows: torch.as_tensor(np.asarray(target_coverage(rows), np.float32), device=device)
    cov = target_coverage if isinstance(target_coverage, torch.Tensor) else torch.from_numpy(
        np.array(target_coverage, np.float32))
    cov = cov.to(device, torch.float32)
    return lambda rgb, rows: cov[torch.from_numpy(np.asarray(rows)).to(device)]


def _load_resume(checkpoint_dir, fingerprint: str, device):
    """``(state, step, losses)`` of the checkpoint in ``checkpoint_dir`` when
    the same fit setup wrote it, else ``None`` (with a warning for another
    setup's)."""
    state, manifest = load_checkpoint(checkpoint_dir, map_location=device)
    if state is None:
        return None
    if manifest.get("fingerprint") != fingerprint:
        warnings.warn(
            f"checkpoint at {checkpoint_dir} was written by a different fit configuration; "
            "starting fresh (it will be overwritten)",
            stacklevel=3,
        )
        return None
    return state, int(manifest["step"]), list(manifest.get("losses", []))


def _pack_resume(resume):
    """A resume point as plain bytes for ``broadcast_object``."""
    if resume is None:
        return None
    state, step, losses = resume
    buf = io.BytesIO()
    torch.save(state, buf)
    return buf.getvalue(), step, losses


def _unpack_resume(packed, device):
    if packed is None:
        return None
    data, step, losses = packed
    return torch.load(io.BytesIO(data), map_location=device, weights_only=True), step, losses


def _run_chunks(step_loss, opt, fit_config: FitConfig, logger) -> tuple[list, int]:
    """Run ``fit_config.steps`` optimizer steps of ``step_loss`` (which sets
    the gradients and returns the loss on the device) in chunks, reading
    the losses once a chunk: ``(logged losses, steps run)``."""
    losses: list = []
    step = 0
    chunk_cap = fit_config.chunk_steps or max(fit_config.log_every, 1)
    while step < fit_config.steps:
        end = min(fit_config.steps, step + chunk_cap)
        chunk = []
        for _ in range(step, end):
            opt.zero_grad(set_to_none=True)
            chunk.append(step_loss())
            opt.step()
        for i, loss_val in enumerate(torch.stack(chunk).tolist()):  # one host sync per chunk
            gstep = step + i
            if gstep % fit_config.log_every == 0 or gstep == fit_config.steps - 1:
                losses.append(loss_val)
                if logger is not None:
                    logger.log(step=gstep, loss=loss_val)
        step = end
    return losses, step


def fit_scene_multiview(
    targets,
    scene0: SDFNode,
    cameras,
    light: PointLight,
    mat: Material,
    render_config: RenderConfig,
    fit_config: FitConfig = FitConfig(),
    logger: MetricsLogger | None = None,
    trainable=None,
    target_coverages=None,
    device="cuda",
    kernel_config: KernelConfig | None = None,
) -> FitResult:
    """Fit the scene's parameters against several views jointly (the port of
    JAX's ``fit_scene_multiview``): the loss is the sum of the views' pixel
    losses, so one view's depth/scale ambiguities are held by the others.

    ``targets``: V (H, W, 3) images; ``cameras``: V cameras.  The fused
    route runs one launch of the fit step a step for all V views
    (:func:`~sdf3d_tpu_torch.ops.fit_kernel.multiview_loss_and_grads`, K3's
    view axis); outside it (a pyramid deeper than the kernel's block, a
    neural scene) each view renders through the differentiable kernel
    render and its :func:`pixel_loss` is summed, as JAX's ``render_pallas``
    route; ``engine="torch"`` sums ``diff.render_diff``'s.  ``trainable``
    freezes scene leaves as in :func:`fit_scene`.
    ``fit_config.silhouette_weight > 0`` adds each view's coverage term
    (``diff.coverage`` on each view's rays outside the fused step): pass
    ``target_coverages`` (one (H, W) mask a view) or set
    ``render_config.background``.  Runs on ``device`` (the card unless
    ``"cpu"``: the kernels' plain versions); no checkpoints, as JAX's.
    ``rays_per_second`` counts W·H·V rays a step."""
    if len(targets) != len(cameras):
        raise ValueError(f"{len(targets)} targets vs {len(cameras)} cameras")
    if len(targets) == 0:
        raise ValueError("need at least one view")
    kc = kernel_config or KernelConfig()
    _check_supported(fit_config, render_config, None, scene0, kc)
    sil_w = fit_config.silhouette_weight
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_scene_multiview: no CUDA device; pass device='cpu' to run the kernels' plain versions")
    targets = [(t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t, np.float32)))
               .detach().to(device, torch.float32) for t in targets]
    covs = None
    if sil_w > 0.0:
        if target_coverages is None:
            rows = np.arange(render_config.height)
            covs = [_coverage_rows(render_config, None, device)(t, rows) for t in targets]
        else:
            if len(target_coverages) != len(targets):
                raise ValueError(f"{len(target_coverages)} coverage masks vs {len(targets)} targets")
            covs = [torch.as_tensor(np.asarray(c, np.float32) if not isinstance(c, torch.Tensor) else c)
                    .to(device, torch.float32) for c in target_coverages]
    scene, leaf_list, opt, frozen, set_grads = _trainable_scene(scene0, trainable, fit_config, device)
    cameras = [cam.to(device) for cam in cameras]
    light, mat = light.to(device), mat.to(device)
    loss_opts = dict(loss_kind=fit_config.loss, levels=fit_config.pyramid_levels, sil_w=sil_w,
                     sil_beta=fit_config.silhouette_beta)
    if _fused(fit_config, render_config, scene, kc):
        uni, target_planar, cov = multiview_inputs(render_config, cameras, light, mat, targets, device, covs)

        def step_loss():
            loss_, g_prm, _ = fit_step_kernel(scene, scene_param_vector(scene), uni, target_planar, render_config,
                                              kc, wrt_uniforms=False, frozen_slots=frozen, target_coverage=cov,
                                              **loss_opts)
            set_grads(g_prm)
            return loss_
    else:
        rays = [camera_rays(cam, render_config.width, render_config.height, render_config.ray_mode)
                for cam in cameras] if covs is not None else None

        def step_loss():
            loss = sum(pixel_loss(_diff_render(fit_config, render_config, kc, scene, cam, light, mat), tgt,
                                  fit_config.loss, fit_config.pyramid_levels)
                       for cam, tgt in zip(cameras, targets))
            if covs is not None:
                loss = loss + sum(_sil_term(fit_config, render_config, scene, o, d, cov)
                                  for (o, d), cov in zip(rays, covs))
            loss.backward()
            return loss.detach()

    t0 = time.perf_counter()
    losses, steps = _run_chunks(step_loss, opt, fit_config, logger)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    for leaf in leaf_list:
        leaf.requires_grad_(True)
    n_rays = render_config.width * render_config.height * len(cameras)
    return FitResult(scene=scene, losses=losses, steps_run=steps, rays_per_second=n_rays * steps / max(elapsed, 1e-9))


_VIEW_GROUPS = ("camera", "fov", "light", "material")


def fit_view(
    target,
    scene: SDFNode,
    camera0: Camera,
    light0: PointLight,
    mat0: Material,
    render_config: RenderConfig,
    fit_config: FitConfig = FitConfig(),
    optimize: tuple = ("camera",),
    logger: MetricsLogger | None = None,
    target_coverage=None,
    device="cuda",
    kernel_config: KernelConfig | None = None,
) -> ViewFitResult:
    """Fit the view (camera pose, field of view, light and/or material) to a
    target image (H, W, 3) with the scene fixed (the port of JAX's
    ``fit_view``).  ``optimize`` picks the groups:

    - ``"camera"``: the eye position and a rotation vector composed onto
      ``camera0.c2w`` (``rotvec_to_matrix(rv) @ c2w``: exactly orthonormal
      at every step, the identity at the start);
    - ``"fov"``: the vertical field of view (degrees);
    - ``"light"``: the light position and ambient intensity;
    - ``"material"``: ambient, diffuse, specular and shininess.

    A pose fit wants the silhouette term (``fit_config.silhouette_weight >
    0``, with ``target_coverage`` (H, W) or ``render_config.background`` for
    the mask): the pixel L2 alone misses the silhouettes' motion.  Where the
    fused fit step applies, each step is one launch of it with the uniforms'
    gradient (``wrt_uniforms=True``), pulled back to the parameters through
    the uniforms' packing and one ``backward``.  Elsewhere (a pyramid deeper
    than the kernel's block, say) the kernel engine renders through the
    differentiable kernel render (the render backward in its uniforms' form)
    and ``engine="torch"`` through ``diff.render_diff``, each plus
    ``diff.coverage``'s silhouette term on the view's rays, under autograd
    (JAX's route).  Losses are read once a chunk.  Runs on ``device`` (the
    card unless ``"cpu"``: the kernels' plain versions)."""
    from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix

    groups = set(optimize)
    unknown = groups - set(_VIEW_GROUPS)
    if unknown:
        raise ValueError(f"unknown optimize groups {sorted(unknown)}")
    if not groups:
        raise ValueError("optimize must select at least one parameter group")
    _check_engine(fit_config, render_config)
    kc = kernel_config or KernelConfig()
    sil_w = fit_config.silhouette_weight
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_view: no CUDA device; pass device='cpu' to run the kernels' plain versions")
    scene = copy.deepcopy(scene).to(device).requires_grad_(False)
    camera0, light0, mat0 = camera0.to(device), light0.to(device), mat0.to(device)
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, np.float32))
    target = target.detach().to(device, torch.float32)
    cov = None
    if sil_w > 0.0:
        cov = _coverage_rows(render_config, target_coverage, device)(target, np.arange(render_config.height))

    def leaf(x):
        return x.detach().clone().requires_grad_(True)

    params: dict = {}
    if "camera" in groups:
        params["cam_pos"] = leaf(camera0.position)
        params["cam_rotvec"] = torch.zeros(3, dtype=torch.float32, device=device, requires_grad=True)
    if "fov" in groups:
        params["fov_deg"] = leaf(camera0.fov_deg)
    if "light" in groups:
        params["light_pos"] = leaf(light0.position)
        params["light_ambient"] = leaf(light0.ambient)
    if "material" in groups:
        for name in ("ambient", "diffuse", "specular", "shininess"):
            params[f"mat_{name}"] = leaf(getattr(mat0, name))

    def build_view(p: dict):
        cam = camera0
        if "camera" in groups:
            rot = rotvec_to_matrix(p["cam_rotvec"])
            # The 3×3 product written out (a matrix product may run in
            # reduced precision on the card).
            c2w = (rot[:, :, None] * camera0.c2w[None, :, :]).sum(1)
            cam = Camera(position=p["cam_pos"], c2w=c2w, fov_deg=cam.fov_deg)
        if "fov" in groups:
            cam = dataclasses.replace(cam, fov_deg=p["fov_deg"])
        light = light0
        if "light" in groups:
            light = dataclasses.replace(light, position=p["light_pos"], ambient=p["light_ambient"])
        mat = mat0
        if "material" in groups:
            mat = Material(ambient=p["mat_ambient"], diffuse=p["mat_diffuse"], specular=p["mat_specular"],
                           shininess=p["mat_shininess"])
        return cam, light, mat

    opt = _make_optimizer(fit_config, list(params.values()))
    if _fused(fit_config, render_config, scene, kc):
        prm = scene_param_vector(scene, device)
        target_planar = target.permute(2, 0, 1).contiguous()
        k_slot = torch.zeros(30, dtype=torch.float32, device=device)
        k_slot[_U_K] = float(render_config.shadow.k)
        loss = dict(loss_kind=fit_config.loss, levels=fit_config.pyramid_levels, sil_w=sil_w,
                    sil_beta=fit_config.silhouette_beta, target_coverage=cov)

        def step_loss():
            with torch.enable_grad():
                uni = pack_uniforms(*build_view(params), render_config.ray_mode, detach=False) + k_slot
            loss_, _, g_uni = fit_step_kernel(scene, prm, uni.detach(), target_planar, render_config, kc,
                                              wrt_uniforms=True, **loss)
            uni.backward(g_uni)
            return loss_
    else:
        def step_loss():
            cam, light, mat = build_view(params)
            img = _diff_render(fit_config, render_config, kc, scene, cam, light, mat)
            loss_ = pixel_loss(img, target, fit_config.loss, fit_config.pyramid_levels)
            if cov is not None:
                o, d = camera_rays(cam, render_config.width, render_config.height, render_config.ray_mode)
                loss_ = loss_ + _sil_term(fit_config, render_config, scene, o, d, cov)
            loss_.backward()
            return loss_.detach()

    losses, step = _run_chunks(step_loss, opt, fit_config, logger)
    with torch.no_grad():
        cam, light, mat = (type(o)(*(getattr(o, f.name).detach() for f in dataclasses.fields(o)))
                           for o in build_view(params))
    return ViewFitResult(camera=cam, light=light, mat=mat, losses=losses, steps_run=step)
