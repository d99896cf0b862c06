"""Inverse rendering: fit scene parameters to a target image (the port of
``sdf3d_tpu/fit.py``).

Each step renders, takes the pixel loss and its gradient, and updates the
scene with a ``torch.optim`` optimizer.  ``engine="kernel"`` (the only one
ported) takes one of two routes, as the JAX package's ``engine="pallas"``
does:

- the fused fit step (``ops/fit_kernel.py``, one kernel launch per step)
  when :func:`~sdf3d_tpu_torch.ops.fit_kernel.fused_l2_eligible` holds (the
  plain L2 loss);
- otherwise the differentiable kernel render (``ops/render_autograd.py``:
  forward kernel, backward kernel) and :func:`pixel_loss` under autograd
  (the multiscale loss).

With a ``mesh`` (``parallel/``) the fused step is sharded: each rank runs
K3 on its rows (the contiguous and interleaved layouts) or K4 on its tile
work-list (the tile queue), loss and gradients are all-reduced once a step,
and the optimizer runs replicated on every rank.

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

from sdf3d_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel, fit_step_kernel_tiles, fused_l2_eligible, with_rows
from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
from sdf3d_tpu_torch.ops.render_kernel import _U_K, KernelConfig, pack_uniforms
from sdf3d_tpu_torch.ops.scene_program import describe, has_neural, leaves, scene_param_vector
from sdf3d_tpu_torch.parallel import launch
from sdf3d_tpu_torch.parallel.collectives import broadcast_object, check_allreduce
from sdf3d_tpu_torch.parallel.mesh import Mesh
from sdf3d_tpu_torch.parallel.shard_render import LAYOUTS, fused_loss_and_grad_sharded, row_layout
from sdf3d_tpu_torch.parallel.tile_queue import estimate_tile_work, gather_target_tiles, plan_tiles, pool_work_to_tiles
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
    #: "kernel": the CUDA kernels (their plain versions on a CPU device).
    #: "xla" (the JAX package's implicit-VJP ray renderer, ``diff.py``) is
    #: not ported yet and raises ``NotImplementedError``.
    engine: str = "kernel"
    #: "l2", or "multiscale": L2 summed over an average-pool pyramid.
    loss: str = "l2"
    pyramid_levels: int = 3
    #: Steps per chunk (losses are read once per chunk); 0 = ``log_every``.
    #: Chunks also end at checkpoint boundaries.
    chunk_steps: int = 0
    #: The soft-silhouette coverage term; only 0 is ported (ROADMAP item 12).
    silhouette_weight: float = 0.0
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


def _make_optimizer(cfg: FitConfig, params) -> torch.optim.Optimizer:
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _check_supported(fit_config: FitConfig, render_config: RenderConfig, mesh, target_coverage, scene0) -> None:
    """Raise for what the port's fit does not do yet (before any work)."""
    if has_neural(scene0):
        raise NotImplementedError("fitting a NeuralSDF scene waits for diff.py's implicit VJP (ROADMAP item 5)")
    if fit_config.engine == "xla":
        raise NotImplementedError("engine='xla' (diff.py's render_rays_diff) is not ported yet (ROADMAP item 5)")
    if fit_config.engine != "kernel":
        raise ValueError(f"unknown engine {fit_config.engine!r}; choose 'kernel'")
    if fit_config.silhouette_weight > 0.0 and render_config.march.relaxation != 1.0:
        # JAX's min-SDF tracker marches unrelaxed (its _march_primary(track_min=True)).
        raise ValueError("min-SDF tracking requires march.relaxation == 1.0")
    if fit_config.silhouette_weight > 0.0 or target_coverage is not None:
        raise NotImplementedError("the silhouette coverage term is not ported yet (ROADMAP item 12)")
    if render_config.shadow.enabled and render_config.shadow.grad != "detach":
        raise NotImplementedError(
            f"shadow.grad == {render_config.shadow.grad!r} is not ported yet (ROADMAP item 12)")
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
        if not fused_l2_eligible(render_config, scene0, fit_config.loss, fit_config.silhouette_weight):
            raise NotImplementedError(
                f"sharded fits run the fused L2 fit step; loss={fit_config.loss!r} under a mesh is not ported "
                "yet (ROADMAP item 15b)")


def _resolve_layout(fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig, n: int) -> str:
    """The layout of a sharded fit (JAX's ``fit.py::_resolve_layout``)."""
    layout = fit_config.shard_layout
    if layout != "auto":
        return layout
    if fit_config.shard_interleaved:
        return "interleaved"
    if n >= 16 and render_config.height % kc.tile_h == 0 and render_config.width % kc.tile_w == 0:
        return "tiles"
    return "contiguous"


def _sharded_step(mesh: Mesh, fit_config: FitConfig, render_config: RenderConfig, kc: KernelConfig, scene, uni,
                  target, camera, light, frozen: tuple):
    """The per-step ``(loss, [g_prm])`` of a sharded fit, summed over the
    mesh, and the re-plan callable of a balanced tile queue (``None``
    otherwise).  Each rank prepares only its own share: its rows' target and
    row slots, or its work-list's tables and target stack.  The sums stay in
    float64 through the all-reduce and are rounded to float32 once, so every
    layout and world size rounds the same totals alike."""
    H, W = render_config.height, render_config.width
    layout = _resolve_layout(fit_config, render_config, kc, mesh.size)
    replan = None
    if layout == "tiles":
        if callable(target):
            raise ValueError("shard_layout='tiles' gathers tile stacks from a target array, not a row loader")
        target_planar = target.permute(2, 0, 1)
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
            loss, g_prm, _ = fit_step_kernel_tiles(scene, scene_param_vector(scene), uni, stack, trow, tcol,
                                                   render_config, kc, wrt_uniforms=False, frozen_slots=frozen,
                                                   sum_dtype=torch.float64)
            return loss, [g_prm]

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
        slab_target = torch.as_tensor(rows_rgb, dtype=torch.float32).to(mesh.device).permute(2, 0, 1).contiguous()
        slab_uni = with_rows(uni, row0, rowstride)

        def vag():
            loss, g_prm, _ = fit_step_kernel(scene, scene_param_vector(scene), slab_uni, slab_target, slab_cfg, kc,
                                             wrt_uniforms=False, frozen_slots=frozen, sum_dtype=torch.float64)
            return loss, [g_prm]

    return fused_loss_and_grad_sharded(vag, mesh, fit_config.allreduce), replan


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
    block and tile (``KernelConfig``).  ``target_coverage`` belongs to a
    part not ported yet and raises ``NotImplementedError``.

    ``mesh`` (``parallel.make_mesh()``): shard the fit over its ranks, on
    ``mesh.device`` (``device`` is then not read), in the layout
    ``fit_config.shard_layout`` picks (:class:`FitConfig`).  Every rank calls
    ``fit_scene`` with the same arguments and gets the same result.  Under a
    row layout ``target`` may be a callable ``(abs_rows) -> (len(abs_rows),
    W, 3)`` so a rank loads only its rows.  Only rank 0 logs and writes
    checkpoints; on resume rank 0's state, step and losses are broadcast.
    """
    _check_supported(fit_config, render_config, mesh, target_coverage, scene0)
    kc = kernel_config or KernelConfig()
    device = mesh.device if mesh is not None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_scene: no CUDA device; pass device='cpu' to run the kernels' plain versions")
    if mesh is not None and not launch.is_primary():
        logger = None  # exactly one metrics writer (checkpoint.py gates its own)
    scene = copy.deepcopy(scene0).to(device)
    leaf_list = list(leaves(scene))
    flags = [True] * len(leaf_list) if trainable is None else [bool(x) for x in trainable]
    frozen = _frozen_param_slots(scene0, trainable)
    if not any(flags):
        raise ValueError("trainable freezes every scene parameter")
    for leaf, tr in zip(leaf_list, flags):
        leaf.requires_grad_(tr)
    camera, light, mat = camera.to(device), light.to(device), mat.to(device)
    if callable(target) and mesh is None:
        raise TypeError("a row-loader target (a callable) needs a mesh; pass the (H, W, 3) image")
    if not callable(target):
        if not isinstance(target, torch.Tensor):
            target = torch.from_numpy(np.array(target, np.float32))
        target = target.detach().to(device, torch.float32)
    opt = _make_optimizer(fit_config, [leaf for leaf, tr in zip(leaf_list, flags) if tr])
    sizes = [int(leaf.numel()) for leaf in leaf_list]

    def set_grads(g_prm):
        for leaf, g, tr in zip(leaf_list, torch.split(g_prm, sizes), flags):
            if tr:
                leaf.grad = g.view_as(leaf)

    replan = None
    if fused_l2_eligible(render_config, scene, fit_config.loss, fit_config.silhouette_weight):
        uni = pack_uniforms(camera, light, mat, render_config.ray_mode, device)
        uni[_U_K] = float(render_config.shadow.k)
        if mesh is not None:
            sharded, replan = _sharded_step(mesh, fit_config, render_config, kc, scene, uni, target, camera, light,
                                            frozen)

            def step_loss():
                loss, (g_prm,) = sharded()
                set_grads(g_prm.to(torch.float32))
                return loss.to(torch.float32)
        else:
            target_planar = target.permute(2, 0, 1).contiguous()

            def step_loss():
                loss, g_prm, _ = fit_step_kernel(scene, scene_param_vector(scene), uni, target_planar,
                                                 render_config, kc, wrt_uniforms=False, frozen_slots=frozen)
                set_grads(g_prm)
                return loss
    else:
        def step_loss():
            img = render_kernel_diff(render_config, kc, scene, camera, light, mat)
            loss = pixel_loss(img, target, fit_config.loss, fit_config.pyramid_levels)
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


def fit_scene_multiview(*args, **kwargs):
    """Fit against several views jointly: the multiview fit-kernel variant
    is not ported yet (ROADMAP item 12)."""
    raise NotImplementedError("fit_scene_multiview is not ported yet (ROADMAP item 12)")


def fit_view(*args, **kwargs):
    """Fit camera, light and material with the scene fixed: the fit kernel's
    uniform gradients exist (``fit_step_kernel(wrt_uniforms=True)``), the
    entry point is not ported yet (ROADMAP item 12)."""
    raise NotImplementedError("fit_view is not ported yet (ROADMAP item 12)")
