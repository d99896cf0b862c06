"""The fused fit step (the port of ``sdf3d_tpu/ops/fit_kernel.py``).

One fit step of inverse rendering: the loss ``Σ (rgb − target)²`` of a
render and its gradient with respect to the scene parameters (and, with
``wrt_uniforms``, the 30 uniforms).  Two implementations of the same
function:

- the CUDA kernel (``csrc/fit_kernel.cu``), launched by
  :func:`fit_step_kernel` for tensors on the card: per pixel the render
  kernel's primal, the residual and the hand-written reverse pass of the
  shading (``csrc/shade_vjp.cuh``) over the same primal, a partial row a
  block, and their float64 totals in a fixed order from a second small
  kernel launched by the same C call: one call a step, no image written to
  device memory and no sum on the host;
- :func:`fit_step_kernel_plain`, whole-image PyTorch code: the primal under
  ``no_grad`` (``render_kernel_forward_plain``), then autograd through
  ``shade_planes`` for the loss.  The wrapper runs it for tensors on the
  CPU; the tests and ``chip_smoke.py`` hold the kernel against it.

The tile-queue fit step (K4, ``sdf3d_fit_step_tiles`` in the same source) is
the same step over a work-list of tiles (:func:`fit_step_kernel_tiles`,
:func:`fit_step_kernel_tiles_plain`, :func:`l2_loss_and_grads_tiles`): the
target is the stack of the tiles' target blocks, and the mask compares
absolute pixels with the full image, so a plan's dummy tiles add exact
zeros.  A rank of a row-sharded fit runs K3 on its rows through the
``row0``/``rowstride`` uniforms.

``frozen_slots`` (parameter slots whose gradient reads exactly 0) and
``wrt_uniforms`` are static settings of the kernel, compiled into its
generated header as they are static ``jit`` arguments in JAX.  So are the
loss's two branches, JAX's own (``loss_kind``/``levels``, ``sil_w``): the
multiscale pyramid (``Fit::levels``: each block pools its aligned
``2**levels`` groups, so the block and the tile must be multiples of them,
:func:`fused_l2_eligible`) and the silhouette coverage term
(``Fit::silhouette``: the march tracks each ray's minimum distance, the
gradient re-attaches at its argmin).  The silhouette's weight and softness
are launch arguments; the plain version pools with :func:`pyramid_loss` and
takes the coverage term's envelope gradient by autograd.

The multi-view fit step (JAX's ``multiview=True``, the hot path of
``fit_scene_multiview``) is the same K3 over V views in one launch: given
a (V, 30) ``uni`` and a (V, 3, H, W) target, :func:`fit_step_kernel`
launches a grid whose third axis is the view (V a launch argument, so the
libraries of one view serve it), each view's float64 totals summed in K3's
order for that view alone; the loss and the scene gradient are then summed
over the views in view order, the uniforms' gradient stays per view
(:func:`multiview_loss_and_grads`).  Its plain version is the single view's
in a loop over the views (:func:`fit_step_views_plain`).

K9, the benchmark variants of the fit step (the port of
``benchmarks/exp_ad.py::make_variant``), is the same kernel function compiled
with another ``Fit::variant`` (:data:`VARIANTS`, :func:`fit_step_variant`,
:func:`fit_step_variant_plain`): ``full`` is K3, the others cut its tile
program down to time its fixed cost.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.ops.render_bwd_kernel import shade_planes
from sdf3d_tpu_torch.ops.render_kernel import (
    _U_K,
    _U_ROW0,
    _U_ROWSTRIDE,
    N_UNIFORMS,
    KernelConfig,
    check_plane,
    check_settings,
    check_tables,
    kernel_library,
    pack_uniforms,
    pixel_planes,
    primary_min_sdf_plain,
    ray_planes,
    render_kernel_forward_plain,
    tile_pixel_planes,
)
from sdf3d_tpu_torch.ops.scene_program import (
    FIT_VARIANTS,
    check_scene,
    compile_scene,
    count_params,
    has_emitters,
    leaves,
    scene_param_vector,
)
from sdf3d_tpu_torch.sdf.node import SDFNode


def fused_l2_eligible(cfg: RenderConfig, scene: SDFNode, loss: str = "l2", levels: int = 3, sil_w: float = 0.0,
                      kc: KernelConfig | None = None) -> bool:
    """True when the fused fit step applies (JAX's rules): detached-shadow
    gradients, central or tetrahedron normals, and a scene every node of
    which has an emitter.  The loss terms narrow it further:

    - ``loss == "multiscale"``: a pyramid group of ``2**levels`` pixels a
      side lies inside one block and one tile, so the block (``kc.block_w``,
      ``kc.block_h``) and the tile (``kc.tile_h``, ``kc.tile_w``) are
      multiples of it: ``levels <= 3`` at the defaults (32×8 blocks, 24×640
      tiles), JAX's rule at its default tile;
    - ``sil_w > 0`` (the silhouette coverage term): the min-SDF tracker
      marches exactly, so ``march.relaxation == 1.0``."""
    if loss == "multiscale":
        if not _pyramid_fits(kc or KernelConfig(), levels):
            return False
    elif loss != "l2":
        return False
    if sil_w > 0.0 and cfg.march.relaxation != 1.0:
        return False
    if cfg.shadow.enabled and cfg.shadow.grad != "detach":
        return False
    return cfg.normals in ("central", "tetrahedron") and has_emitters(scene)


def _pyramid_fits(kc: KernelConfig, levels: int) -> bool:
    """Whether a pyramid group of ``2**levels`` pixels a side lies inside one
    block and one tile of ``kc``."""
    return not any(x % (1 << levels) for x in (kc.block_w, kc.block_h, kc.tile_h, kc.tile_w))


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 mean pool of the last two axes, an odd last row or column dropped:
    ``0.25·((a00 + a10) + (a01 + a11))``, rows first (the kernel's order and
    that of JAX's pooling products)."""
    x = x[..., :x.shape[-2] // 2 * 2, :x.shape[-1] // 2 * 2]
    rows = x[..., 0::2, :] + x[..., 1::2, :]
    return 0.25 * (rows[..., 0::2] + rows[..., 1::2])


def pyramid_loss(res: torch.Tensor, real: torch.Tensor, levels: int) -> torch.Tensor:
    """The multiscale pyramid's terms of the loss: for ``l = 1..levels``,
    ``4**l · Σ valid·|mean|²`` over the 2×2-mean-pooled residual planes
    ``res`` (3, R, C) and the pooled ``real`` mask (R, C), a pooled group
    valid iff all its pixels are real (JAX's ``_fit_tile_kernel``: XLA
    ``pixel_loss``'s recursive odd-edge cropping)."""
    loss = torch.zeros((), dtype=res.dtype, device=res.device)
    for level in range(1, levels + 1):
        res, real = _pool2(res), _pool2(real)
        valid = (real > 0.999).to(res.dtype)
        loss = loss + (4.0**level) * torch.sum(valid * (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]))
    return loss


def _check_loss(loss_kind: str, sil_w: float, coverage) -> None:
    if loss_kind not in ("l2", "multiscale"):
        raise ValueError(f"unknown loss {loss_kind!r}")
    if sil_w > 0.0 and coverage is None:
        raise ValueError("sil_w > 0 needs target_coverage")


def _sil_beta(cfg: RenderConfig, sil_beta) -> float:
    """The coverage sigmoid's softness: ``sil_beta``, else ``epsilon/2.5``."""
    return cfg.march.epsilon / 2.5 if sil_beta is None else float(sil_beta)


def _fit_step_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, pixels, mask=None, planes=None,
                    power=torch.pow, levels=0, coverage=None, sil_w=0.0, sil_beta=None):
    """The plain fit step on the absolute ``pixels`` planes, the residual
    times ``mask`` where given.  ``planes``: the (t, shadow, ao) planes to
    shade, else the plain primal's; ``power``: as ``shade_planes``.
    ``levels``: the multiscale pyramid's depth (0: none); ``coverage``: the
    coverage target of the silhouette term (``sil_w``, ``sil_beta``), whose
    gradient re-attaches at the argmin distance ``t_min`` as data
    (``f_min − f_min.detach() + min_s``: autograd gives the envelope
    gradient)."""
    if planes is None:
        planes = render_kernel_forward_plain(scene, prm, uni, cfg, kc, pixels)[1:]
    t, shadow, ao = planes
    prm_ = prm.detach().requires_grad_(True)
    uni_ = uni.detach().requires_grad_(wrt_uniforms)
    real = torch.ones_like(t) if mask is None else mask
    with torch.enable_grad():
        res = shade_planes(prm_, uni_, t, shadow, ao, scene, cfg, pixels, power) - target
        if mask is not None:
            res = res * mask
        loss = torch.sum(res * res)
        if levels:
            loss = loss + pyramid_loss(res, real, levels)
        if coverage is not None:
            min_s, t_min = primary_min_sdf_plain(scene, prm, uni, cfg, kc, pixels)
            (ox, oy, oz), (dx, dy, dz) = ray_planes(uni_, *t.shape, cfg, pixels)
            f_min = compile_scene(scene)(ox + t_min * dx, oy + t_min * dy, oz + t_min * dz, lambda i: prm_[i])
            min_att = f_min - f_min.detach() + min_s
            cov = torch.sigmoid((2.0 * cfg.march.epsilon - min_att) / _sil_beta(cfg, sil_beta))
            loss = loss + sil_w * torch.sum(real * (cov - coverage) ** 2)
        grads = torch.autograd.grad(loss, (prm_, uni_) if wrt_uniforms else (prm_,))
    g_prm = grads[0]
    if frozen_slots:
        g_prm[list(frozen_slots)] = 0.0
    g_uni = grads[1] if wrt_uniforms else torch.zeros_like(uni)
    return loss.detach(), g_prm, g_uni


def fit_step_views_plain(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                         cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                         frozen_slots: tuple = (), *, loss_kind: str = "l2", levels: int = 3, sil_w: float = 0.0,
                         sil_beta=None, target_coverage=None):
    """Plain PyTorch version of the multi-view fit step: each view's
    ``(loss, g_prm, g_uni)`` (:func:`fit_step_kernel_plain` on its uniforms
    ``uni[v]``, target ``target[v]`` and coverage ``target_coverage[v]``),
    as float64 tensors of shapes (V,), (V, P) and (V, 30): the kernel's
    per-view totals."""
    views = []
    for v in range(uni.shape[0]):
        cov = target_coverage[v] if sil_w > 0.0 and target_coverage is not None else None
        views.append(fit_step_kernel_plain(scene, prm, uni[v], target[v], cfg, kc, wrt_uniforms, frozen_slots,
                                           loss_kind=loss_kind, levels=levels, sil_w=sil_w, sil_beta=sil_beta,
                                           target_coverage=cov))
    return tuple(torch.stack([x[k].to(torch.float64) for x in views]) for k in range(3))


def sum_views(loss: torch.Tensor, g_prm: torch.Tensor, g_uni: torch.Tensor, sum_dtype=torch.float32):
    """``(loss, g_prm (P,), g_uni (V, 30))`` in ``sum_dtype`` from per-view
    float64 values (V,), (V, P), (V, 30): the loss and the scene gradient
    summed over the views in view order, in float64 (JAX's ``per_view``
    reduction); the uniforms' gradient stays per view."""
    total_loss, total_prm = loss[0], g_prm[0]
    for v in range(1, loss.shape[0]):
        total_loss, total_prm = total_loss + loss[v], total_prm + g_prm[v]
    return total_loss.to(sum_dtype), total_prm.to(sum_dtype), g_uni.to(sum_dtype)


def _levels(loss_kind: str, levels: int) -> int:
    """The pyramid's depth of a loss: ``levels`` for the multiscale loss, 0
    for the plain L2."""
    return int(levels) if loss_kind == "multiscale" else 0


def fit_step_kernel_plain(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                          cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                          frozen_slots: tuple = (), *, loss_kind: str = "l2", levels: int = 3, sil_w: float = 0.0,
                          sil_beta=None, target_coverage=None):
    """Plain PyTorch version of the fit step: ``(loss, g_prm (P,), g_uni
    (30,))`` for the planar target (3, H, W).  ``g_uni`` is zeros unless
    ``wrt_uniforms``; the ``frozen_slots`` of ``g_prm`` are exactly 0.
    ``loss_kind="multiscale"`` adds the pyramid of ``levels`` levels;
    ``sil_w > 0`` the silhouette coverage term against ``target_coverage``
    (H, W), softness ``sil_beta`` (default ``epsilon/2.5``)."""
    _check_loss(loss_kind, sil_w, target_coverage)
    pixels = pixel_planes(uni, cfg.height, cfg.width, kc.tile_h)
    return _fit_step_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, pixels,
                           levels=_levels(loss_kind, levels), coverage=target_coverage if sil_w > 0.0 else None,
                           sil_w=sil_w, sil_beta=sil_beta)


def fit_step_kernel_tiles_plain(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                                trow: torch.Tensor, tcol: torch.Tensor, cfg: RenderConfig,
                                kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = False,
                                frozen_slots: tuple = (), *, loss_kind: str = "l2", levels: int = 3,
                                sil_w: float = 0.0, sil_beta=None, coverage_tiles=None):
    """Plain PyTorch version of the tile-queue fit step (K4): ``(loss,
    g_prm, g_uni)`` over the work-list ``trow``/``tcol`` for the target
    stack (3, T·TH, TW), the residual masked to the pixels inside the full
    image ``cfg`` (absolute coordinates: a dummy tile adds exact zeros).
    The loss options as :func:`fit_step_kernel_plain`, ``coverage_tiles``
    the coverage target's stack (T·TH, TW)."""
    _check_loss(loss_kind, sil_w, coverage_tiles)
    rows, cols = pixels = tile_pixel_planes(trow, tcol, kc.tile_h, kc.tile_w)
    mask = ((rows < cfg.height) & (cols < cfg.width)).to(torch.float32)
    return _fit_step_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, pixels, mask,
                           levels=_levels(loss_kind, levels), coverage=coverage_tiles if sil_w > 0.0 else None,
                           sil_w=sil_w, sil_beta=sil_beta)


def _split_totals(totals: torch.Tensor, P: int, sum_dtype):
    """``(loss, g_prm, g_uni)`` in ``sum_dtype`` from the kernel's float64
    totals (``(g_prm, g_uni, loss)``; ``g_uni`` reads 0 unless the kernel
    takes the uniforms' gradient): slices, no copy for float64.  The totals
    are summed in an order fixed by block and thread index, so a layout's
    blocks, which cover the same pixels in another order, give the same
    totals to float64's rounding."""
    total = totals.to(sum_dtype)
    return total[-1], total[:P], total[P:P + N_UNIFORMS]


def fit_columns(lib) -> tuple:
    """``(columns, live)`` of a fit library (its ``sdf3d_fit_columns``): the
    totals' columns (P + 31, or 1 for a loss-only variant) and a partial
    row's (those a block sums: dU only with the uniforms' gradient, no
    frozen slot), as its static settings made them."""
    cols = getattr(lib, "fit_columns_", None)
    if cols is None:
        out = (ctypes.c_int * 2)()
        lib.sdf3d_fit_columns(out)
        cols = lib.fit_columns_ = tuple(out)
    return cols


def _fit_buffers(lib, n_blocks: int, dev: torch.device, views: int = 0):
    """``(partials, rows, totals, stream)`` of a launch on ``dev``'s current
    stream: the partial rows as the kernel stores them, by column
    (``(live, n_blocks)`` padded to a multiple of 4 rows, float32), the
    same rows as an ``(n_blocks, live)`` view, and the totals
    (``(columns,)`` float64; :func:`fit_columns`).  ``views > 0``: a
    multi-view launch, each view's rows padded and its totals a row:
    ``(views, n_blocks, live)`` rows, ``(views, columns)`` totals."""
    cols, live = fit_columns(lib)
    ld = -(-n_blocks // 4) * 4
    partials = torch.empty((live, max(views, 1) * ld), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if views:
        totals = torch.empty((views, cols), dtype=torch.float64, device=dev)
        return partials, partials.view(live, views, ld)[:, :, :n_blocks].permute(1, 2, 0), totals, stream
    totals = torch.empty((cols,), dtype=torch.float64, device=dev)
    return partials, partials[:, :n_blocks].t(), totals, stream


def fit_launcher(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, variant="full", levels=0,
                 coverage=None, sil_w=0.0, sil_beta=0.0):
    """``(launch, partials, totals)`` of the fit kernel (K3, or a benchmark
    ``variant`` of it) on ``prm``'s card: the library loaded and the inputs
    checked once, the partial rows (one per block, the live columns; an
    ``(n_blocks, live)`` view of the kernel's store by column) and the
    float64 totals allocated; each ``launch()`` enqueues the kernel and its
    total on the stream that was current when the launcher was made and
    returns the totals (the caller makes ``prm``'s card the current
    device).  ``levels``: the pyramid's depth (0: none); ``coverage``: the
    coverage target (H, W) of the silhouette term, weight ``sil_w`` and
    softness ``sil_beta`` (launch arguments; ``None``: no term).  A (V, 30)
    ``uni`` launches the V views at once (K3's view axis): ``target`` (V,
    3, H, W) (stored as (3, V, H, W): a transposed view of such a tensor
    is read in place, anything else copied once), ``coverage`` (V, H, W),
    partial rows ``(V, n_blocks, live)`` and totals ``(V, P + 31)``, each
    view's own.  Raises for inputs it does not take and on any launch
    error; never falls back."""
    silhouette = coverage is not None
    views = int(uni.shape[0]) if uni.dim() == 2 else 0
    dev = prm.device
    if views:
        check_plane("uni", uni, (views, N_UNIFORMS), dev)
    lib = kernel_library(scene, prm, uni[0] if views else uni, cfg, kc, wrt_uniforms, frozen_slots, variant,
                         levels, silhouette)
    H, W = cfg.height, cfg.width
    lead = (views,) if views else ()
    if views:
        if tuple(target.shape) != (views, 3, H, W):
            raise ValueError(f"target must be of shape {(views, 3, H, W)} for {views} views; got {tuple(target.shape)}")
        target = target.transpose(0, 1).contiguous()
        check_plane("target", target, (3, views, H, W), dev)
    else:
        check_plane("target", target, (3, H, W), dev)
    if silhouette:
        check_plane("target_coverage", coverage, lead + (H, W), dev)
    partials, rows, totals, stream = _fit_buffers(lib, -(-W // kc.block_w) * -(-H // kc.block_h), dev, views)
    args = (uni.data_ptr(), prm.data_ptr(), target[0].data_ptr(), target[1].data_ptr(), target[2].data_ptr(),
            coverage.data_ptr() if silhouette else None, ctypes.c_float(sil_w), ctypes.c_float(sil_beta),
            partials.data_ptr(), totals.data_ptr(), H, W, max(views, 1), stream)

    def launch():
        err = lib.sdf3d_fit_step(*args)
        if err != 0:
            raise RuntimeError(f"sdf3d_fit_step ({variant}) launch failed: CUDA error {err}")
        return totals
    launch.inputs = (uni, prm, target, coverage, partials)  # ``args`` holds their addresses: keep them alive
    return launch, rows, totals


def _launch_totals(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, variant="full", **loss):
    """Launch the fit kernel once (:func:`fit_launcher`, ``loss`` its loss
    options) on ``prm``'s card: its float64 totals."""
    with torch.cuda.device(prm.device):
        return fit_launcher(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, variant, **loss)[0]()


def _launch_loss(cfg: RenderConfig, loss_kind, levels, sil_w, sil_beta, coverage) -> dict:
    """The loss options of :func:`fit_launcher` from the wrappers' ones."""
    on = sil_w > 0.0
    return dict(levels=_levels(loss_kind, levels), coverage=coverage.contiguous() if on else None,
                sil_w=float(sil_w) if on else 0.0, sil_beta=_sil_beta(cfg, sil_beta) if on else 0.0)


def fit_step_kernel_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                           cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                           frozen_slots: tuple = (), sum_dtype=torch.float32, *, loss_kind: str = "l2",
                           levels: int = 3, sil_w: float = 0.0, sil_beta=None, target_coverage=None):
    """Launch the CUDA fit step on ``prm``'s card and return ``(loss,
    g_prm, g_uni)`` in ``sum_dtype`` (:func:`_split_totals`; for V views
    :func:`sum_views` of the per-view totals); the loss options as
    :func:`fit_step_kernel`.  Raises for inputs it does not take and on any
    launch error; never falls back."""
    _check_loss(loss_kind, sil_w, target_coverage)
    frozen_slots = tuple(sorted(set(frozen_slots)))
    totals = _launch_totals(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots,
                            **_launch_loss(cfg, loss_kind, levels, sil_w, sil_beta, target_coverage))
    fit_step_kernel.launches += 1
    P = count_params(scene)
    if uni.dim() == 2:
        return sum_views(totals[:, -1], totals[:, :P], totals[:, P:P + N_UNIFORMS], sum_dtype)
    return _split_totals(totals, P, sum_dtype)


def _check_fused(scene: SDFNode, cfg: RenderConfig, loss_kind: str = "l2", levels: int = 3, sil_w: float = 0.0,
                 kc: KernelConfig | None = None) -> None:
    check_scene(scene)  # a node without an emitter (a VoxelGrid): named
    check_settings(cfg)  # autodiff normals: ValueError, as JAX's Pallas path
    if sil_w > 0.0 and cfg.march.relaxation != 1.0:
        raise ValueError("min-SDF tracking requires march.relaxation == 1.0")
    kc = kc or KernelConfig()
    if loss_kind == "multiscale" and not _pyramid_fits(kc, levels):
        raise ValueError(f"fused multiscale needs the block and tile dims divisible by 2^levels "
                         f"(block {(kc.block_w, kc.block_h)}, tile {(kc.tile_h, kc.tile_w)} vs levels={levels})")
    if not fused_l2_eligible(cfg, scene, loss_kind, levels, sil_w, kc):
        raise NotImplementedError(
            "the fused fit step takes detached-shadow gradients and central or tetrahedron normals, on scenes "
            "whose every node has an emitter (ops/scene_program.py::check_scene names the first that has none); "
            "shadow.grad == 'ad' re-marches the shadow in the differentiable render (ops.render_kernel_diff), "
            "which fit_scene, fit_view and fit_scene_multiview take for it")


def with_rows(uni: torch.Tensor, row0=None, rowstride=None) -> torch.Tensor:
    """``uni``, or a copy of it with the row slots set: ``row0`` (slot 28,
    the absolute row of launch row 0) and ``rowstride`` (slot 29, the
    absolute rows between successive tile rows; 0 reads the tile height),
    where given.  A rank of a row-sharded fit passes its layout's values, as
    JAX's ``slab_vag``."""
    if row0 is None and rowstride is None:
        return uni
    uni = uni.clone()
    if row0 is not None:
        uni[..., _U_ROW0] = float(row0)
    if rowstride is not None:
        uni[..., _U_ROWSTRIDE] = float(rowstride)
    return uni


def fit_step_kernel(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                    cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                    frozen_slots: tuple = (), row0=None, rowstride=None, sum_dtype=torch.float32, *,
                    loss_kind: str = "l2", levels: int = 3, sil_w: float = 0.0, sil_beta=None,
                    target_coverage=None):
    """Fused fit step: ``(loss, g_prm (P,), g_uni (30,))`` of
    ``Σ (render − target)²`` for the planar target (3, H, W), from the
    parameter vector ``prm`` and the uniforms ``uni``.  ``row0`` and
    ``rowstride`` set the row slots (:func:`with_rows`): a row slab of a
    sharded fit, ``cfg.height`` its rows and ``cfg.ndc_height`` the image's.
    ``sum_dtype``: the type of the sums (a sharded fit keeps float64 until
    its all-reduce).  The loss terms of JAX's ``fit_step_kernel``:
    ``loss_kind="multiscale"`` adds the average-pool pyramid of ``levels``
    levels (``4**l · Σ`` over the groups whose pixels are all real),
    ``sil_w > 0`` the silhouette term ``sil_w · Σ (σ((2ε − min_s)/β) −
    target_coverage)²`` (``target_coverage`` (H, W), ``β = sil_beta`` or
    ``epsilon/2.5``), both inside the one launch.  A (V, 30) ``uni`` with a
    (V, 3, H, W) target (and a (V, H, W) ``target_coverage``) is the
    multi-view step, V views in one launch: ``g_uni`` is then (V, 30), the
    loss and ``g_prm`` summed over the views (:func:`sum_views`).  On the
    card it launches the CUDA kernel; on the CPU it runs the kernel's plain
    PyTorch version.  ``fit_step_kernel.launches`` counts kernel launches."""
    _check_fused(scene, cfg, loss_kind, levels, sil_w, kc)
    uni = with_rows(uni, row0, rowstride)
    loss = dict(loss_kind=loss_kind, levels=levels, sil_w=sil_w, sil_beta=sil_beta, target_coverage=target_coverage)
    if prm.device.type == "cpu":
        if uni.dim() == 2:
            return sum_views(*fit_step_views_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots,
                                                   **loss), sum_dtype)
        out = fit_step_kernel_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, **loss)
        return tuple(x.to(sum_dtype) for x in out)
    if prm.device.type == "cuda":
        return fit_step_kernel_launch(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, sum_dtype,
                                      **loss)
    raise ValueError(f"fit_step_kernel runs on 'cuda' or 'cpu', not {prm.device}")


#: Kernel launches in this process (the smoke resets and reads it).
fit_step_kernel.launches = 0


def fit_step_kernel_tiles_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                                 trow: torch.Tensor, tcol: torch.Tensor, cfg: RenderConfig,
                                 kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = False,
                                 frozen_slots: tuple = (), sum_dtype=torch.float32, *, loss_kind: str = "l2",
                                 levels: int = 3, sil_w: float = 0.0, sil_beta=None, coverage_tiles=None):
    """Launch K4 on ``prm``'s card over the work-list ``trow``/``tcol``
    ((T,) int32) for the target stack (3, T·TH, TW) and return ``(loss,
    g_prm, g_uni)``, this work-list's sums in ``sum_dtype``; the loss options
    as :func:`fit_step_kernel_tiles`.  Raises for inputs it does not take and
    on any launch error; never falls back."""
    _check_loss(loss_kind, sil_w, coverage_tiles)
    frozen_slots = tuple(sorted(set(frozen_slots)))
    ls = _launch_loss(cfg, loss_kind, levels, sil_w, sil_beta, coverage_tiles)
    cov = ls["coverage"]
    lib = kernel_library(scene, prm, uni, cfg, kc, wrt_uniforms, frozen_slots, "full", ls["levels"], cov is not None)
    dev = prm.device
    T = check_tables(trow, tcol, dev)
    check_plane("target", target, (3, T * kc.tile_h, kc.tile_w), dev)
    if cov is not None:
        check_plane("coverage_tiles", cov, (T * kc.tile_h, kc.tile_w), dev)
    with torch.cuda.device(dev):
        n_blocks = T * -(-kc.tile_w // kc.block_w) * -(-kc.tile_h // kc.block_h)
        partials, _, totals, stream = _fit_buffers(lib, n_blocks, dev)
        err = lib.sdf3d_fit_step_tiles(uni.data_ptr(), prm.data_ptr(), trow.data_ptr(), tcol.data_ptr(),
                                       target[0].data_ptr(), target[1].data_ptr(), target[2].data_ptr(),
                                       cov.data_ptr() if cov is not None else None, ctypes.c_float(ls["sil_w"]),
                                       ctypes.c_float(ls["sil_beta"]), partials.data_ptr(), totals.data_ptr(), T,
                                       cfg.height, cfg.width, stream)
    if err != 0:
        raise RuntimeError(f"sdf3d_fit_step_tiles launch failed: CUDA error {err}")
    fit_step_kernel_tiles.launches += 1
    return _split_totals(totals, count_params(scene), sum_dtype)


def fit_step_kernel_tiles(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                          trow: torch.Tensor, tcol: torch.Tensor, cfg: RenderConfig,
                          kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = False, frozen_slots: tuple = (),
                          sum_dtype=torch.float32, *, loss_kind: str = "l2", levels: int = 3, sil_w: float = 0.0,
                          sil_beta=None, coverage_tiles=None):
    """Tile-queue fused fit step (K4): ``(loss, g_prm (P,), g_uni (30,))`` of
    ``Σ mask·(render − target)²`` over the tiles whose absolute origins are
    ``(trow[z], tcol[z])`` ((T,) int32), for the target stack (3, T·TH, TW)
    in work-list order (``parallel.tile_queue.gather_target_tiles``).
    ``cfg`` is the full image's config: the mask keeps the pixels inside it,
    so a plan's dummy tiles add exact zeros.  These are this work-list's
    sums (in ``sum_dtype``); a sharded fit all-reduces them.  The loss terms
    as :func:`fit_step_kernel`, ``coverage_tiles`` the coverage target's
    stack (T·TH, TW): tile origins are multiples of the tile, so a tile's
    pyramid groups are the whole image's.  On the card it launches the CUDA
    kernel; on the CPU it runs the plain PyTorch version.
    ``fit_step_kernel_tiles.launches`` counts kernel launches."""
    _check_fused(scene, cfg, loss_kind, levels, sil_w, kc)
    loss = dict(loss_kind=loss_kind, levels=levels, sil_w=sil_w, sil_beta=sil_beta, coverage_tiles=coverage_tiles)
    if prm.device.type == "cpu":
        out = fit_step_kernel_tiles_plain(scene, prm, uni, target, trow, tcol, cfg, kc, wrt_uniforms, frozen_slots,
                                          **loss)
        return tuple(x.to(sum_dtype) for x in out)
    if prm.device.type == "cuda":
        return fit_step_kernel_tiles_launch(scene, prm, uni, target, trow, tcol, cfg, kc, wrt_uniforms,
                                            frozen_slots, sum_dtype, **loss)
    raise ValueError(f"fit_step_kernel_tiles runs on 'cuda' or 'cpu', not {prm.device}")


#: Kernel launches in this process (the smoke resets and reads it).
fit_step_kernel_tiles.launches = 0


def _grad_copy(obj):
    """A copy of a dataclass of tensors whose fields are detached leaves
    that require grad."""
    return type(obj)(*(getattr(obj, f.name).detach().requires_grad_(True) for f in dataclasses.fields(obj)))


def _split_grads(scene, camera, light, mat, cfg, device, g_prm, g_uni, wrt_uniforms):
    """``(g_scene, g_camera, g_light, g_mat)`` from the flat gradients."""
    sizes = [int(l.numel()) for l in leaves(scene)]
    g_scene = [g.view_as(l) for g, l in zip(torch.split(g_prm, sizes), leaves(scene))]
    if not wrt_uniforms:
        return g_scene, None, None, None
    cam_, light_, mat_ = (_grad_copy(o) for o in (camera, light, mat))
    with torch.enable_grad():
        packed = pack_uniforms(cam_, light_, mat_, cfg.ray_mode, device, detach=False)
        inputs = [getattr(o, f.name) for o in (cam_, light_, mat_) for f in dataclasses.fields(o)]
        grads = torch.autograd.grad(packed, inputs, grad_outputs=g_uni, allow_unused=True)
    grads = iter(torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs))
    g_cam, g_light, g_mat = (type(o)(*(next(grads) for _ in dataclasses.fields(o))) for o in (cam_, light_, mat_))
    return g_scene, g_cam, g_light, g_mat


def _uniforms(camera, light, mat, cfg, device):
    uni = pack_uniforms(camera, light, mat, cfg.ray_mode, device)
    uni[_U_K] = float(cfg.shadow.k)
    return uni


def l2_loss_and_grads(cfg: RenderConfig, kc: KernelConfig, scene: SDFNode, camera, light, mat,
                      target: torch.Tensor, row0=None, rowstride=None, wrt_uniforms: bool = True,
                      frozen_slots: tuple = (), *, loss_kind: str = "l2", levels: int = 3, sil_w: float = 0.0,
                      sil_beta=None, target_coverage=None):
    """Fused ``(loss, (g_scene, g_camera, g_light, g_mat))`` in one launch.

    ``target`` is (H, W, 3) on the scene's device (a row slab under
    sharding, with ``row0``/``rowstride`` as :func:`fit_step_kernel`).
    ``g_scene`` lists the gradient of every scene leaf
    (``scene_program.leaves`` order, each in its leaf's shape);
    ``g_camera``, ``g_light`` and ``g_mat`` are objects of the input's class
    holding the gradients of its fields (light colour reads 0), or ``None``
    when ``wrt_uniforms`` is false.  The loss options as
    :func:`fit_step_kernel` (``target_coverage`` (H, W), in the rows of
    ``target``)."""
    prm = scene_param_vector(scene)
    uni = _uniforms(camera, light, mat, cfg, prm.device)
    target_planar = target.to(torch.float32).permute(2, 0, 1).contiguous()
    loss, g_prm, g_uni = fit_step_kernel(scene, prm, uni, target_planar, cfg, kc, wrt_uniforms, frozen_slots,
                                         row0, rowstride, loss_kind=loss_kind, levels=levels, sil_w=sil_w,
                                         sil_beta=sil_beta, target_coverage=_coverage(target_coverage, sil_w))
    return loss, _split_grads(scene, camera, light, mat, cfg, prm.device, g_prm, g_uni, wrt_uniforms)


def _coverage(coverage, sil_w):
    """A coverage target as a contiguous float32 tensor where the silhouette
    term reads it."""
    return coverage.to(torch.float32).contiguous() if sil_w > 0.0 and coverage is not None else None


def l2_loss_and_grads_tiles(cfg: RenderConfig, kc: KernelConfig, scene: SDFNode, camera, light, mat,
                            target_tiles: torch.Tensor, trow: torch.Tensor, tcol: torch.Tensor,
                            wrt_uniforms: bool = False, frozen_slots: tuple = (), *, loss_kind: str = "l2",
                            levels: int = 3, sil_w: float = 0.0, sil_beta=None, coverage_tiles=None):
    """Tile-queue counterpart of :func:`l2_loss_and_grads` (one launch of
    K4): ``(loss, (g_scene, g_camera, g_light, g_mat))`` over the work-list
    ``trow``/``tcol`` ((T,) int32) for the planar target stack (3, T·TH, TW);
    ``cfg`` is the full image's.  These are the work-list's sums: a sharded
    fit all-reduces them.  The loss options as :func:`fit_step_kernel_tiles`."""
    prm = scene_param_vector(scene)
    uni = _uniforms(camera, light, mat, cfg, prm.device)
    loss, g_prm, g_uni = fit_step_kernel_tiles(scene, prm, uni, target_tiles.to(torch.float32).contiguous(),
                                               trow, tcol, cfg, kc, wrt_uniforms, frozen_slots, loss_kind=loss_kind,
                                               levels=levels, sil_w=sil_w, sil_beta=sil_beta,
                                               coverage_tiles=_coverage(coverage_tiles, sil_w))
    return loss, _split_grads(scene, camera, light, mat, cfg, prm.device, g_prm, g_uni, wrt_uniforms)


def _grad_sum(a, b):
    """The field-by-field sum of two gradient objects of one class."""
    return type(a)(*(getattr(a, f.name) + getattr(b, f.name) for f in dataclasses.fields(a)))


def multiview_inputs(cfg: RenderConfig, cameras, light, mat, targets, device, target_coverages=None):
    """The multi-view fit step's inputs for V cameras and their (H, W, 3)
    ``targets`` (images or a stacked (V, H, W, 3) tensor), on ``device``:
    ``(uni (V, 30), target (V, 3, H, W), coverage (V, H, W) or None)``.
    ``target`` is the (V, 3, H, W) view of a contiguous (3, V, H, W)
    tensor, the layout K3 reads in place; ``coverage`` stacks the V (H, W)
    ``target_coverages`` where given."""
    uni = torch.stack([_uniforms(cam, light, mat, cfg, device) for cam in cameras])
    planar = torch.stack([torch.as_tensor(t).to(device, torch.float32).permute(2, 0, 1) for t in targets], 1)
    cov = None
    if target_coverages is not None:
        cov = torch.stack([torch.as_tensor(c).to(device, torch.float32) for c in target_coverages]).contiguous()
    return uni, planar.contiguous().transpose(0, 1), cov


def multiview_loss_and_grads(cfg: RenderConfig, kc: KernelConfig, scene: SDFNode, cameras, light, mat, targets,
                             wrt_uniforms: bool = False, frozen_slots: tuple = (), *, loss_kind: str = "l2",
                             levels: int = 3, sil_w: float = 0.0, sil_beta=None, target_coverages=None):
    """Fused multi-view ``(loss, (g_scene, g_cameras, g_light, g_mat))``:
    one launch of K3 for all V views (JAX's ``multiview_loss_and_grads``).

    ``cameras``: V cameras; ``targets``: V (H, W, 3) images or a stacked
    (V, H, W, 3) tensor on the scene's device; ``target_coverages``: V
    (H, W) masks of the silhouette term.  The loss and ``g_scene`` are
    summed over the views; ``g_cameras`` lists each view's camera gradient,
    ``g_light`` and ``g_mat`` are summed over the views (in view order), all
    three ``None`` when ``wrt_uniforms`` is false.  The loss options as
    :func:`fit_step_kernel`."""
    V = len(cameras)
    prm = scene_param_vector(scene)
    uni, target, covs = multiview_inputs(cfg, cameras, light, mat, targets, prm.device,
                                         target_coverages if sil_w > 0.0 else None)
    loss, g_prm, g_uni = fit_step_kernel(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots,
                                         loss_kind=loss_kind, levels=levels, sil_w=sil_w, sil_beta=sil_beta,
                                         target_coverage=covs)
    g_scene = _split_grads(scene, None, None, None, cfg, prm.device, g_prm, None, False)[0]
    if not wrt_uniforms:
        return loss, (g_scene, None, None, None)
    g_cams, g_light, g_mat = [], None, None
    for v in range(V):
        _, g_cam, g_light_v, g_mat_v = _split_grads(scene, cameras[v], light, mat, cfg, prm.device, g_prm, g_uni[v],
                                                    True)
        g_cams.append(g_cam)
        g_light = g_light_v if g_light is None else _grad_sum(g_light, g_light_v)
        g_mat = g_mat_v if g_mat is None else _grad_sum(g_mat, g_mat_v)
    return loss, (g_scene, g_cams, g_light, g_mat)


# ---------------------------------------------------------------------------
# K9: the fit step's benchmark variants.
# ---------------------------------------------------------------------------

#: The variants of :func:`fit_step_variant`: the header variants of
#: ``scene_program.FIT_VARIANTS`` and ``tgt3``, which is ``full`` on one
#: stacked (3, H, W) target (JAX's variant reads its three planes as one
#: block; K3 already reads its target that way).
VARIANTS = FIT_VARIANTS + ("tgt3",)
#: The variants that write the loss alone.
LOSS_ONLY = ("primal", "noscatter", "empty", "empty_noin")


def _header_variant(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    return "full" if variant == "tgt3" else variant


def _variant_outputs(variant, loss, g_prm, g_uni):
    v = _header_variant(variant)
    if v in LOSS_ONLY:
        return loss, None, None
    return loss, g_prm, None if v == "wrt_p" else g_uni


def _chain_pow(x, s):
    """``nopow``'s specular power: x³·x³·x³·x³, whatever the exponent
    (JAX's ``cheap_pow``)."""
    x3 = x * x * x
    return (x3 * x3) * (x3 * x3)


def fit_step_variant_plain(variant: str, scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                           cfg: RenderConfig, kc: KernelConfig = KernelConfig(), planes=None):
    """Plain PyTorch version of the fit step's benchmark ``variant`` (K9):
    K3's plain step (:func:`fit_step_kernel_plain`, ``wrt_uniforms=True``)
    with the variant's cuts, ``(loss, g_prm | None, g_uni | None)``.

    ``full``/``tgt3``: K3's step; ``wrt_p``: no uniform gradient;
    ``primal``/``noscatter``: the loss; ``nopow``: the specular power as the
    chain x³·x³·x³·x³ (no shininess gradient); ``shade_only``: the shading at
    t = 2, shadow 1, AO 1, no march; ``empty``: the target's sum;
    ``empty_noin``: the pixel count H·W.  ``planes``: the (t, shadow, ao)
    planes a marching variant shades (the kernel's, to compare on the same
    primal), else the plain primal's."""
    v = _header_variant(variant)
    H, W = cfg.height, cfg.width
    if v == "empty_noin":
        return torch.tensor(float(H * W), device=prm.device), None, None
    if v == "empty":
        return (target[0] + target[1] + target[2]).sum(dtype=torch.float64).to(torch.float32), None, None
    pixels = pixel_planes(uni, H, W, kc.tile_h)
    if v == "shade_only":
        ones = torch.ones((H, W), dtype=torch.float32, device=prm.device)
        planes = (2.0 * ones, ones, ones)
    elif planes is None:
        planes = render_kernel_forward_plain(scene, prm, uni, cfg, kc, pixels)[1:]
    power = _chain_pow if v == "nopow" else torch.pow
    if v in LOSS_ONLY:
        with torch.no_grad():
            res = shade_planes(prm, uni, *planes, scene, cfg, pixels, power) - target
            return torch.sum(res * res), None, None
    out = _fit_step_plain(scene, prm, uni, target, cfg, kc, v != "wrt_p", (), pixels, planes=planes, power=power)
    return _variant_outputs(v, *out)


def fit_step_variant_launch(variant: str, scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                            cfg: RenderConfig, kc: KernelConfig = KernelConfig()):
    """Launch the fit step's benchmark ``variant`` on ``prm``'s card: K3's
    kernel function compiled with ``Fit::variant`` (``full`` and ``tgt3``
    are K3's own library).  Returns ``(loss, g_prm | None, g_uni | None)``
    from the launch's float64 totals.  Raises for inputs it
    does not take and on any launch error; never falls back."""
    v = _header_variant(variant)
    totals = _launch_totals(scene, prm, uni, target, cfg, kc, True, (), v)
    fit_step_variant.launches += 1
    loss, g_prm, g_uni = _split_totals(totals, count_params(scene), torch.float32)
    return _variant_outputs(v, loss, g_prm, g_uni)


def fit_step_variant(variant: str, scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                     cfg: RenderConfig, kc: KernelConfig = KernelConfig()):
    """The fit step's benchmark ``variant`` (K9, one of :data:`VARIANTS`):
    ``(loss, g_prm | None, g_uni | None)`` for the planar target (3, H, W).
    On the card it launches the CUDA kernel; on the CPU it runs the plain
    PyTorch version.  ``fit_step_variant.launches`` counts kernel launches."""
    _check_fused(scene, cfg)
    if prm.device.type == "cpu":
        return fit_step_variant_plain(variant, scene, prm, uni, target, cfg, kc)
    if prm.device.type == "cuda":
        return fit_step_variant_launch(variant, scene, prm, uni, target, cfg, kc)
    raise ValueError(f"fit_step_variant runs on 'cuda' or 'cpu', not {prm.device}")


#: Kernel launches in this process (the smoke resets and reads it).
fit_step_variant.launches = 0
