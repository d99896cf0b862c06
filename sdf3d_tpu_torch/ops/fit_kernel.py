"""The fused L2 fit step (the port of ``sdf3d_tpu/ops/fit_kernel.py``).

One fit step of inverse rendering: the loss ``Σ (rgb − target)²`` of a
render and its gradient with respect to the scene parameters (and, with
``wrt_uniforms``, the 30 uniforms).  Two implementations of the same
function:

- the CUDA kernel (``csrc/fit_kernel.cu``), launched by
  :func:`fit_step_kernel` for tensors on the card: per pixel the render
  kernel's primal, the residual and the hand-written reverse pass of the
  shading (``csrc/shade_vjp.cuh``), one launch and no image written to
  device memory;
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
generated header as they are static ``jit`` arguments in JAX.
"""

from __future__ import annotations

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
    check_tables,
    kernel_library,
    pack_uniforms,
    pixel_planes,
    render_kernel_forward_plain,
    tile_pixel_planes,
)
from sdf3d_tpu_torch.ops.scene_program import check_scene, count_params, leaves, scene_param_vector
from sdf3d_tpu_torch.sdf.node import SDFNode


def fused_l2_eligible(cfg: RenderConfig, scene: SDFNode, loss: str = "l2", sil_w: float = 0.0) -> bool:
    """True when the fused fit step applies: the plain L2 loss, no
    silhouette term, detached-shadow gradients, central or tetrahedron
    normals, and a scene every node of which has an emitter.  (The JAX
    package also fuses the multiscale pyramid and the coverage term; those
    kernel variants are ROADMAP item 12.)"""
    if loss != "l2" or sil_w > 0.0:
        return False
    if cfg.shadow.enabled and cfg.shadow.grad != "detach":
        return False
    if cfg.normals not in ("central", "tetrahedron"):
        return False
    try:
        check_scene(scene)
    except NotImplementedError:
        return False
    return True


def _fit_step_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, pixels, mask=None):
    """The plain fit step on the absolute ``pixels`` planes, the residual
    times ``mask`` where given."""
    _, t, shadow, ao = render_kernel_forward_plain(scene, prm, uni, cfg, kc, pixels)
    prm_ = prm.detach().requires_grad_(True)
    uni_ = uni.detach().requires_grad_(wrt_uniforms)
    with torch.enable_grad():
        res = shade_planes(prm_, uni_, t, shadow, ao, scene, cfg, pixels) - target
        if mask is not None:
            res = res * mask
        loss = torch.sum(res * res)
        grads = torch.autograd.grad(loss, (prm_, uni_) if wrt_uniforms else (prm_,))
    g_prm = grads[0]
    if frozen_slots:
        g_prm[list(frozen_slots)] = 0.0
    g_uni = grads[1] if wrt_uniforms else torch.zeros_like(uni)
    return loss.detach(), g_prm, g_uni


def fit_step_kernel_plain(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                          cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                          frozen_slots: tuple = ()):
    """Plain PyTorch version of the fit step: ``(loss, g_prm (P,), g_uni
    (30,))`` for the planar target (3, H, W).  ``g_uni`` is zeros unless
    ``wrt_uniforms``; the ``frozen_slots`` of ``g_prm`` are exactly 0."""
    pixels = pixel_planes(uni, cfg.height, cfg.width, kc.tile_h)
    return _fit_step_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, pixels)


def fit_step_kernel_tiles_plain(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                                trow: torch.Tensor, tcol: torch.Tensor, cfg: RenderConfig,
                                kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = False,
                                frozen_slots: tuple = ()):
    """Plain PyTorch version of the tile-queue fit step (K4): ``(loss,
    g_prm, g_uni)`` over the work-list ``trow``/``tcol`` for the target
    stack (3, T·TH, TW), the residual masked to the pixels inside the full
    image ``cfg`` (absolute coordinates: a dummy tile adds exact zeros)."""
    rows, cols = pixels = tile_pixel_planes(trow, tcol, kc.tile_h, kc.tile_w)
    mask = ((rows < cfg.height) & (cols < cfg.width)).to(torch.float32)
    return _fit_step_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, pixels, mask)


def _totals(partials: torch.Tensor, P: int, sum_dtype):
    """``(loss, g_prm, g_uni)`` from the kernel's partial rows, summed in
    float64: the total does not depend on the order of the rows (to the
    rounding of ``sum_dtype``), so the tile queue's blocks, which cover the
    same pixels as the image grid's in another order, give the same bits."""
    total = partials.sum(0, dtype=torch.float64).to(sum_dtype)
    G = total.shape[0]
    return total[G - 1], total[:P], total[P:G - 1]


def fit_step_kernel_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                           cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                           frozen_slots: tuple = (), sum_dtype=torch.float32):
    """Launch the CUDA fit step on ``prm``'s card and return ``(loss,
    g_prm, g_uni)`` in ``sum_dtype`` (:func:`_totals`).  Raises for inputs it
    does not take and on any launch error; never falls back."""
    frozen_slots = tuple(sorted(set(frozen_slots)))
    lib = kernel_library(scene, prm, uni, cfg, kc, wrt_uniforms, frozen_slots)
    dev = prm.device
    H, W = cfg.height, cfg.width
    check_plane("target", target, (3, H, W), dev)
    P = count_params(scene)
    G = P + N_UNIFORMS + 1
    n_blocks = -(-W // kc.block_w) * -(-H // kc.block_h)
    partials = torch.empty((n_blocks, G), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdf3d_fit_step(uni.data_ptr(), prm.data_ptr(), target[0].data_ptr(), target[1].data_ptr(),
                                 target[2].data_ptr(), partials.data_ptr(), H, W, stream)
    if err != 0:
        raise RuntimeError(f"sdf3d_fit_step launch failed: CUDA error {err}")
    fit_step_kernel.launches += 1
    return _totals(partials, P, sum_dtype)


def _check_fused(scene: SDFNode, cfg: RenderConfig) -> None:
    if not fused_l2_eligible(cfg, scene):
        raise NotImplementedError(
            "the fused fit step takes detached-shadow gradients, central/tetrahedron normals and scenes "
            "of Sphere, Plane and Union (ROADMAP item 12)")


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
        uni[_U_ROW0] = float(row0)
    if rowstride is not None:
        uni[_U_ROWSTRIDE] = float(rowstride)
    return uni


def fit_step_kernel(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                    cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                    frozen_slots: tuple = (), row0=None, rowstride=None, sum_dtype=torch.float32):
    """Fused fit step: ``(loss, g_prm (P,), g_uni (30,))`` of
    ``Σ (render − target)²`` for the planar target (3, H, W), from the
    parameter vector ``prm`` and the uniforms ``uni``.  ``row0`` and
    ``rowstride`` set the row slots (:func:`with_rows`): a row slab of a
    sharded fit, ``cfg.height`` its rows and ``cfg.ndc_height`` the image's.
    ``sum_dtype``: the type of the sums (a sharded fit keeps float64 until
    its all-reduce).  On the card it launches the CUDA kernel; on the CPU it
    runs the kernel's plain PyTorch version.  ``fit_step_kernel.launches``
    counts kernel launches."""
    _check_fused(scene, cfg)
    uni = with_rows(uni, row0, rowstride)
    if prm.device.type == "cpu":
        out = fit_step_kernel_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots)
        return tuple(x.to(sum_dtype) for x in out)
    if prm.device.type == "cuda":
        return fit_step_kernel_launch(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, sum_dtype)
    raise ValueError(f"fit_step_kernel runs on 'cuda' or 'cpu', not {prm.device}")


#: Kernel launches in this process (the smoke resets and reads it).
fit_step_kernel.launches = 0


def fit_step_kernel_tiles_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                                 trow: torch.Tensor, tcol: torch.Tensor, cfg: RenderConfig,
                                 kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = False,
                                 frozen_slots: tuple = (), sum_dtype=torch.float32):
    """Launch K4 on ``prm``'s card over the work-list ``trow``/``tcol``
    ((T,) int32) for the target stack (3, T·TH, TW) and return ``(loss,
    g_prm, g_uni)``, this work-list's sums in ``sum_dtype``.  Raises for
    inputs it does not take and on any launch error; never falls back."""
    frozen_slots = tuple(sorted(set(frozen_slots)))
    lib = kernel_library(scene, prm, uni, cfg, kc, wrt_uniforms, frozen_slots)
    dev = prm.device
    T = check_tables(trow, tcol, dev)
    check_plane("target", target, (3, T * kc.tile_h, kc.tile_w), dev)
    P = count_params(scene)
    G = P + N_UNIFORMS + 1
    n_blocks = T * -(-kc.tile_w // kc.block_w) * -(-kc.tile_h // kc.block_h)
    partials = torch.empty((n_blocks, G), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdf3d_fit_step_tiles(uni.data_ptr(), prm.data_ptr(), trow.data_ptr(), tcol.data_ptr(),
                                       target[0].data_ptr(), target[1].data_ptr(), target[2].data_ptr(),
                                       partials.data_ptr(), T, cfg.height, cfg.width, stream)
    if err != 0:
        raise RuntimeError(f"sdf3d_fit_step_tiles launch failed: CUDA error {err}")
    fit_step_kernel_tiles.launches += 1
    return _totals(partials, P, sum_dtype)


def fit_step_kernel_tiles(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                          trow: torch.Tensor, tcol: torch.Tensor, cfg: RenderConfig,
                          kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = False, frozen_slots: tuple = (),
                          sum_dtype=torch.float32):
    """Tile-queue fused fit step (K4): ``(loss, g_prm (P,), g_uni (30,))`` of
    ``Σ mask·(render − target)²`` over the tiles whose absolute origins are
    ``(trow[z], tcol[z])`` ((T,) int32), for the target stack (3, T·TH, TW)
    in work-list order (``parallel.tile_queue.gather_target_tiles``).
    ``cfg`` is the full image's config: the mask keeps the pixels inside it,
    so a plan's dummy tiles add exact zeros.  These are this work-list's
    sums (in ``sum_dtype``); a sharded fit all-reduces them.  On the card it
    launches the CUDA kernel; on the CPU it runs the plain PyTorch version.
    ``fit_step_kernel_tiles.launches`` counts kernel launches."""
    _check_fused(scene, cfg)
    if prm.device.type == "cpu":
        out = fit_step_kernel_tiles_plain(scene, prm, uni, target, trow, tcol, cfg, kc, wrt_uniforms, frozen_slots)
        return tuple(x.to(sum_dtype) for x in out)
    if prm.device.type == "cuda":
        return fit_step_kernel_tiles_launch(scene, prm, uni, target, trow, tcol, cfg, kc, wrt_uniforms,
                                            frozen_slots, sum_dtype)
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
                      frozen_slots: tuple = ()):
    """Fused ``(loss, (g_scene, g_camera, g_light, g_mat))`` in one launch.

    ``target`` is (H, W, 3) on the scene's device (a row slab under
    sharding, with ``row0``/``rowstride`` as :func:`fit_step_kernel`).
    ``g_scene`` lists the gradient of every scene leaf
    (``scene_program.leaves`` order, each in its leaf's shape);
    ``g_camera``, ``g_light`` and ``g_mat`` are objects of the input's class
    holding the gradients of its fields (light colour reads 0), or ``None``
    when ``wrt_uniforms`` is false."""
    prm = scene_param_vector(scene)
    uni = _uniforms(camera, light, mat, cfg, prm.device)
    target_planar = target.to(torch.float32).permute(2, 0, 1).contiguous()
    loss, g_prm, g_uni = fit_step_kernel(scene, prm, uni, target_planar, cfg, kc, wrt_uniforms, frozen_slots,
                                         row0, rowstride)
    return loss, _split_grads(scene, camera, light, mat, cfg, prm.device, g_prm, g_uni, wrt_uniforms)


def l2_loss_and_grads_tiles(cfg: RenderConfig, kc: KernelConfig, scene: SDFNode, camera, light, mat,
                            target_tiles: torch.Tensor, trow: torch.Tensor, tcol: torch.Tensor,
                            wrt_uniforms: bool = False, frozen_slots: tuple = ()):
    """Tile-queue counterpart of :func:`l2_loss_and_grads` (one launch of
    K4): ``(loss, (g_scene, g_camera, g_light, g_mat))`` over the work-list
    ``trow``/``tcol`` ((T,) int32) for the planar target stack (3, T·TH, TW);
    ``cfg`` is the full image's.  These are the work-list's sums: a sharded
    fit all-reduces them."""
    prm = scene_param_vector(scene)
    uni = _uniforms(camera, light, mat, cfg, prm.device)
    loss, g_prm, g_uni = fit_step_kernel_tiles(scene, prm, uni, target_tiles.to(torch.float32).contiguous(),
                                               trow, tcol, cfg, kc, wrt_uniforms, frozen_slots)
    return loss, _split_grads(scene, camera, light, mat, cfg, prm.device, g_prm, g_uni, wrt_uniforms)
