"""The fused L2 fit step (the port of ``sdf3d_tpu/ops/fit_kernel.py``).

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
generated header as they are static ``jit`` arguments in JAX.

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
    render_kernel_forward_plain,
    tile_pixel_planes,
)
from sdf3d_tpu_torch.ops.scene_program import FIT_VARIANTS, check_scene, count_params, leaves, scene_param_vector
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


def _fit_step_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, pixels, mask=None, planes=None,
                    power=torch.pow):
    """The plain fit step on the absolute ``pixels`` planes, the residual
    times ``mask`` where given.  ``planes``: the (t, shadow, ao) planes to
    shade, else the plain primal's; ``power``: as ``shade_planes``."""
    if planes is None:
        planes = render_kernel_forward_plain(scene, prm, uni, cfg, kc, pixels)[1:]
    t, shadow, ao = planes
    prm_ = prm.detach().requires_grad_(True)
    uni_ = uni.detach().requires_grad_(wrt_uniforms)
    with torch.enable_grad():
        res = shade_planes(prm_, uni_, t, shadow, ao, scene, cfg, pixels, power) - target
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


def _fit_buffers(lib, n_blocks: int, dev: torch.device):
    """``(partials, rows, totals, stream)`` of a launch on ``dev``'s current
    stream: the partial rows as the kernel stores them, by column
    (``(live, n_blocks)`` padded to a multiple of 4 rows, float32), the
    same rows as an ``(n_blocks, live)`` view, and the totals
    (``(columns,)`` float64; :func:`fit_columns`)."""
    cols, live = fit_columns(lib)
    partials = torch.empty((live, -(-n_blocks // 4) * 4), dtype=torch.float32, device=dev)
    totals = torch.empty((cols,), dtype=torch.float64, device=dev)
    return partials, partials[:, :n_blocks].t(), totals, torch.cuda.current_stream(dev).cuda_stream


def fit_launcher(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, variant="full"):
    """``(launch, partials, totals)`` of the fit kernel (K3, or a benchmark
    ``variant`` of it) on ``prm``'s card: the library loaded and the inputs
    checked once, the partial rows (one per block, the live columns; an
    ``(n_blocks, live)`` view of the kernel's store by column) and the
    float64 totals allocated; each ``launch()`` enqueues the kernel and its
    total on the stream that was current when the launcher was made and
    returns the totals (the caller makes ``prm``'s card the current
    device).  Raises for inputs it does not take and on any launch error;
    never falls back."""
    lib = kernel_library(scene, prm, uni, cfg, kc, wrt_uniforms, frozen_slots, variant)
    dev = prm.device
    H, W = cfg.height, cfg.width
    check_plane("target", target, (3, H, W), dev)
    partials, rows, totals, stream = _fit_buffers(lib, -(-W // kc.block_w) * -(-H // kc.block_h), dev)
    args = (uni.data_ptr(), prm.data_ptr(), target[0].data_ptr(), target[1].data_ptr(), target[2].data_ptr(),
            partials.data_ptr(), totals.data_ptr(), H, W, stream)

    def launch():
        err = lib.sdf3d_fit_step(*args)
        if err != 0:
            raise RuntimeError(f"sdf3d_fit_step ({variant}) launch failed: CUDA error {err}")
        return totals
    launch.inputs = (uni, prm, target, partials)  # ``args`` holds their addresses: keep them alive
    return launch, rows, totals


def _launch_totals(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, variant="full"):
    """Launch the fit kernel once (:func:`fit_launcher`) on ``prm``'s card:
    its float64 totals."""
    with torch.cuda.device(prm.device):
        return fit_launcher(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots, variant)[0]()


def fit_step_kernel_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                           cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                           frozen_slots: tuple = (), sum_dtype=torch.float32):
    """Launch the CUDA fit step on ``prm``'s card and return ``(loss,
    g_prm, g_uni)`` in ``sum_dtype`` (:func:`_split_totals`).  Raises for
    inputs it does not take and on any launch error; never falls back."""
    frozen_slots = tuple(sorted(set(frozen_slots)))
    totals = _launch_totals(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots)
    fit_step_kernel.launches += 1
    return _split_totals(totals, count_params(scene), sum_dtype)


def _check_fused(scene: SDFNode, cfg: RenderConfig) -> None:
    check_settings(cfg)  # autodiff normals: ValueError, as JAX's Pallas path
    if not fused_l2_eligible(cfg, scene):
        raise NotImplementedError(
            "the fused fit step takes the plain L2 loss with detached-shadow gradients and central or "
            "tetrahedron normals (the other losses and gradients are ROADMAP item 12), on scenes whose every "
            "node has an emitter (ops/scene_program.py::check_scene names the first that has none)")


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
    with torch.cuda.device(dev):
        n_blocks = T * -(-kc.tile_w // kc.block_w) * -(-kc.tile_h // kc.block_h)
        partials, _, totals, stream = _fit_buffers(lib, n_blocks, dev)
        err = lib.sdf3d_fit_step_tiles(uni.data_ptr(), prm.data_ptr(), trow.data_ptr(), tcol.data_ptr(),
                                       target[0].data_ptr(), target[1].data_ptr(), target[2].data_ptr(),
                                       partials.data_ptr(), totals.data_ptr(), T, cfg.height, cfg.width, stream)
    if err != 0:
        raise RuntimeError(f"sdf3d_fit_step_tiles launch failed: CUDA error {err}")
    fit_step_kernel_tiles.launches += 1
    return _split_totals(totals, count_params(scene), sum_dtype)


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
