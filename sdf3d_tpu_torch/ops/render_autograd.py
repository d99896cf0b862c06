"""The differentiable kernel render (the port of
``sdf3d_tpu/ops/render_pallas.py``: ``render_pallas`` and its custom VJP,
``render_pallas_rows``).

:class:`RenderKernelFunction` is a ``torch.autograd.Function`` on the planar
(3, H, W) boundary, as ``render_pallas_planar`` is JAX's: its forward runs
the render kernel (K1) and keeps the ``t``/``shadow``/``ao`` planes, its
backward runs the render backward (K5) on them, so no march is repeated,
with the uniforms' gradient only where autograd asks for it.  Under
``shadow.grad == "ad"`` the backward is instead the autograd VJP of the
planar re-trace with the shadow ray re-marched
(``render_bwd_kernel.planar_vjp``), as JAX's ``_bwd`` sends that mode to
``_planar_shade``; the forward stays K1, whose plane is the primal.
:func:`render_kernel_diff` wraps it for scenes, cameras, lights and
materials: any PyTorch loss of its (H, W, 3) image gets gradients for the
scene's ``nn.Parameter``s and for every camera, light and material tensor
that requires grad.  It dispatches by family, as ``render_pallas`` does: a
neural scene goes to ``ops/neural_kernel.py::render_neural`` (the neural
kernel forward, the planar re-trace as backward), and a scene with a node
that has no emitter (a ``VoxelGrid``) to :class:`BandedRenderFunction`
(``render.render_aux_banded`` forward, the planar re-trace on the scene's
own distance backward; JAX's ``_forward_any``).  :func:`render_kernel_rows`
renders a row slab of a larger image (``render_pallas_rows``: the row
uniforms, K1 forward and K5 backward).  On CPU tensors the kernels' plain
PyTorch versions run.
"""

from __future__ import annotations

import dataclasses

import torch

from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.ops.fit_kernel import with_rows
from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, render_neural
from sdf3d_tpu_torch.ops.render_bwd_kernel import planar_vjp, render_kernel_backward, scene_distance, shadow_ad
from sdf3d_tpu_torch.ops.render_kernel import (
    _U_K,
    KernelConfig,
    check_settings,
    pack_uniforms,
    pixel_planes,
    render_kernel_run,
)
from sdf3d_tpu_torch.ops.scene_program import check_scene, has_emitters, is_neural_shape, scene_param_vector
from sdf3d_tpu_torch.render import render_aux_banded
from sdf3d_tpu_torch.sdf.node import SDFNode


class RenderKernelFunction(torch.autograd.Function):
    """``rgb (3, H, W) = render(prm, uni)``; backward through the render
    backward kernel, or under ``shadow.grad == "ad"`` the re-trace with the
    shadow re-marched."""

    @staticmethod
    def forward(ctx, prm, uni, scene: SDFNode, cfg: RenderConfig, kc: KernelConfig):
        rgb, t, shadow, ao = render_kernel_run(scene, prm, uni, cfg, kc)
        ctx.save_for_backward(prm, uni, t, shadow, ao)
        ctx.scene, ctx.cfg, ctx.kc = scene, cfg, kc
        return rgb

    @staticmethod
    def backward(ctx, g_rgb):
        # The uniforms' gradient only where autograd asks for it (a camera,
        # light or material that requires grad): without it the kernel
        # computes and sums the parameters' P columns alone.
        prm, uni, t, shadow, ao = ctx.saved_tensors
        wrt = ctx.needs_input_grad[1]
        if shadow_ad(ctx.cfg):
            pixels = pixel_planes(uni, ctx.cfg.height, ctx.cfg.width, ctx.kc.tile_h)
            g_prm, g_uni = planar_vjp(ctx.scene, prm, uni, g_rgb.contiguous(), t, shadow, ao, ctx.cfg, pixels, wrt,
                                      remarch_shadow=True)
        else:
            g_prm, g_uni = render_kernel_backward(ctx.scene, prm, uni, g_rgb.contiguous(), t, shadow, ao, ctx.cfg,
                                                  ctx.kc, wrt_uniforms=wrt)
        return g_prm, g_uni, None, None, None


class BandedRenderFunction(torch.autograd.Function):
    """``rgb (3, H, W) = render(prm, uni)`` of a scene without emitters:
    ``render.render_aux_banded`` forward (the torch march, no graph), the planar re-trace on the scene's own distance backward
    (``render_bwd_kernel.scene_distance``, its ``Shaded`` tags resolved at
    the hit), the shadow re-marched under ``shadow.grad == "ad"`` and a
    detached factor otherwise."""

    @staticmethod
    def forward(ctx, prm, uni, scene: SDFNode, cfg: RenderConfig, view: tuple):
        # One band of the whole image: the per-ray values are any band
        # size's, and each band repeats every march step's launches.
        rgb, t, shadow, ao = render_aux_banded(scene, *view, cfg, band_rows=cfg.height)
        ctx.save_for_backward(prm, uni, t, shadow, ao)
        ctx.scene, ctx.cfg = scene, cfg
        return rgb.permute(2, 0, 1)

    @staticmethod
    def backward(ctx, g_rgb):
        prm, uni, t, shadow, ao = ctx.saved_tensors
        g_prm, g_uni = planar_vjp(scene_distance(ctx.scene), prm, uni, g_rgb.contiguous(), t, shadow, ao, ctx.cfg,
                                  wrt_uniforms=ctx.needs_input_grad[1], remarch_shadow=shadow_ad(ctx.cfg))
        return g_prm, g_uni, None, None, None


def _inputs(scene, camera, light, mat, cfg):
    prm = scene_param_vector(scene, detach=False)
    uni = pack_uniforms(camera, light, mat, cfg.ray_mode, prm.device, detach=False)
    uni[_U_K] = float(cfg.shadow.k)
    return prm.contiguous(), uni


def render_kernel_diff(cfg: RenderConfig, kc: KernelConfig, scene: SDFNode, camera, light, mat) -> torch.Tensor:
    """Differentiable kernel render, RGB (H, W, 3) on the device of the
    scene's parameters (camera, light and material must be there too).  A
    scene ``split_neural`` accepts renders through ``render_neural`` (``kc``
    is the analytic kernels' setting and does not apply); another scene with
    a node that has no emitter (a ``VoxelGrid``) through
    :class:`BandedRenderFunction`, which launches no kernel."""
    if is_neural_shape(scene):
        return render_neural(cfg, NeuralRenderConfig(), scene, camera, light, mat)
    check_settings(cfg)
    prm, uni = _inputs(scene, camera, light, mat, cfg)
    if not has_emitters(scene):
        return BandedRenderFunction.apply(prm, uni, scene, cfg, (camera, light, mat)).permute(1, 2, 0)
    return RenderKernelFunction.apply(prm, uni, scene, cfg, kc).permute(1, 2, 0)


def render_kernel_rows(scene: SDFNode, camera, light, mat, cfg: RenderConfig, kc: KernelConfig, row0,
                       rowstride) -> torch.Tensor:
    """Differentiable kernel render of the ``cfg.height`` rows of a
    ``cfg.ndc_height``-tall image that start at absolute row ``row0``, tile
    rows ``rowstride`` apart (the uniforms' row slots,
    ``fit_kernel.with_rows``): ``(h, W, 3)``, K1 forward and K5 backward on
    the slab.  The port of ``render_pallas_rows``, whose backward is always
    the fused kernel: under ``shadow.grad == "ad"`` too the slab's shadow is
    a detached factor, as in the JAX package."""
    check_scene(scene)
    k5_cfg = dataclasses.replace(cfg, shadow=dataclasses.replace(cfg.shadow, grad="detach"))
    prm, uni = _inputs(scene, camera, light, mat, cfg)
    return RenderKernelFunction.apply(prm, with_rows(uni, row0, rowstride), scene, k5_cfg, kc).permute(1, 2, 0)
