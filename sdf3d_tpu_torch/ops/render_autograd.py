"""The differentiable kernel render (the port of
``sdf3d_tpu/ops/render_pallas.py::render_pallas`` and its custom VJP).

:class:`RenderKernelFunction` is a ``torch.autograd.Function`` on the planar
(3, H, W) boundary, as ``render_pallas_planar`` is JAX's: its forward runs
the render kernel (K1) and keeps the ``t``/``shadow``/``ao`` planes, its
backward runs the render backward (K5) on them, so no march is repeated,
with the uniforms' gradient only where autograd asks for it.
:func:`render_kernel_diff` wraps it for scenes, cameras, lights and
materials: any PyTorch loss of its (H, W, 3) image gets gradients for the
scene's ``nn.Parameter``s and for every camera, light and material tensor
that requires grad.  A neural scene goes to ``ops/neural_kernel.py::
render_neural`` (the neural kernel forward, the planar shade re-trace as
backward), so one differentiable API serves every family the port has, as
``render_pallas`` does in the JAX package.  On CPU tensors both directions
run the plain PyTorch versions.
"""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, render_neural
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
from sdf3d_tpu_torch.ops.render_kernel import (
    _U_K,
    KernelConfig,
    pack_uniforms,
    render_kernel_forward_plain,
    render_kernel_launch,
)
from sdf3d_tpu_torch.ops.scene_program import is_neural_shape, scene_param_vector
from sdf3d_tpu_torch.sdf.node import SDFNode


class RenderKernelFunction(torch.autograd.Function):
    """``rgb (3, H, W) = render(prm, uni)``; backward through the render
    backward kernel."""

    @staticmethod
    def forward(ctx, prm, uni, scene: SDFNode, cfg: RenderConfig, kc: KernelConfig):
        if prm.device.type == "cpu":
            rgb, t, shadow, ao = render_kernel_forward_plain(scene, prm, uni, cfg, kc)
        else:
            rgb, t, shadow, ao = render_kernel_launch(scene, prm, uni, cfg, kc)
        ctx.save_for_backward(prm, uni, t, shadow, ao)
        ctx.scene, ctx.cfg, ctx.kc = scene, cfg, kc
        return rgb

    @staticmethod
    def backward(ctx, g_rgb):
        # The uniforms' gradient only where autograd asks for it (a camera,
        # light or material that requires grad): without it the kernel
        # computes and sums the parameters' P columns alone.
        prm, uni, t, shadow, ao = ctx.saved_tensors
        g_prm, g_uni = render_kernel_backward(ctx.scene, prm, uni, g_rgb.contiguous(), t, shadow, ao,
                                              ctx.cfg, ctx.kc, wrt_uniforms=ctx.needs_input_grad[1])
        return g_prm, g_uni, None, None, None


def render_kernel_diff(cfg: RenderConfig, kc: KernelConfig, scene: SDFNode, camera, light, mat) -> torch.Tensor:
    """Differentiable kernel render, RGB (H, W, 3) on the device of the
    scene's parameters (camera, light and material must be there too).  A
    scene ``split_neural`` accepts renders through ``render_neural`` (``kc``
    is the analytic kernels' setting and does not apply)."""
    if is_neural_shape(scene):
        return render_neural(cfg, NeuralRenderConfig(), scene, camera, light, mat)
    if cfg.shadow.enabled and cfg.shadow.grad != "detach":
        raise NotImplementedError(
            f"shadow.grad == {cfg.shadow.grad!r} needs a differentiable re-march (ROADMAP item 12)")
    prm = scene_param_vector(scene, detach=False)
    uni = pack_uniforms(camera, light, mat, cfg.ray_mode, prm.device, detach=False)
    uni[_U_K] = float(cfg.shadow.k)
    return RenderKernelFunction.apply(prm.contiguous(), uni, scene, cfg, kc).permute(1, 2, 0)
