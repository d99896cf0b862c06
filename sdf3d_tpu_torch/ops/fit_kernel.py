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
    N_UNIFORMS,
    KernelConfig,
    check_plane,
    kernel_library,
    pack_uniforms,
    render_kernel_forward_plain,
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


def fit_step_kernel_plain(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                          cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                          frozen_slots: tuple = ()):
    """Plain PyTorch version of the fit step: ``(loss, g_prm (P,), g_uni
    (30,))`` for the planar target (3, H, W).  ``g_uni`` is zeros unless
    ``wrt_uniforms``; the ``frozen_slots`` of ``g_prm`` are exactly 0."""
    _, t, shadow, ao = render_kernel_forward_plain(scene, prm, uni, cfg, kc)
    prm_ = prm.detach().requires_grad_(True)
    uni_ = uni.detach().requires_grad_(wrt_uniforms)
    with torch.enable_grad():
        res = shade_planes(prm_, uni_, t, shadow, ao, scene, cfg) - target
        loss = torch.sum(res * res)
        grads = torch.autograd.grad(loss, (prm_, uni_) if wrt_uniforms else (prm_,))
    g_prm = grads[0]
    if frozen_slots:
        g_prm[list(frozen_slots)] = 0.0
    g_uni = grads[1] if wrt_uniforms else torch.zeros_like(uni)
    return loss.detach(), g_prm, g_uni


def fit_step_kernel_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                           cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                           frozen_slots: tuple = ()):
    """Launch the CUDA fit step on ``prm``'s card and return ``(loss,
    g_prm, g_uni)``.  Raises for inputs it does not take and on any launch
    error; never falls back."""
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
    total = partials.sum(0)
    return total[G - 1], total[:P], total[P:G - 1]


def fit_step_kernel(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, target: torch.Tensor,
                    cfg: RenderConfig, kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True,
                    frozen_slots: tuple = ()):
    """Fused fit step: ``(loss, g_prm (P,), g_uni (30,))`` of
    ``Σ (render − target)²`` for the planar target (3, H, W), from the
    parameter vector ``prm`` and the uniforms ``uni``.  On the card it
    launches the CUDA kernel; on the CPU it runs the kernel's plain PyTorch
    version.  ``fit_step_kernel.launches`` counts kernel launches."""
    if not fused_l2_eligible(cfg, scene):
        raise NotImplementedError(
            "the fused fit step takes detached-shadow gradients, central/tetrahedron normals and scenes "
            "of Sphere, Plane and Union (ROADMAP item 12)")
    if prm.device.type == "cpu":
        return fit_step_kernel_plain(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots)
    if prm.device.type == "cuda":
        return fit_step_kernel_launch(scene, prm, uni, target, cfg, kc, wrt_uniforms, frozen_slots)
    raise ValueError(f"fit_step_kernel runs on 'cuda' or 'cpu', not {prm.device}")


#: Kernel launches in this process (the smoke resets and reads it).
fit_step_kernel.launches = 0


def _grad_copy(obj):
    """A copy of a dataclass of tensors whose fields are detached leaves
    that require grad."""
    return type(obj)(*(getattr(obj, f.name).detach().requires_grad_(True) for f in dataclasses.fields(obj)))


def l2_loss_and_grads(cfg: RenderConfig, kc: KernelConfig, scene: SDFNode, camera, light, mat,
                      target: torch.Tensor, wrt_uniforms: bool = True, frozen_slots: tuple = ()):
    """Fused ``(loss, (g_scene, g_camera, g_light, g_mat))`` in one launch.

    ``target`` is (H, W, 3) on the scene's device.  ``g_scene`` lists the
    gradient of every scene leaf (``scene_program.leaves`` order, each in
    its leaf's shape); ``g_camera``, ``g_light`` and ``g_mat`` are objects
    of the input's class holding the gradients of its fields (light colour
    reads 0), or ``None`` when ``wrt_uniforms`` is false."""
    prm = scene_param_vector(scene)
    uni = pack_uniforms(camera, light, mat, cfg.ray_mode, prm.device)
    uni[_U_K] = float(cfg.shadow.k)
    target_planar = target.to(torch.float32).permute(2, 0, 1).contiguous()
    loss, g_prm, g_uni = fit_step_kernel(scene, prm, uni, target_planar, cfg, kc, wrt_uniforms, frozen_slots)
    sizes = [int(l.numel()) for l in leaves(scene)]
    g_scene = [g.view_as(l) for g, l in zip(torch.split(g_prm, sizes), leaves(scene))]
    if not wrt_uniforms:
        return loss, (g_scene, None, None, None)
    cam_, light_, mat_ = (_grad_copy(o) for o in (camera, light, mat))
    with torch.enable_grad():
        packed = pack_uniforms(cam_, light_, mat_, cfg.ray_mode, prm.device, detach=False)
        inputs = [getattr(o, f.name) for o in (cam_, light_, mat_) for f in dataclasses.fields(o)]
        grads = torch.autograd.grad(packed, inputs, grad_outputs=g_uni, allow_unused=True)
    grads = iter(torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs))
    g_cam, g_light, g_mat = (type(o)(*(next(grads) for _ in dataclasses.fields(o))) for o in (cam_, light_, mat_))
    return loss, (g_scene, g_cam, g_light, g_mat)
