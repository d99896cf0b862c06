"""Kernels of the port and their scene compiler."""

from sdf3d_tpu_torch.ops.neural_kernel import (
    NeuralRenderConfig,
    render_neural,
    render_neural_forward,
    render_neural_forward_plain,
)
from sdf3d_tpu_torch.ops.fit_kernel import (
    fit_step_kernel,
    fit_step_kernel_plain,
    fit_step_kernel_tiles,
    fit_step_kernel_tiles_plain,
    fit_step_views_plain,
    fused_l2_eligible,
    l2_loss_and_grads,
    l2_loss_and_grads_tiles,
    multiview_loss_and_grads,
)
from sdf3d_tpu_torch.ops.render_autograd import RenderKernelFunction, render_kernel_diff
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward, render_kernel_backward_plain, shade_planes
from sdf3d_tpu_torch.ops.render_kernel import (
    N_UNIFORMS,
    KernelConfig,
    pack_uniforms,
    render_kernel_forward,
    render_kernel_forward_plain,
    render_kernel_launch,
    render_kernel_tiles_forward,
    render_kernel_tiles_forward_plain,
)
from sdf3d_tpu_torch.ops.scene_program import (
    compile_scene,
    compile_scene_ray,
    count_params,
    cuda_scene_source,
    scene_param_vector,
)

__all__ = [
    "N_UNIFORMS",
    "KernelConfig",
    "NeuralRenderConfig",
    "RenderKernelFunction",
    "pack_uniforms",
    "fit_step_kernel",
    "fit_step_kernel_plain",
    "fit_step_kernel_tiles",
    "fit_step_kernel_tiles_plain",
    "fit_step_views_plain",
    "fused_l2_eligible",
    "l2_loss_and_grads",
    "l2_loss_and_grads_tiles",
    "multiview_loss_and_grads",
    "render_kernel_backward",
    "render_kernel_backward_plain",
    "render_kernel_diff",
    "render_kernel_forward",
    "render_kernel_forward_plain",
    "render_kernel_launch",
    "render_kernel_tiles_forward",
    "render_kernel_tiles_forward_plain",
    "render_neural",
    "render_neural_forward",
    "render_neural_forward_plain",
    "shade_planes",
    "compile_scene",
    "compile_scene_ray",
    "count_params",
    "cuda_scene_source",
    "scene_param_vector",
]
