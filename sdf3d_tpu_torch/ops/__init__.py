"""Kernels of the port and their scene compiler."""

from sdf3d_tpu_torch.ops.render_kernel import (
    N_UNIFORMS,
    KernelConfig,
    pack_uniforms,
    render_kernel_forward,
    render_kernel_forward_plain,
    render_kernel_launch,
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
    "pack_uniforms",
    "render_kernel_forward",
    "render_kernel_forward_plain",
    "render_kernel_launch",
    "compile_scene",
    "compile_scene_ray",
    "count_params",
    "cuda_scene_source",
    "scene_param_vector",
]
