"""sdf3d_tpu_torch: the PyTorch and CUDA port of sdf3d_tpu.

The forward render of analytic SDF scenes (sphere, plane, box, rounded box,
torus, capsule, cylinder, ellipsoid; hard and smooth union, intersection and
subtraction; translate, rotate, scale, round, onion, elongate and infinite
repetition) with soft
shadows and Blinn-Phong shading: a plain PyTorch reference path
(``render``), and a CUDA kernel written for the H100
(``ops.render_kernel_forward``, ``render_batch(engine="kernel")``), built per
scene structure at first use.  Inverse rendering on one card: ``fit_scene``
on the fused fit-step kernel, and a differentiable kernel render
(``ops.render_kernel_diff``: forward kernel, backward kernel).  The neural
SDF family (``sdf.NeuralSDF``, ``sdf.neural_sdf``, ``sdf.distill``) renders
on its own CUDA kernel (``ops.render_neural_forward``, ``ops.render_neural``,
``render_batch(engine="kernel")``), or banded (``render_banded``).
``parallel`` shards renders and fits over the ranks of a
``torch.distributed`` process group (``fit_scene(mesh=parallel.make_mesh())``),
in row layouts or a tile queue with its own kernels.  The
package imports torch and numpy, never JAX and never ``sdf3d_tpu``;
``convert.from_jax`` and ``sdf.load_setup`` carry scenes and settings over
from the JAX package.
"""

from sdf3d_tpu_torch import sdf
from sdf3d_tpu_torch.camera import Camera, camera_rays, focal_z, generate_rays, pixel_grid
from sdf3d_tpu_torch.config import (
    REFERENCE_CONFIG,
    AOConfig,
    MarchConfig,
    RenderConfig,
    ShadowConfig,
    fast_config,
)
from sdf3d_tpu_torch.fit import FitConfig, FitResult, fit_scene, pixel_loss
from sdf3d_tpu_torch.lighting import (
    Material,
    PointLight,
    material,
    point_light,
    reference_light,
    reference_material,
)
from sdf3d_tpu_torch.march import (
    ambient_occlusion,
    estimate_normals,
    hit_mask,
    normal_autodiff,
    normal_central,
    normal_tetrahedron,
    soft_shadow,
    sphere_trace,
)
from sdf3d_tpu_torch.render import (
    render,
    render_aa,
    render_aux_banded,
    render_banded,
    render_batch,
    render_depth,
    render_rays,
    render_rays_banded,
    shade_pixels,
)
from sdf3d_tpu_torch.scenes import (
    capsule_chain,
    csg_showcase,
    flagship_scene,
    fractal_scene,
    lattice_scene,
    random_blobs,
    reference_scene,
    sphere_scene,
)

__version__ = "0.1.0"
