"""The neural-scene forward render (the port of ``sdf3d_tpu/ops/neural_kernel.py``).

Scenes: a bare :class:`~sdf3d_tpu_torch.sdf.neural.NeuralSDF`, or
``Union(analytic, NeuralSDF)`` in either order with an analytic subtree
every node of which has an emitter (:func:`split_neural`).  Per ray: ray
generation → primary march → normals → soft shadow (every ray, the
un-squared Quilez form) → AO → shading, producing rgb ``(3, H, W)`` and the
t / shadow / ao planes ``(H, W)``, all float32.  Two implementations of the
same function:

- the CUDA kernel (``csrc/neural_kernel.cu``): persistent blocks of ray
  slots, each slot a per-ray state machine (``csrc/neural_kernel.cuh``) that
  takes the next unstarted ray when its own has shaded, each warp's MLP run
  on its 32 slots' points as split-TF32 tensor-core products; built per
  scene structure and static settings into a library of its own
  (``_build.py``, kind ``"neural"``), launched by
  :func:`render_neural_forward` for tensors on the card;
- :func:`render_neural_forward_plain`, whole-image PyTorch planes stage for
  stage from ``_neural_tile_kernel``, which the wrapper runs for tensors on
  the CPU and which the tests and ``chip_smoke.py`` hold the kernel against.

Both read one flat parameter vector (``scene_param_vector``: the analytic
subtree's and the MLP's values in ``tree_flatten`` order) and the 30-float
uniforms.  :func:`render_neural` is differentiable: the kernel forward, and
as backward the planar shade re-traced from its t/shadow/ao planes
(``render_bwd_kernel.shade_planes`` with :func:`neural_distance`), the
counterpart of the JAX custom VJP's ``_planar_shade`` (no backward kernel:
the JAX package has none for this family).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.render_bwd_kernel import planar_vjp, shadow_ad
from sdf3d_tpu_torch.ops.render_kernel import (
    _U_K,
    N_UNIFORMS,
    _ao_plain,
    _light_plain,
    _march_primary_plain,
    _normals_plain,
    _shade_plain,
    check_plane,
    check_settings,
    pack_uniforms,
    ray_planes,
)
from sdf3d_tpu_torch.ops.scene_program import (
    compile_scene,
    count_params,
    cuda_neural_source,
    describe,
    leaves,
    neural_layout,
    scene_param_vector,
    split_neural,
)
from sdf3d_tpu_torch.sdf.neural import mlp
from sdf3d_tpu_torch.sdf.node import SDFNode, sqrt_rn

__all__ = [
    "NeuralRenderConfig",
    "neural_distance",
    "render_neural",
    "render_neural_forward",
    "render_neural_forward_plain",
    "render_neural_launch",
    "split_neural",
]


@dataclasses.dataclass(frozen=True)
class NeuralRenderConfig:
    """Static settings of the neural kernel (part of the build key).

    ``block_rays``: ray slots (threads) per CUDA block, whole warps, at most
    1024.  The kernel's bits do not depend on it.  At 256 two blocks share
    an SM at hidden 64 (121 registers a thread on the H100); the JAX
    package's value (1024, the TPU's matmul rows) is legal but caps a thread
    at 64 registers.
    """

    block_rays: int = 256

    def __post_init__(self):
        if self.block_rays <= 0 or self.block_rays % 32 or self.block_rays > 1024:
            raise ValueError(f"block_rays={self.block_rays} must be whole warps, at most 1024 threads")


def neural_distance(scene: SDFNode):
    """The distance ``(px, py, pz, prm) -> planes`` of a scene
    :func:`split_neural` accepts, its values read from the flat parameter
    vector ``prm`` at the kernel's offsets (``neural_layout``):
    ``min(analytic, mlp)`` or the MLP alone.  ``prm`` may carry trailing
    pixel dimensions (one parameter set per pixel,
    ``utils/parity.py::gradient_mass``)."""
    lay = neural_layout(scene)
    soa = compile_scene(lay.analytic) if lay.analytic is not None else None
    H, L = lay.hidden, lay.layers
    w_shapes = [(3, H)] + [(H, H)] * (L - 2) + [(H, 1)]

    def take(prm, off, shape):
        n = int(np.prod(shape, dtype=np.int64))
        start = lay.offset + off
        v = prm[start:start + n].reshape(tuple(shape) + tuple(prm.shape[1:]))
        return v.movedim(tuple(range(len(shape))), tuple(range(v.dim() - len(shape), v.dim())))

    def dist(px, py, pz, prm):
        ws = [take(prm, o, s) for o, s in zip(lay.w_offsets, w_shapes)]
        bs = [take(prm, o, (s[1],)) for o, s in zip(lay.b_offsets, w_shapes)]
        d = mlp(torch.stack([px, py, pz], dim=-1), ws, bs, take(prm, lay.beta_offset, ()))
        if soa is None:
            return d
        return torch.minimum(soa(px, py, pz, lambda i: prm[lay.analytic_offset + i]), d)

    return dist


def check_neural(scene: SDFNode, cfg: RenderConfig) -> None:
    """Raise for what the neural kernel does not take, before any build or
    launch: other scene shapes (``ValueError``), analytic nodes without an
    emitter, autodiff normals.  The kernel marches exactly whatever
    ``march.relaxation`` says, as JAX's neural kernel (it has no relaxed
    body)."""
    neural_layout(scene)
    check_settings(cfg)


def _march_shadow_neural_plain(ev, k, cfg, shape, device, steps=None):
    """The neural kernel's shadow (``_neural_tile_kernel``'s): every ray,
    ``sh = min(sh, k·√d2/denom)``, ``prev`` from +inf, stop at ``sh < ε``.
    ``steps``, where given, counts each ray's distance evaluations."""
    mc = cfg.march
    kw = dict(dtype=torch.float32, device=device)
    dist = torch.zeros(shape, **kw)
    prev = torch.full(shape, float("inf"), **kw)
    sh = torch.ones(shape, **kw)
    active = torch.ones(shape, dtype=torch.bool, device=device)
    for i in range(cfg.shadow.max_steps):
        if not bool(active.any()):
            break
        s = ev(dist)
        if steps is not None:
            steps += active
        inter = torch.zeros_like(s) if i == 0 else s * s / (2.0 * torch.where(prev == 0.0, 1e-30, prev))
        d2 = s * s - inter * inter
        denom = dist - inter
        valid = (denom > 0.0) & (d2 >= 0.0)
        atten = torch.where(valid, k * sqrt_rn(torch.clamp(d2, min=0.0)) / torch.where(valid, denom, 1.0), 1e30)
        sh = torch.where(active, torch.minimum(sh, atten), sh)
        dist = torch.where(active, dist + s, dist)
        prev = torch.where(active, s, prev)
        active = active & ~((dist > mc.max_distance) | (sh < mc.epsilon))
    return torch.clamp(sh, 0.0, 1.0)


@torch.no_grad()
def render_neural_forward_plain(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, cfg: RenderConfig,
                                steps: dict | None = None):
    """Plain PyTorch version of the neural kernel: ``(rgb (3,H,W), t, shadow,
    ao)`` from the parameter vector ``prm`` and uniforms ``uni``, whole-image
    planes on ``prm``'s device.  ``scene`` gives the structure only.
    ``steps``: a dict that receives the per-pixel evaluation counts of the
    marches, ``"primary"`` and ``"shadow"`` (the kernel's work)."""
    check_neural(scene, cfg)
    dev = prm.device
    H, W = cfg.height, cfg.width
    u = [uni[k] for k in range(N_UNIFORMS)]
    dist = neural_distance(scene)

    def sdf(px, py, pz):
        return dist(px, py, pz, prm)

    (ox, oy, oz), (dx, dy, dz) = ray_planes(uni, H, W, cfg)
    counts = {k: torch.zeros((H, W), dtype=torch.float32, device=dev) for k in ("primary", "shadow")}
    if steps is not None:
        steps.update(counts)
    exact = dataclasses.replace(cfg.march, relaxation=1.0)  # the kernel has no relaxed march
    t = _march_primary_plain(lambda s: sdf(ox + s * dx, oy + s * dy, oz + s * dz), exact, (H, W), dev,
                             counts["primary"] if steps is not None else None)
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    nx, ny, nz = _normals_plain(sdf, hx, hy, hz, cfg)
    ix, iy, iz = _light_plain(u, hx, hy, hz)
    if cfg.shadow.enabled:
        off = 2.0 * float(np.float32(cfg.march.epsilon))
        sox, soy, soz = hx + off * nx, hy + off * ny, hz + off * nz
        shadow = _march_shadow_neural_plain(lambda s: sdf(sox + s * ix, soy + s * iy, soz + s * iz),
                                            u[_U_K], cfg, (H, W), dev, counts["shadow"] if steps is not None else None)
    else:
        shadow = torch.ones((H, W), dtype=torch.float32, device=dev)
    ao = _ao_plain(sdf, (hx, hy, hz), (nx, ny, nz), cfg)
    return _shade_plain(u, cfg, t, (ox, oy, oz), (hx, hy, hz), (nx, ny, nz), (ix, iy, iz), shadow, ao), t, shadow, ao


def neural_library(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, cfg: RenderConfig, nc: NeuralRenderConfig):
    """The neural library of ``scene``'s structure under ``cfg``/``nc``
    (built at first use), after checking that ``prm`` and ``uni`` are what
    its kernel takes."""
    check_neural(scene, cfg)
    dev = prm.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels run on CUDA tensors, not {dev}")
    check_plane("prm", prm, (count_params(scene),), dev)
    check_plane("uni", uni, (N_UNIFORMS,), dev)
    if prm.data_ptr() % 16:
        raise ValueError("prm must start 16-byte aligned: the kernel copies the MLP's weights 16 bytes at a time")
    return _build.LIBRARIES.load_for(neural_structure(scene, cfg, nc),
                                     lambda: cuda_neural_source(scene, cfg, nc), "neural")


def neural_structure(scene: SDFNode, cfg: RenderConfig, nc: NeuralRenderConfig):
    """What the generated header is a function of: the node types, the leaf
    shapes and the static settings, not the image size or any value."""
    return (describe(scene), tuple(tuple(leaf.shape) for leaf in leaves(scene)),
            dataclasses.replace(cfg, width=0, height=0), nc)


def render_neural_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, cfg: RenderConfig,
                         nc: NeuralRenderConfig = NeuralRenderConfig()):
    """Launch the neural kernel on ``prm``'s card (building its library at
    first use) and return ``(rgb (3,H,W), t, shadow, ao)``.  Raises for
    inputs it does not take and on any launch error; never falls back."""
    lib = neural_library(scene, prm, uni, cfg, nc)
    dev = prm.device
    H, W = cfg.height, cfg.width
    rgb = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    t, sh, ao = (torch.empty((H, W), dtype=torch.float32, device=dev) for _ in range(3))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)  # the rays the kernel's slots have taken
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdf3d_neural_fwd(uni.data_ptr(), prm.data_ptr(), rgb.data_ptr(), t.data_ptr(),
                                   sh.data_ptr(), ao.data_ptr(), counter.data_ptr(), H, W, stream)
    if err != 0:
        raise RuntimeError(f"sdf3d_neural_fwd launch failed: CUDA error {err}")
    render_neural_forward.launches += 1
    return rgb, t, sh, ao


def _inputs(scene, camera, light, mat, cfg, device):
    uni = pack_uniforms(camera, light, mat, cfg.ray_mode)
    uni[_U_K] = float(cfg.shadow.k)
    return scene_param_vector(scene, device), uni.to(device)


@torch.no_grad()
def render_neural_forward(scene: SDFNode, camera, light, mat, cfg: RenderConfig,
                          nc: NeuralRenderConfig = NeuralRenderConfig(), planar: bool = False, device=None):
    """Fused neural-scene forward render: ``(rgb, t, shadow, ao)`` with rgb
    ``(H, W, 3)``, or planar ``(3, H, W)`` when ``planar=True``.

    Runs on ``device`` (default: the device of the scene's parameters).  On
    the card it launches the neural kernel; on the CPU it runs the kernel's
    plain PyTorch version.  ``render_neural_forward.launches`` counts kernel
    launches.  Forward only: no autograd graph is recorded.
    """
    split_neural(scene)  # validate the shape eagerly
    device = torch.device(device if device is not None else next(iter(leaves(scene))).device)
    prm, uni = _inputs(scene, camera, light, mat, cfg, device)
    if device.type == "cpu":
        rgb, t, sh, ao = render_neural_forward_plain(scene, prm, uni, cfg)
    elif device.type == "cuda":
        rgb, t, sh, ao = render_neural_launch(scene, prm, uni, cfg, nc)
    else:
        raise ValueError(f"render_neural_forward runs on 'cuda' or 'cpu', not {device}")
    if not planar:
        rgb = rgb.permute(1, 2, 0)
    return rgb, t, sh, ao


#: Kernel launches in this process (the smoke resets and reads it).
render_neural_forward.launches = 0


class NeuralRenderFunction(torch.autograd.Function):
    """``rgb (3, H, W) = render(prm, uni)``: the neural kernel forward; the
    backward differentiates the shading re-traced from its planes."""

    @staticmethod
    def forward(ctx, prm, uni, scene: SDFNode, cfg: RenderConfig, nc: NeuralRenderConfig):
        if prm.device.type == "cpu":
            rgb, t, shadow, ao = render_neural_forward_plain(scene, prm, uni, cfg)
        else:
            rgb, t, shadow, ao = render_neural_launch(scene, prm, uni, cfg, nc)
        ctx.save_for_backward(prm, uni, t, shadow, ao)
        ctx.scene, ctx.cfg = scene, cfg
        return rgb

    @staticmethod
    def backward(ctx, g_rgb):
        prm, uni, t, shadow, ao = ctx.saved_tensors
        g_prm, g_uni = planar_vjp(neural_distance(ctx.scene), prm, uni, g_rgb, t, shadow, ao, ctx.cfg,
                                  remarch_shadow=shadow_ad(ctx.cfg))
        return g_prm, g_uni, None, None, None


def render_neural(cfg: RenderConfig, nc: NeuralRenderConfig, scene: SDFNode, camera, light, mat) -> torch.Tensor:
    """Differentiable neural render, RGB (H, W, 3) on the device of the
    scene's parameters (camera, light and material must be there too):
    gradients reach the MLP's weights, biases and β, the analytic subtree's
    parameters, and every camera, light and material tensor that requires
    grad.  The shadow is a detached factor, or under ``shadow.grad == "ad"``
    re-marched differentiably in the backward (the MLP evaluated at every
    step of the shadow ray), as in the JAX package."""
    split_neural(scene)
    prm = scene_param_vector(scene, detach=False)
    uni = pack_uniforms(camera, light, mat, cfg.ray_mode, prm.device, detach=False)
    uni[_U_K] = float(cfg.shadow.k)
    return NeuralRenderFunction.apply(prm.contiguous(), uni, scene, cfg, nc).permute(1, 2, 0)
