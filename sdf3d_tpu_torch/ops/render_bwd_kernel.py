"""The render backward (the port of ``sdf3d_tpu/ops/render_bwd_kernel.py``).

The gradient of a loss of the rendered image with respect to the scene
parameters and, with ``wrt_uniforms`` (the default), the 30 uniforms, from
the forward's ``t``/``shadow``/``ao`` planes and the planar RGB cotangent
``g_rgb`` (3, H, W).  It differentiates
the shading re-traced from those planes (:func:`shade_planes`, the port of
``_shade_tile``): ``t`` re-attached by the implicit-function theorem, the
shadow a detached factor, AO flowing through its recomputed taps.  Two
implementations of the same function:

- the CUDA kernel (``csrc/render_bwd_kernel.cu`` with the hand-written
  reverse pass of ``csrc/shade_vjp.cuh``), launched by
  :func:`render_kernel_backward` for tensors on the card: one C call
  launches the kernel (partial rows of the requested columns) and their
  float64 total (``csrc/column_total.cuh``), which the wrapper casts to
  float32;
- :func:`render_kernel_backward_plain`, autograd through
  :func:`shade_planes`, which the wrapper runs for tensors on the CPU and
  which the tests and ``chip_smoke.py`` hold the kernel against.

:func:`planar_vjp` is the same VJP with the choice the kernel does not
have: ``remarch_shadow=True`` re-marches the shadow ray differentiably inside
the re-trace (``shadow.grad == "ad"``, JAX's ``_planar_shade`` branch), the
backward of ``render_kernel_diff`` and ``render_neural`` under that mode on
the CPU and the card alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.diff import DENOM_FLOOR
from sdf3d_tpu_torch.lighting import Material
from sdf3d_tpu_torch.march import soft_shadow
from sdf3d_tpu_torch.ops.render_kernel import (
    _U_AMB,
    _U_LIGHT,
    _U_MAT_AMB,
    N_MAT_CHANNELS,
    N_UNIFORMS,
    KernelConfig,
    check_plane,
    check_settings,
    kernel_library,
    material_channels,
    pixel_planes,
    ray_planes,
)
from sdf3d_tpu_torch.ops.scene_program import check_scene, compile_scene, count_params, leaves
from sdf3d_tpu_torch.sdf.materials import material_at, scene_has_materials
from sdf3d_tpu_torch.sdf.node import SDFNode, sqrt_rn

def _rsqrt(x):
    return 1.0 / sqrt_rn(x)


def _floor(x, lo):
    # max with a tensor bound: the adjoint splits at a tie, as lax.max's.
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def _clip01(x):
    # jnp.clip's adjoint: min(max(x, 0), 1); torch.clamp would pass the
    # whole adjoint at a bound.
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.minimum(_floor(x, 0.0), one)


def planar_distance(sdf):
    """The distance ``(px, py, pz, prm) -> planes`` of ``sdf``: a scene every
    node of which has an emitter (its point form, values read from the flat
    parameter vector ``prm``), or such a callable already (the neural
    scenes' ``ops/neural_kernel.py::neural_distance``).  ``prm`` may carry
    trailing pixel dimensions (one parameter set per pixel)."""
    if not isinstance(sdf, SDFNode):
        return sdf
    check_scene(sdf)
    soa = compile_scene(sdf)
    return lambda px, py, pz, prm: soa(px, py, pz, lambda i: prm[i])


class _MaterialProbe(nn.Module):
    """``material_at`` of ``scene`` as a module's forward, so that
    ``torch.func.functional_call`` substitutes the scene's leaves in it."""

    def __init__(self, scene: SDFNode):
        super().__init__()
        self.scene = scene

    def forward(self, p: torch.Tensor, default: Material) -> Material:
        return material_at(self.scene, p, default)


class SceneDistance:
    """The distance ``(px, py, pz, prm) -> planes`` of any scene through its
    own ``distance`` (``torch.func.functional_call``), its leaves read from
    the flat parameter vector ``prm`` (P,) in ``scene_param_vector``'s
    order: the re-trace of a scene without emitters (a ``VoxelGrid``), JAX's
    generic branch of ``_planar_shade``.  :meth:`materials` resolves the
    scene's ``Shaded`` tags at the hit by the same substitution."""

    def __init__(self, scene: SDFNode):
        self.scene = scene
        self.tagged = scene_has_materials(scene)
        names = {id(p): n for n, p in scene.named_parameters(remove_duplicate=False)}
        self.slots, off = [], 0
        for leaf in leaves(scene):
            self.slots.append((names[id(leaf)], off, leaf.shape))
            off += leaf.numel()

    def _leaves(self, prm: torch.Tensor, prefix: str = "") -> dict:
        return {prefix + name: prm[o:o + max(1, int(np.prod(shape)))].reshape(shape) for name, o, shape in self.slots}

    def __call__(self, px, py, pz, prm):
        return torch.func.functional_call(self.scene, self._leaves(prm), (torch.stack([px, py, pz], dim=-1),))

    def materials(self, hx, hy, hz, prm, u) -> tuple:
        """The 10 material channels at the hit planes (``material_channels``'
        order): ``sdf/materials.py::material_at`` with the uniform material
        ``u[17..26]`` serving the untagged subtrees, as JAX's
        ``_planar_shade`` resolves them, differentiable in each ``Shaded``
        node's slots of ``prm``, in the uniforms and in the hit point."""
        default = tuple(u[_U_MAT_AMB + k] for k in range(N_MAT_CHANNELS))
        if not self.tagged:
            return default
        mat = Material(torch.stack(default[0:3]), torch.stack(default[3:6]), torch.stack(default[6:9]), default[9])
        m = torch.func.functional_call(_MaterialProbe(self.scene), self._leaves(prm, "scene."),
                                       (torch.stack([hx, hy, hz], dim=-1), mat))
        return (*m.ambient.unbind(-1), *m.diffuse.unbind(-1), *m.specular.unbind(-1), m.shininess)


def scene_distance(scene: SDFNode) -> SceneDistance:
    """:class:`SceneDistance` of ``scene``."""
    return SceneDistance(scene)


def implicit_denominator(sdf, prm: torch.Tensor, uni: torch.Tensor, t0: torch.Tensor,
                         cfg: RenderConfig, pixels=None) -> torch.Tensor:
    """``∇ₚf(o + t0·d)·d`` per pixel (H, W), detached, for a scene or
    distance ``sdf`` (:func:`planar_distance`): the denominator of the
    implicit-function gradient of ``t``.  Where it is small (grazing rays at
    a silhouette) that gradient is large and ill-conditioned.  ``pixels``:
    the planes' absolute ``(rows, cols)`` (``render_kernel.ray_planes``)."""
    dist = planar_distance(sdf)
    prm_c = prm.detach()
    o, d = ray_planes(uni.detach(), *t0.shape, cfg, pixels)
    with torch.enable_grad():
        q = [(oc + t0 * dc).requires_grad_(True) for oc, dc in zip(o, d)]
        gq = torch.autograd.grad(dist(*q, prm_c).sum(), q)
    return gq[0] * d[0] + gq[1] * d[1] + gq[2] * d[2]


def shadow_ad(cfg: RenderConfig) -> bool:
    """True when ``cfg`` asks for the shadow's own gradient: an enabled
    shadow under ``shadow.grad == "ad"`` (penumbra-shape gradients through a
    re-marched shadow ray)."""
    return cfg.shadow.enabled and cfg.shadow.grad == "ad"


def shade_planes(prm: torch.Tensor, uni: torch.Tensor, t0: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor,
                 scene, cfg: RenderConfig, pixels=None, power=torch.pow, remarch_shadow: bool = False) -> torch.Tensor:
    """The shading re-traced from the forward's planes, planar RGB (3, H, W),
    differentiable in ``prm`` (P,) and ``uni`` (30,), for a scene or distance
    ``scene`` (:func:`planar_distance`).  ``t0``, ``shadow`` and ``ao`` (H, W)
    are constants; ``t`` is re-attached by the implicit-function theorem
    (``t0 − (f − sg(f)) / sg(∇f·d)``, masked where ``t0 > max_distance`` or
    ``|∇f·d| < 1e-4``).  Stage for stage the port of
    ``sdf3d_tpu/ops/render_bwd_kernel.py::_shade_tile`` (and, for a neural
    scene, of ``render_pallas.py::_planar_shade``'s generic branch).
    ``pixels``: the planes' absolute ``(rows, cols)``
    (``render_kernel.ray_planes``).  ``power(x, s)`` is the specular power
    (the fit kernel's variant ``nopow`` passes its chain).  With
    ``remarch_shadow`` (and an enabled shadow) the shadow ray is marched
    again from ``h + 2ε·n`` towards the light, differentiably and without
    the early exit, and its gradient replaces the detached factor's zero
    while the plane ``shadow`` stays the primal (JAX's ``_planar_shade``
    under ``shadow.grad == "ad"``)."""
    check_settings(cfg)
    dist = planar_distance(scene)
    H, W = t0.shape
    mc = cfg.march
    u = [uni[k] for k in range(N_UNIFORMS)]

    def sdf(px, py, pz):
        return dist(px, py, pz, prm)

    (ox, oy, oz), (dx, dy, dz) = ray_planes(uni, H, W, cfg, pixels)

    # ---- implicit-function re-attachment of the stored hit distance ----
    denom = implicit_denominator(dist, prm, uni, t0, cfg, pixels)
    usable = (t0 <= mc.max_distance) & (denom.abs() >= DENOM_FLOOR)
    inv_denom = torch.where(usable, 1.0 / torch.where(usable, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    f_here = sdf(ox + t0 * dx, oy + t0 * dy, oz + t0 * dz)
    t_att = t0 - (f_here - f_here.detach()) * inv_denom
    hx, hy, hz = ox + t_att * dx, oy + t_att * dy, oz + t_att * dz

    # ---- normals ----
    e = float(np.float32(mc.epsilon))
    if cfg.normals == "central":
        nx = sdf(hx + e, hy, hz) - sdf(hx - e, hy, hz)
        ny = sdf(hx, hy + e, hz) - sdf(hx, hy - e, hz)
        nz = sdf(hx, hy, hz + e) - sdf(hx, hy, hz - e)
    else:
        s0 = sdf(hx + e, hy - e, hz - e)
        s1 = sdf(hx - e, hy - e, hz + e)
        s2 = sdf(hx - e, hy + e, hz - e)
        s3 = sdf(hx + e, hy + e, hz + e)
        nx = s0 - s1 - s2 + s3
        ny = -s0 - s1 + s2 + s3
        nz = -s0 + s1 - s2 + s3
    ninv = _rsqrt(_floor(nx * nx + ny * ny + nz * nz, 1e-24))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv

    # ---- incident light, shadow (detached or re-marched), AO (flows, the plane is its value) ----
    ix, iy, iz = u[_U_LIGHT] - hx, u[_U_LIGHT + 1] - hy, u[_U_LIGHT + 2] - hz
    iinv = _rsqrt(_floor(ix * ix + iy * iy + iz * iz, 1e-24))
    ix, iy, iz = ix * iinv, iy * iinv, iz * iinv
    if remarch_shadow and cfg.shadow.enabled:
        # A fixed trip count (no early exit), so every step is recorded; the
        # kernel's plane is the value, the re-march's the gradient.
        origin = torch.stack([hx + 2.0 * e * nx, hy + 2.0 * e * ny, hz + 2.0 * e * nz], dim=-1)
        sh_ad = soft_shadow(lambda p: sdf(p[..., 0], p[..., 1], p[..., 2]), origin, torch.stack([ix, iy, iz], dim=-1),
                            cfg.shadow, dataclasses.replace(mc, early_exit=False))
        shadow = sh_ad - sh_ad.detach() + shadow
    if cfg.ao.enabled:
        occ = torch.zeros_like(t0)
        weight = 1.0
        for tap in range(1, cfg.ao.samples + 1):
            hh = cfg.ao.step * tap
            occ = occ + weight * (hh - sdf(hx + hh * nx, hy + hh * ny, hz + hh * nz))
            weight *= cfg.ao.falloff
        ao_ad = _clip01(1.0 - cfg.ao.strength * occ)
        ao = ao_ad - ao_ad.detach() + ao

    # ---- shading ----
    wx, wy, wz = ox - hx, oy - hy, oz - hz
    winv = _rsqrt(_floor(wx * wx + wy * wy + wz * wz, 1e-24))
    wx, wy, wz = wx * winv, wy * winv, wz * winv
    hwx, hwy, hwz = ix + wx, iy + wy, iz + wz
    hwinv = _rsqrt(_floor(hwx * hwx + hwy * hwy + hwz * hwz, 1e-24))
    hwx, hwy, hwz = hwx * hwinv, hwy * hwinv, hwz * hwinv
    ndoth = _floor(nx * hwx + ny * hwy + nz * hwz, 0.0)
    dif = _clip01(nx * ix + ny * iy + nz * iz) * shadow
    amb = u[_U_AMB] * ao if cfg.ao.enabled else u[_U_AMB]
    # The material channels at the hit (JAX's mat_soa): the material
    # program's for a scene with Shaded tags (``material_at`` on a scene's own
    # distance), differentiable in its parameters and the hit point, else
    # the uniform material.
    if isinstance(scene, SceneDistance):
        mch = scene.materials(hx, hy, hz, prm, u)
    else:
        mch = material_channels(scene, lambda i: prm[i], u, hx, hy, hz)
    spec = power(ndoth, mch[9])
    chans = []
    for c in range(3):
        v = amb * mch[c] + dif * mch[3 + c]
        if cfg.shading == "blinn_phong":
            v = v + spec * mch[6 + c]
        if cfg.background is not None:
            v = torch.where(t0 > mc.max_distance, float(cfg.background[c]), v)
        chans.append(v.expand(H, W))
    return torch.stack(chans)


def planar_vjp(scene, prm: torch.Tensor, uni: torch.Tensor, g_rgb: torch.Tensor, t: torch.Tensor,
               shadow: torch.Tensor, ao: torch.Tensor, cfg: RenderConfig, pixels=None, wrt_uniforms: bool = True,
               remarch_shadow: bool = False):
    """``(g_prm (P,), g_uni (30,))``: the VJP of :func:`shade_planes` with
    the cotangent ``g_rgb`` (3, H, W), for a scene or distance ``scene``
    (:func:`planar_distance`; the neural render's backward passes
    ``neural_distance``), the shadow re-marched where ``remarch_shadow``
    says.  Without ``wrt_uniforms`` it takes the gradient of ``prm`` alone
    and ``g_uni`` is None.  ``pixels`` as for :func:`shade_planes`."""
    prm_ = prm.detach().requires_grad_(True)
    uni_ = uni.detach().requires_grad_(wrt_uniforms)
    with torch.enable_grad():
        rgb = shade_planes(prm_, uni_, t, shadow, ao, scene, cfg, pixels, remarch_shadow=remarch_shadow)
        grads = torch.autograd.grad(rgb, (prm_, uni_) if wrt_uniforms else (prm_,), grad_outputs=g_rgb)
    return grads[0], grads[1] if wrt_uniforms else None


def render_kernel_backward_plain(scene, prm: torch.Tensor, uni: torch.Tensor, g_rgb: torch.Tensor,
                                 t: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor, cfg: RenderConfig,
                                 pixels=None, wrt_uniforms: bool = True):
    """Plain PyTorch version of the render backward: :func:`planar_vjp` with
    the shadow a detached factor, whatever ``cfg.shadow.grad`` says (the
    kernel's semantics)."""
    return planar_vjp(scene, prm, uni, g_rgb, t, shadow, ao, cfg, pixels, wrt_uniforms)


def render_bwd_launcher(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, g_rgb: torch.Tensor,
                        t: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor, cfg: RenderConfig,
                        kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True):
    """``(launch, partials, totals)`` of the render backward on ``prm``'s
    card: the library loaded and the inputs checked once, the partial rows
    (one per block of the P columns of ``g_prm``, then with ``wrt_uniforms``
    the 30 of ``g_uni``; an ``(n_blocks, columns)`` view of the kernel's
    store by column) and their float64 totals allocated.  Each ``launch()``
    enqueues the kernel and its total on the stream that was current when
    the launcher was made and returns the totals (the caller makes
    ``prm``'s card the current device).  Raises for inputs it does not take
    and on any launch error; never falls back."""
    lib = kernel_library(scene, prm, uni, cfg, kc)
    dev = prm.device
    H, W = cfg.height, cfg.width
    check_plane("g_rgb", g_rgb, (3, H, W), dev)
    for name, x in (("t", t), ("shadow", shadow), ("ao", ao)):
        check_plane(name, x, (H, W), dev)
    cols = count_params(scene) + (N_UNIFORMS if wrt_uniforms else 0)
    n_blocks = -(-W // kc.block_w) * -(-H // kc.block_h)
    partials = torch.empty((cols, -(-n_blocks // 4) * 4), dtype=torch.float32, device=dev)
    totals = torch.empty((cols,), dtype=torch.float64, device=dev)
    args = (uni.data_ptr(), prm.data_ptr(), g_rgb[0].data_ptr(), g_rgb[1].data_ptr(), g_rgb[2].data_ptr(),
            t.data_ptr(), shadow.data_ptr(), ao.data_ptr(), partials.data_ptr(), totals.data_ptr(), H, W,
            int(wrt_uniforms), torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = lib.sdf3d_render_bwd(*args)
        if err != 0:
            raise RuntimeError(f"sdf3d_render_bwd launch failed: CUDA error {err}")
        return totals
    launch.inputs = (uni, prm, g_rgb, t, shadow, ao)  # ``args`` holds their addresses: keep them alive
    return launch, partials[:, :n_blocks].t(), totals


def render_kernel_backward_launch(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, g_rgb: torch.Tensor,
                                  t: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor, cfg: RenderConfig,
                                  kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True):
    """Launch the CUDA render backward on ``prm``'s card and return
    ``(g_prm, g_uni)``, float32 from the kernel's float64 totals (``g_uni``
    None without ``wrt_uniforms``).  Raises for inputs it does not take and
    on any launch error; never falls back."""
    with torch.cuda.device(prm.device):
        totals = render_bwd_launcher(scene, prm, uni, g_rgb, t, shadow, ao, cfg, kc, wrt_uniforms)[0]()
    render_kernel_backward.launches += 1
    g = totals.to(torch.float32)
    P = count_params(scene)
    return g[:P], g[P:] if wrt_uniforms else None


def render_kernel_backward(scene: SDFNode, prm: torch.Tensor, uni: torch.Tensor, g_rgb: torch.Tensor,
                           t: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor, cfg: RenderConfig,
                           kc: KernelConfig = KernelConfig(), wrt_uniforms: bool = True):
    """Render backward: ``(g_prm (P,), g_uni (30,))`` from the planar
    cotangent ``g_rgb`` (3, H, W) and the forward's planes; without
    ``wrt_uniforms`` the parameters' gradient alone (``g_uni`` None, and the
    kernel computes and sums only the P columns).  On the card it launches
    the CUDA kernel; on the CPU it runs the kernel's plain PyTorch version.
    ``render_kernel_backward.launches`` counts kernel launches.  The kernel
    treats the shadow as a detached factor: ``shadow.grad == "ad"`` raises
    here (:func:`planar_vjp` re-marches it)."""
    if shadow_ad(cfg):
        raise ValueError("the render backward treats the shadow as a detached factor; shadow.grad == 'ad' takes "
                         "planar_vjp(..., remarch_shadow=True) (render_kernel_diff routes it there)")
    if prm.device.type == "cpu":
        return render_kernel_backward_plain(scene, prm, uni, g_rgb, t, shadow, ao, cfg,
                                            pixel_planes(uni, cfg.height, cfg.width, kc.tile_h), wrt_uniforms)
    if prm.device.type == "cuda":
        return render_kernel_backward_launch(scene, prm, uni, g_rgb, t, shadow, ao, cfg, kc, wrt_uniforms)
    raise ValueError(f"render_kernel_backward runs on 'cuda' or 'cpu', not {prm.device}")


#: Kernel launches in this process (the smoke resets and reads it).
render_kernel_backward.launches = 0
