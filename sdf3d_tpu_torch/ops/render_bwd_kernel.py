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
"""

from __future__ import annotations

import numpy as np
import torch

from sdf3d_tpu_torch.config import RenderConfig
from sdf3d_tpu_torch.ops.render_kernel import (
    _U_AMB,
    _U_LIGHT,
    _U_MAT_AMB,
    _U_MAT_DIF,
    _U_MAT_REF,
    _U_SHN,
    N_UNIFORMS,
    KernelConfig,
    check_plane,
    check_settings,
    kernel_library,
    ray_planes,
)
from sdf3d_tpu_torch.ops.scene_program import check_scene, compile_scene, count_params
from sdf3d_tpu_torch.sdf.node import SDFNode, sqrt_rn

#: Smallest usable |grad f . d| for the implicit-function ``t`` (``sdf3d_tpu/diff.py``).
DENOM_FLOOR = 1e-4


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


def shade_planes(prm: torch.Tensor, uni: torch.Tensor, t0: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor,
                 scene, cfg: RenderConfig, pixels=None, power=torch.pow) -> torch.Tensor:
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
    (the fit kernel's variant ``nopow`` passes its chain)."""
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

    # ---- incident light, shadow (detached), AO (flows, the plane is its value) ----
    ix, iy, iz = u[_U_LIGHT] - hx, u[_U_LIGHT + 1] - hy, u[_U_LIGHT + 2] - hz
    iinv = _rsqrt(_floor(ix * ix + iy * iy + iz * iz, 1e-24))
    ix, iy, iz = ix * iinv, iy * iinv, iz * iinv
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
    spec = power(ndoth, u[_U_SHN])
    chans = []
    for c in range(3):
        v = amb * u[_U_MAT_AMB + c] + dif * u[_U_MAT_DIF + c]
        if cfg.shading == "blinn_phong":
            v = v + spec * u[_U_MAT_REF + c]
        if cfg.background is not None:
            v = torch.where(t0 > mc.max_distance, float(cfg.background[c]), v)
        chans.append(v.expand(H, W))
    return torch.stack(chans)


def render_kernel_backward_plain(scene, prm: torch.Tensor, uni: torch.Tensor, g_rgb: torch.Tensor,
                                 t: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor, cfg: RenderConfig,
                                 pixels=None, wrt_uniforms: bool = True):
    """Plain PyTorch version of the render backward: ``(g_prm (P,), g_uni
    (30,))``, the VJP of :func:`shade_planes` with the cotangent ``g_rgb``
    (3, H, W), for a scene or distance ``scene`` (:func:`planar_distance`;
    the neural render's backward passes ``neural_distance``).  Without
    ``wrt_uniforms`` it takes the gradient of ``prm`` alone and ``g_uni`` is
    None.  ``pixels`` as for :func:`shade_planes`."""
    prm_ = prm.detach().requires_grad_(True)
    uni_ = uni.detach().requires_grad_(wrt_uniforms)
    with torch.enable_grad():
        rgb = shade_planes(prm_, uni_, t, shadow, ao, scene, cfg, pixels)
        grads = torch.autograd.grad(rgb, (prm_, uni_) if wrt_uniforms else (prm_,), grad_outputs=g_rgb)
    return grads[0], grads[1] if wrt_uniforms else None


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
    ``render_kernel_backward.launches`` counts kernel launches."""
    if cfg.shadow.enabled and cfg.shadow.grad != "detach":
        raise NotImplementedError(
            f"shadow.grad == {cfg.shadow.grad!r} needs a differentiable re-march (ROADMAP item 12); "
            "the render backward treats the shadow as a detached factor")
    if prm.device.type == "cpu":
        return render_kernel_backward_plain(scene, prm, uni, g_rgb, t, shadow, ao, cfg, wrt_uniforms=wrt_uniforms)
    if prm.device.type == "cuda":
        return render_kernel_backward_launch(scene, prm, uni, g_rgb, t, shadow, ao, cfg, kc, wrt_uniforms)
    raise ValueError(f"render_kernel_backward runs on 'cuda' or 'cpu', not {prm.device}")


#: Kernel launches in this process (the smoke resets and reads it).
render_kernel_backward.launches = 0
