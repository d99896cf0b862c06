// Hand-written VJP of the shading expression for one pixel: the reverse
// pass shared by the fused fit step (fit_kernel.cu, K3) and the render
// backward (render_bwd_kernel.cu, K5).
//
// It computes, for one pixel, what jax.vjp of
// sdf3d_tpu/ops/render_bwd_kernel.py::_shade_tile computes: the shading of
// the pixel's primal (render_kernel.cuh::Primal) as a function of the scene
// parameters p and the uniforms u, with
// - t re-attached by the implicit-function theorem: the adjoint of t flows
//   into the distance at o + t*d, scaled by -1/(grad_p f . d) where that
//   denominator is usable (t <= max_distance, |denom| >= 1e-4), else 0;
// - shadow a detached factor (uniform 27, k, gets 0);
// - AO flowing through its recomputed taps, with the forward's value;
// - rows and columns constants (uniforms 28 and 29 get 0): the pixel's
//   absolute (rows, cols) come in as values;
// - min/max/clip splitting the adjoint at exact ties and pow's exponent
//   derivative guarded at a zero base, as lax's rules do.
// A miss is still shaded and carries adjoint through its normals and light
// terms, unless Cfg::background composites it out.
//
// A scene with Shaded tags (HasMaterials) shades with the material program's
// channels at the hit point (JAX's mat_soa branch): their adjoints (the
// shininess's g_spec·log(N.H)·spec among them) go through the program's
// reverse, Scene::material_bwd, into the Shaded parameters' slots of dP and,
// with WRT_U, into the uniform material's slots of dU for untagged
// subtrees; its adjoint with respect to the hit point (the smooth blends'
// weights depend on it) joins the hit point's, and so reaches t's
// implicit-function term, as JAX's AD through (hx, hy, hz) does.
//
// K3 hands shade_vjp the Primal its own forward built (trace_pixel), so it
// traces the primal once.  K5 has only the forward's (t, shadow, ao) planes:
// shade_vjp_planes rebuilds the Primal from them with make_primal, the same
// stages and arithmetic as the forward.
//
// Like render_kernel.cuh the code is __host__ __device__, so a C++ compiler
// builds it for the CPU tests.  Every intermediate stays in registers.
#pragma once

#include "render_kernel.cuh"

namespace sdf3d {

constexpr float DENOM_FLOOR = 1e-4f;  // sdf3d_tpu_torch/diff.py::DENOM_FLOOR

// Adds to (gx, gy, gz) the adjoint of v given the adjoint of v * r
// (lax.rsqrt: dr/dq = -0.5 * r / q).
SDF3D_HD void unit3_bwd(const Unit3& n, bool floored, float gux, float guy, float guz,
                        float& gx, float& gy, float& gz) {
  const float gr = ((gux * n.x) + (guy * n.y)) + (guz * n.z);
  float gs = gr * ((-0.5f * n.r) / n.q);
  if (floored) gs = gs * max_adj(n.s, 1e-24f);
  gx += (gux * n.r) + (2.0f * (gs * n.x));
  gy += (guy * n.r) + (2.0f * (gs * n.y));
  gz += (guz * n.r) + (2.0f * (gs * n.z));
}

// Scene::sdf_bwd with the position adjoint added to (gx, gy, gz).
template <class Scene>
SDF3D_HD void sdf_bwd_add(float px, float py, float pz, const float* p, float g, float* dP,
                          float& gx, float& gy, float& gz) {
  float qx, qy, qz;
  Scene::sdf_bwd(px, py, pz, p, g, dP, qx, qy, qz);
  gx += qx; gy += qy; gz += qz;
}

// The adjoints of a pixel's ray: its origin (the camera position) and its
// unit direction.
struct RayAdjoint {
  float ox, oy, oz, dx, dy, dz;
};

// The shading's part of one pixel's VJP over its primal pr: adds the
// adjoint of its (r, g, b) = (gr, gg, gb) to dP[0..P) and, when WRT_U, to
// the shading's own entries of dU[0..30) (light, material) and sets ray to
// the adjoints of the pixel's ray, which ray_vjp carries into the camera's
// entries.  Returns false, and sets nothing, for a miss that Cfg::background
// composites out.  POW false differentiates the power chain of
// spec_pow<false> (no adjoint for the shininess, neither the uniform's nor a
// Shaded node's: the fit kernel's benchmark variant nopow, K9, which is on
// no fit's path).
template <class Cfg, class Scene, bool WRT_U, bool POW = true>
SDF3D_HD bool shade_vjp_surface(const float* u, const float* p, const Primal& pr, float gr, float gg, float gb,
                                float* dP, float* dU, RayAdjoint& ray) {
  const float t0 = pr.t, shadow = pr.shadow;
  if constexpr (Cfg::background) {
    if (t0 > Cfg::max_distance) return false;  // where(miss, bg, .) passes no adjoint
  }
  constexpr bool MAT = HasMaterials<Scene>::value;
  const float* mc = channels<MAT>(u, pr);
  const Unit3 &d = pr.d, &n = pr.n, &li = pr.li, &w = pr.w, &hw = pr.hw;
  const float dx = d.ux, dy = d.uy, dz = d.uz;
  const float hx = pr.hx, hy = pr.hy, hz = pr.hz;

  // ---- implicit-function t: its value is t0, so h = o + t0*d ----
  float fx, fy, fz;
  Scene::sdf_grad_p(hx, hy, hz, p, fx, fy, fz);
  const float denom = ((fx * dx) + (fy * dy)) + (fz * dz);
  const bool usable = (t0 <= Cfg::max_distance) && (fabsf(denom) >= DENOM_FLOOR);
  const float inv_denom = usable ? 1.0f / denom : 0.0f;
  const float e = Cfg::epsilon;
  const float ndoti = pr.ndoti;
  const float dif = fminf(fmaxf(ndoti, 0.0f), 1.0f) * shadow;

  // ---- reverse: channels -> ambient, diffuse, specular ----
  const float g_amb = ((gr * mc[0]) + (gg * mc[1])) + (gb * mc[2]);
  const float g_dif = ((gr * mc[3]) + (gg * mc[4])) + (gb * mc[5]);
  float g_ndoth = 0.0f;
  // The material channels' adjoints (MAT), in the channels' order.
  [[maybe_unused]] float gch[N_MAT] = {};
  if constexpr (Cfg::blinn_phong) {
    const float shn = mc[9], ndoth = pr.ndoth, spec = pr.spec;
    const float g_spec = ((gr * mc[6]) + (gg * mc[7])) + (gb * mc[8]);
    if constexpr (POW) {
      g_ndoth = shn == 0.0f ? 0.0f : g_spec * (shn * powf(ndoth, shn - 1.0f));
    } else {
      // Reverse of x3 = (x·x)·x, x3·x3 twice, their product.
      const float x2 = ndoth * ndoth, x3 = x2 * ndoth, x6 = x3 * x3;
      const float g_x3 = 4.0f * ((g_spec * x6) * x3);
      g_ndoth = (g_x3 * x2) + (2.0f * ((g_x3 * ndoth) * ndoth));
    }
    if constexpr (MAT) {
      gch[6] = gr * spec;
      gch[7] = gg * spec;
      gch[8] = gb * spec;
      if constexpr (POW) gch[9] = ndoth == 0.0f ? 0.0f : g_spec * (logf(ndoth) * spec);
    } else if constexpr (WRT_U) {
      dU[U_MAT_REF] += gr * spec;
      dU[U_MAT_REF + 1] += gg * spec;
      dU[U_MAT_REF + 2] += gb * spec;
      // lax: d pow(x, s)/ds = log(x) * x^s, with log(1) in place of log(0).
      if constexpr (POW) dU[U_SHN] += ndoth == 0.0f ? 0.0f : g_spec * (logf(ndoth) * spec);
    }
  }
  if constexpr (MAT) {
    const float amb = Cfg::ao_enabled ? u[U_AMB] * pr.ao : u[U_AMB];
    gch[0] = gr * amb;
    gch[1] = gg * amb;
    gch[2] = gb * amb;
    gch[3] = gr * dif;
    gch[4] = gg * dif;
    gch[5] = gb * dif;
    if constexpr (WRT_U) dU[U_AMB] += Cfg::ao_enabled ? g_amb * pr.ao : g_amb;
  } else if constexpr (WRT_U) {
    const float amb = Cfg::ao_enabled ? u[U_AMB] * pr.ao : u[U_AMB];
    dU[U_MAT_AMB] += gr * amb;
    dU[U_MAT_AMB + 1] += gg * amb;
    dU[U_MAT_AMB + 2] += gb * amb;
    dU[U_MAT_DIF] += gr * dif;
    dU[U_MAT_DIF + 1] += gg * dif;
    dU[U_MAT_DIF + 2] += gb * dif;
    dU[U_AMB] += Cfg::ao_enabled ? g_amb * pr.ao : g_amb;
  }

  // ---- reverse: N.I, N.H and the unit vectors ----
  float gnx = 0.0f, gny = 0.0f, gnz = 0.0f;  // adjoint of the unit normal
  float gix = 0.0f, giy = 0.0f, giz = 0.0f;  // adjoint of the unit light vector
  const float g_ndoti = (g_dif * shadow) * clip_adj(ndoti, 0.0f, 1.0f);
  gnx += g_ndoti * li.ux; gny += g_ndoti * li.uy; gnz += g_ndoti * li.uz;
  gix += g_ndoti * n.ux; giy += g_ndoti * n.uy; giz += g_ndoti * n.uz;
  const float g_arg = g_ndoth * max_adj(pr.ndoth_arg, 0.0f);
  gnx += g_arg * hw.ux; gny += g_arg * hw.uy; gnz += g_arg * hw.uz;
  float ghwx = 0.0f, ghwy = 0.0f, ghwz = 0.0f;
  unit3_bwd(hw, true, g_arg * n.ux, g_arg * n.uy, g_arg * n.uz, ghwx, ghwy, ghwz);
  gix += ghwx; giy += ghwy; giz += ghwz;
  float gwx = 0.0f, gwy = 0.0f, gwz = 0.0f;
  unit3_bwd(w, true, ghwx, ghwy, ghwz, gwx, gwy, gwz);
  float gox = gwx, goy = gwy, goz = gwz;     // w = o - h
  float ghx = -gwx, ghy = -gwy, ghz = -gwz;  // adjoint of the hit point
  if constexpr (MAT) {
    // The default channels' adjoints: dU's uniform material with WRT_U.
    float dd[N_MAT] = {};
    float gmx = 0.0f, gmy = 0.0f, gmz = 0.0f;
    Scene::material_bwd(hx, hy, hz, p, u, gch, dP, WRT_U ? dU + U_MAT_AMB : dd, gmx, gmy, gmz);
    ghx += gmx; ghy += gmy; ghz += gmz;
  }
  if constexpr (Cfg::ao_enabled) {
    Scene::ao_bwd(hx, hy, hz, n.ux, n.uy, n.uz, p, g_amb * u[U_AMB], dP, ghx, ghy, ghz, gnx, gny, gnz);
  }
  float glx = 0.0f, gly = 0.0f, glz = 0.0f;
  unit3_bwd(li, true, gix, giy, giz, glx, gly, glz);
  if constexpr (WRT_U) {
    dU[U_LIGHT] += glx;
    dU[U_LIGHT + 1] += gly;
    dU[U_LIGHT + 2] += glz;
  }
  ghx -= glx; ghy -= gly; ghz -= glz;

  // ---- reverse: the normal taps ----
  float gmx = 0.0f, gmy = 0.0f, gmz = 0.0f;  // adjoint of the raw normal
  unit3_bwd(n, true, gnx, gny, gnz, gmx, gmy, gmz);
  if constexpr (Cfg::normals == 0) {
    sdf_bwd_add<Scene>(hx + e, hy, hz, p, gmx, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx - e, hy, hz, p, -gmx, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx, hy + e, hz, p, gmy, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx, hy - e, hz, p, -gmy, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx, hy, hz + e, p, gmz, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx, hy, hz - e, p, -gmz, dP, ghx, ghy, ghz);
  } else {
    sdf_bwd_add<Scene>(hx + e, hy - e, hz - e, p, (gmx - gmy) - gmz, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx - e, hy - e, hz + e, p, ((-gmx) - gmy) + gmz, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx - e, hy + e, hz - e, p, ((-gmx) + gmy) - gmz, dP, ghx, ghy, ghz);
    sdf_bwd_add<Scene>(hx + e, hy + e, hz + e, p, (gmx + gmy) + gmz, dP, ghx, ghy, ghz);
  }

  // ---- reverse: h = o + t*d, t = t0 - (f(o + t0*d) - sg(f)) * inv_denom ----
  gox += ghx; goy += ghy; goz += ghz;
  const float g_t = ((ghx * dx) + (ghy * dy)) + (ghz * dz);
  float gdx = t0 * ghx, gdy = t0 * ghy, gdz = t0 * ghz;
  float gfx = 0.0f, gfy = 0.0f, gfz = 0.0f;
  sdf_bwd_add<Scene>(hx, hy, hz, p, -(g_t * inv_denom), dP, gfx, gfy, gfz);
  if constexpr (WRT_U) {
    gox += gfx; goy += gfy; goz += gfz;
    gdx += t0 * gfx; gdy += t0 * gfy; gdz += t0 * gfz;
    ray = RayAdjoint{gox, goy, goz, gdx, gdy, gdz};
  }
  return true;
}

// The reverse of a pixel's ray generation (d = unit(M cv), cv = unit(qx*ar,
// qy, fz), the origin the camera position) from its ray's adjoints: adds to
// the camera's entries of dU.
SDF3D_HD void ray_vjp(const float* u, const Primal& pr, const RayAdjoint& ray, float* dU) {
  dU[U_CAM] += ray.ox;
  dU[U_CAM + 1] += ray.oy;
  dU[U_CAM + 2] += ray.oz;
  const Unit3& cv = pr.cv;
  const float* m = u + U_C2W;
  float gdrx = 0.0f, gdry = 0.0f, gdrz = 0.0f;
  unit3_bwd(pr.d, false, ray.dx, ray.dy, ray.dz, gdrx, gdry, gdrz);
  dU[U_C2W] += gdrx * cv.ux; dU[U_C2W + 1] += gdrx * cv.uy; dU[U_C2W + 2] += gdrx * cv.uz;
  dU[U_C2W + 3] += gdry * cv.ux; dU[U_C2W + 4] += gdry * cv.uy; dU[U_C2W + 5] += gdry * cv.uz;
  dU[U_C2W + 6] += gdrz * cv.ux; dU[U_C2W + 7] += gdrz * cv.uy; dU[U_C2W + 8] += gdrz * cv.uz;
  const float gcx = ((m[0] * gdrx) + (m[3] * gdry)) + (m[6] * gdrz);
  const float gcy = ((m[1] * gdrx) + (m[4] * gdry)) + (m[7] * gdrz);
  const float gcz = ((m[2] * gdrx) + (m[5] * gdry)) + (m[8] * gdrz);
  float gvx = 0.0f, gvy = 0.0f, gvz = 0.0f;
  unit3_bwd(cv, false, gcx, gcy, gcz, gvx, gvy, gvz);
  dU[U_FZ] += gvz;
}

// One pixel's VJP over its primal pr: adds the adjoint of its (r, g, b) =
// (gr, gg, gb) to dP[0..P) and, when WRT_U, to dU[0..30)
// (shade_vjp_surface, then ray_vjp).
template <class Cfg, class Scene, bool WRT_U, bool POW = true>
SDF3D_HD void shade_vjp(const float* u, const float* p, const Primal& pr, float gr, float gg, float gb, float* dP,
                        float* dU) {
  RayAdjoint ray{};
  if (!shade_vjp_surface<Cfg, Scene, WRT_U, POW>(u, p, pr, gr, gg, gb, dP, dU, ray)) return;
  if constexpr (WRT_U) ray_vjp(u, pr, ray, dU);
}

// shade_vjp of the pixel at absolute (rows, cols) of an H x W image from the
// forward's values t0, shadow and ao_in for it (K5): its primal rebuilt by
// make_primal.
template <class Cfg, class Scene, bool WRT_U, bool POW = true>
SDF3D_HD void shade_vjp_planes(const float* u, const float* p, float rows, float cols, int H, int W, float t0,
                               float shadow, float ao_in, float gr, float gg, float gb, float* dP, float* dU) {
  if constexpr (Cfg::background) {
    if (t0 > Cfg::max_distance) return;
  }
  shade_vjp<Cfg, Scene, WRT_U, POW>(u, p, make_primal<Cfg, Scene, POW>(u, p, rows, cols, H, W, t0, shadow, ao_in),
                                    gr, gg, gb, dP, dU);
}

#ifdef __CUDACC__
// Sums v[0..N) over the block in a fixed order (warp shuffles, then the
// warps in order through shared memory) and writes the N sums to
// out[k * stride].  Every thread of the block must call it.
template <int N, int NT, class T = float>
__device__ __forceinline__ void block_sum_store(const T (&v)[N], T* __restrict__ out, size_t stride = 1) {
  static_assert(NT % 32 == 0, "the block must hold whole warps");
  constexpr int NWARP = NT / 32;
  __shared__ T part[NWARP][N];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) part[warp][k] = s;
  }
  __syncthreads();
  for (int k = tid; k < N; k += NT) {
    T s = 0;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) s += part[i][k];
    out[k * stride] = s;
  }
}
#else
// block_sum_store's sums on the host, in its order: v holds the block's NT
// threads' values by thread index (y * blockDim.x + x).  Within a warp lane
// l adds lane l + 16, 8, 4, 2, 1 in turn (the shuffles), so lane 0 holds a
// fixed tree; the warps' sums are then added in order to 0.
template <int N, int NT, class T = float>
void block_sum_host(const T (*v)[N], T* out) {
  static_assert(NT % 32 == 0, "the block must hold whole warps");
  for (int k = 0; k < N; ++k) {
    T total = 0;
    for (int warp = 0; warp < NT / 32; ++warp) {
      T s[32];
      for (int lane = 0; lane < 32; ++lane) s[lane] = v[warp * 32 + lane][k];
      for (int off = 16; off > 0; off >>= 1)
        for (int lane = 0; lane < off; ++lane) s[lane] += s[lane + off];
      total += s[0];
    }
    out[k] = total;
  }
}
#endif

}  // namespace sdf3d
