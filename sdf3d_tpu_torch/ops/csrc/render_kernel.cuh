// Per-pixel body of the fused forward render: ray generation -> primary
// march -> normals -> soft shadow -> AO -> Blinn-Phong/Lambert shading, as
// the stages of a pixel's Primal (below) and its shading.
//
// It computes what sdf3d_tpu/ops/render_kernel.py::_render_tile_kernel
// computes, one pixel per call, with real per-ray loops and breaks in place
// of that kernel's f32 lane masks and whole-tile exits.  The scene and the
// static settings come from the generated header (struct Scene, struct Cfg;
// ops/scene_program.py::cuda_scene_source).
//
// The code is __host__ __device__: nvcc builds it into the kernel of
// render_kernel.cu, and a C++ compiler builds the same text for the CPU
// (with __CUDACC__ undefined the qualifiers below expand to nothing), which
// lets the generated source be checked without a card.
//
// Parity notes: 1/sqrtf is used where the JAX kernel calls lax.rsqrt (no
// approximate rsqrtf), powf for jnp.power, and no fast-math intrinsics.
// The compiler may contract a*b+c into an FMA, so bits differ from the
// plain PyTorch version by rounding; tests compare with pixel budgets.
#pragma once

#include <math.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define SDF3D_HD __host__ __device__ __forceinline__

namespace sdf3d {

// Uniform vector layout (ops/render_kernel.py, same slots as the JAX kernel).
constexpr int U_CAM = 0;       // camera position (3)
constexpr int U_C2W = 3;       // camera-to-world rotation, row-major (9)
constexpr int U_FZ = 12;       // focal z (1)
constexpr int U_LIGHT = 13;    // light position (3)
constexpr int U_AMB = 16;      // light ambient intensity (1)
constexpr int U_MAT_AMB = 17;  // material ambient rgb (3)
constexpr int U_MAT_DIF = 20;  // material diffuse rgb (3)
constexpr int U_MAT_REF = 23;  // material specular rgb (3)
constexpr int U_SHN = 26;      // shininess (1)
constexpr int U_K = 27;        // shadow sharpness k (1)
constexpr int U_ROW0 = 28;     // absolute row of output row 0 (1)
constexpr int U_ROWSTRIDE = 29;  // absolute rows between successive tile rows (1; 0 reads Cfg::tile_h)
constexpr int N_UNIFORMS = 30;

struct Pixel {
  float r, g, b, t, shadow, ao;
};

SDF3D_HD float rsqrt_exact(float x) { return 1.0f / sqrtf(x); }

// Derivatives of min, max, clip = min(max(x, lo), hi) and abs with respect
// to x, by lax's rule: the adjoint splits 0.5/0.5 at an exact tie (the
// union of a plane and a sphere meets ties on its seam), and abs passes it
// unchanged at x >= 0 (+1 at 0).  The reverse passes (generated
// Scene::sdf_bwd, shade_vjp.cuh) use them.
SDF3D_HD float min_adj(float x, float y) { return x < y ? 1.0f : (x == y ? 0.5f : 0.0f); }
SDF3D_HD float max_adj(float x, float y) { return x > y ? 1.0f : (x == y ? 0.5f : 0.0f); }
SDF3D_HD float clip_adj(float x, float lo, float hi) { return max_adj(x, lo) * min_adj(fmaxf(x, lo), hi); }
SDF3D_HD float abs_adj(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// jnp.where(c, a, b) of the generated scene code (Rotate's series branch,
// RepeatInfinite's disabled axes) and its adjoint: a select, so the operand
// not taken gets exactly 0.
SDF3D_HD float select(bool c, float a, float b) { return c ? a : b; }

// The register caps of the fit step and the render backward follow the size
// of the scene's reverse pass (Scene::bwd_values, the forward values sdf_bwd
// keeps: the reference scene's 27, lattice_scene's 48, random_blobs(2)'s 57,
// random_blobs(3)'s 87, the flagship's 92, csg_showcase's 159,
// random_blobs(8)'s 237, capsule_chain's 277, the transform sampler's 398,
// fractal_scene's 409).  A kernel asks `base` blocks an SM up to its line
// (`half_above`), half of them above it, and 1 above kHugeReverseValues; but
// at most 2 where one primitive keeps more than kSpillingNodeValues
// (Scene::bwd_node_values: a Mandelbulb's 392, every other scene's at most
// 33), whose serial pass spills kB at every cap, and more resident warps
// then hide the spills' latency (fit_kernel.cu, render_bwd_kernel.cu).  The
// lines: K3's
// and K5's uniforms' form kLargeReverseValues, K5's parameters' form
// kLargeReverseValuesK5.  In one process at 1080p on an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py --register-line; PERF.md): K3 at 4 blocks against
// 2 ran 0.46 against 0.55 ms on lattice_scene, 0.50 against 0.53 on
// random_blobs(2), 1.11 against 0.87 on random_blobs(3); K5's parameters'
// form 0.18 against 0.21 on lattice_scene, 0.40 against 0.26 on
// random_blobs(2); on csg_showcase 1 block against 2 ran K3 1.78 against 2.18
// and K5's parameters' form 0.91 against 1.82, on random_blobs(3) 1.32 and
// 0.63 against 0.87 and 0.49; on fractal_scene 2 blocks against 1 ran K3
// 11.49 against 13.83, K5's parameters' form 9.83 against 12.19 and its
// uniforms' form 10.45 against 12.77, while on the transform sampler (398
// values, 33 a primitive) 1 block against 2 ran 7.97 against 8.30, 6.46
// against 7.84 and 7.56 against 8.47.
constexpr int kLargeReverseValues = 64;
constexpr int kLargeReverseValuesK5 = 48;
constexpr int kHugeReverseValues = 128;
constexpr int kSpillingNodeValues = 255;
constexpr int reverse_blocks(int base, int values, int node_values, int half_above) {
  return node_values > kSpillingNodeValues ? (base < 2 ? base : 2)
       : values > kHugeReverseValues ? 1 : (values > half_above ? (base + 1) / 2 : base);
}

// The scene's point form as a distance functor f(x, y, z).
template <class Scene>
struct ScenePoint {
  const float* p;
  SDF3D_HD float operator()(float x, float y, float z) const { return Scene::sdf(x, y, z, p); }
};

// Point-form evaluator along a ray: f(o + t*d) for a distance functor f
// (the render kernel's ray_sdf == false, and the neural kernel).
template <class F>
struct PointRay {
  F f;
  float ox, oy, oz, dx, dy, dz;
  SDF3D_HD float eval(float t) const { return f((ox + (t * dx)), (oy + (t * dy)), (oz + (t * dz))); }
};

// a * b rounded once: nvcc may not contract it into a following add (an
// FMA), so the relaxed step keeps the plain version's bits.
SDF3D_HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// Primary sphere trace: add the step, then test (the returned t overshoots
// by the last step; a ray that never stops ends after march_steps steps).
// With Cfg::relaxation != 1 the march is over-relaxed (Keinert et al. 2014;
// JAX's relaxed_body in sdf3d_tpu/ops/render_kernel.py): a ray steps
// relaxation * s; a step fails when omega > 1 and |s| + prev_r < step_len
// (the bounding spheres stopped overlapping), goes back by step_len * (1 -
// omega) and sets omega = 1 for the rest of the march; a hit (!fail and s <
// epsilon) lands with +s, like the exact march; a failed step's s < epsilon
// does not stop the ray.
template <class Cfg, class Ev>
SDF3D_HD float march_primary(const Ev& ev) {
  float t = 0.0f;
  if constexpr (Cfg::relaxation != 1.0f) {
    float prev_r = 0.0f, step_len = 0.0f, om = Cfg::relaxation;
    for (int i = 0; i < Cfg::march_steps; ++i) {
      const float s = ev.eval(t);
      const bool fail = om > 1.0f && fabsf(s) + prev_r < step_len;
      const bool hit = !fail && s < Cfg::epsilon;
      const float step = hit ? s : (fail ? mul_rn(step_len, 1.0f - om) : mul_rn(om, s));
      if (fail) om = 1.0f;
      t = t + step;
      prev_r = fabsf(s);
      step_len = step;
      if (hit || t > Cfg::max_distance) break;
    }
    return t;
  }
  for (int i = 0; i < Cfg::march_steps; ++i) {
    const float s = ev.eval(t);
    t = t + s;
    if (t > Cfg::max_distance || s < Cfg::epsilon) break;
  }
  return t;
}

// Soft shadow in the squared domain: sh2 = min(sh2, k²·d²/denom²), one sqrt
// at the end.  prev starts at +inf, so the first intersection term is 0.
template <class Cfg, class Ev>
SDF3D_HD float march_shadow(const Ev& ev, float k) {
  const float k2 = k * k;
  float dist = 0.0f, prev = INFINITY, sh2 = 1.0f;
  for (int i = 0; i < Cfg::shadow_steps; ++i) {
    const float s = ev.eval(dist);
    const float s2 = s * s;
    const float inter = s2 / (2.0f * (prev == 0.0f ? 1e-30f : prev));
    const float d2 = s2 - (inter * inter);
    const float denom = dist - inter;
    const bool valid = (denom > 0.0f) && (d2 >= 0.0f);
    const float att2 = valid ? ((k2 * fmaxf(d2, 0.0f)) / (denom * denom)) : 1e30f;
    sh2 = fminf(sh2, att2);
    dist = dist + s;
    prev = s;
    if (dist > Cfg::max_distance || sh2 < Cfg::epsilon2) break;
  }
  return sqrtf(fminf(fmaxf(sh2, 0.0f), 1.0f));
}

// Absolute image row of launch row `row` (JAX's _tile_pixel_planes):
// row0 + (row / TH)·rowstride + row % TH, TH = Cfg::tile_h.  A stride of 0
// reads TH, which gives row0 + row: contiguous rows, the unsharded launch.
// The interleaved layout sets it to n·TH.  Every term is an integer below
// 2^24, so the float arithmetic is exact.
template <class Cfg>
SDF3D_HD float abs_row(const float* u, int row) {
  const float stride = u[U_ROWSTRIDE] > 0.0f ? u[U_ROWSTRIDE] : static_cast<float>(Cfg::tile_h);
  return (u[U_ROW0] + (static_cast<float>(row / Cfg::tile_h) * stride)) + static_cast<float>(row % Cfg::tile_h);
}

// v * rsqrt(q), q = v.v (floored at 1e-24 when `floored`), with the values
// the reverse pass reads (shade_vjp.cuh::unit3_bwd).
struct Unit3 {
  float x, y, z, s, q, r, ux, uy, uz;
};

SDF3D_HD Unit3 unit3(float x, float y, float z, bool floored) {
  Unit3 n;
  n.x = x; n.y = y; n.z = z;
  n.s = ((x * x) + (y * y)) + (z * z);
  n.q = floored ? fmaxf(n.s, 1e-24f) : n.s;
  n.r = rsqrt_exact(n.q);
  n.ux = x * n.r; n.uy = y * n.r; n.uz = z * n.r;
  return n;
}

// The primal of one pixel: every value its shading and the shading's
// reverse pass (shade_vjp.cuh) read.  Built in three stages, in this order:
// primal_ray, primal_surface (from t), primal_shading (from the shadow and
// AO factors).  trace_pixel runs them around the marches; make_primal runs
// them from a forward's (t, shadow, ao) planes, with the same arithmetic.
struct Primal {
  Unit3 cv, d;            // camera-space and world ray direction
  float t, shadow, ao;    // the marches' values
  float hx, hy, hz;       // hit point o + t*d
  Unit3 n;                // the normal taps' sums (x, y, z) and the unit normal
  Unit3 li, w, hw;        // unit light, view and half vectors
  float ndoti, ndoth_arg, ndoth, spec;
};

// Ray direction of the pixel at absolute (rows, cols) (NDC over the logical
// extent, Cfg::ndc_h x ndc_w, else H x W): d = unit(M cv), cv = unit(qx*ar,
// qy, fz).
template <class Cfg>
SDF3D_HD void primal_ray(const float* u, float rows, float cols, int H, int W, Primal& pr) {
  const int nh = Cfg::ndc_h > 0 ? Cfg::ndc_h : H;
  const int nw = Cfg::ndc_w > 0 ? Cfg::ndc_w : W;
  const float qx = ((2.0f * (cols + 0.5f)) / static_cast<float>(nw)) - 1.0f;
  const float qy = 1.0f - ((2.0f * (rows + 0.5f)) / static_cast<float>(nh));
  const float ar = static_cast<float>(static_cast<double>(nw) / static_cast<double>(nh));
  pr.cv = unit3(qx * ar, qy, u[U_FZ], false);
  const float* m = u + U_C2W;
  pr.d = unit3(((m[0] * pr.cv.ux) + (m[1] * pr.cv.uy)) + (m[2] * pr.cv.uz),
               ((m[3] * pr.cv.ux) + (m[4] * pr.cv.uy)) + (m[5] * pr.cv.uz),
               ((m[6] * pr.cv.ux) + (m[7] * pr.cv.uy)) + (m[8] * pr.cv.uz), false);
}

// Unit ray direction of the pixel (primal_ray's d).
template <class Cfg>
SDF3D_HD void ray_direction(const float* u, float rows, float cols, int H, int W, float& dx, float& dy, float& dz) {
  Primal pr;
  primal_ray<Cfg>(u, rows, cols, H, W, pr);
  dx = pr.d.ux; dy = pr.d.uy; dz = pr.d.uz;
}

// The raw normal at h from the distance functor f: central differences (6
// taps) or the tetrahedron (4 taps), step Cfg::epsilon.
template <class Cfg, class F>
SDF3D_HD void normal_sums(const F& f, float hx, float hy, float hz, float& nx, float& ny, float& nz) {
  const float e = Cfg::epsilon;
  if constexpr (Cfg::normals == 0) {
    nx = f(hx + e, hy, hz) - f(hx - e, hy, hz);
    ny = f(hx, hy + e, hz) - f(hx, hy - e, hz);
    nz = f(hx, hy, hz + e) - f(hx, hy, hz - e);
  } else {
    const float s0 = f(hx + e, hy - e, hz - e);
    const float s1 = f(hx - e, hy - e, hz + e);
    const float s2 = f(hx - e, hy + e, hz - e);
    const float s3 = f(hx + e, hy + e, hz + e);
    nx = ((s0 - s1) - s2) + s3;
    ny = (((-s0) - s1) + s2) + s3;
    nz = (((-s0) + s1) - s2) + s3;
  }
}

// Unit vector from h to the light.
SDF3D_HD Unit3 light_unit(const float* u, float hx, float hy, float hz) {
  return unit3(u[U_LIGHT] - hx, u[U_LIGHT + 1] - hy, u[U_LIGHT + 2] - hz, true);
}

// Unit direction from h to the light (light_unit's unit vector).
SDF3D_HD void light_direction(const float* u, float hx, float hy, float hz, float& ix, float& iy, float& iz) {
  const Unit3 li = light_unit(u, hx, hy, hz);
  ix = li.ux; iy = li.uy; iz = li.uz;
}

// The hit point at t (after primal_ray), the normal there, the light
// vector and N.I.
template <class Cfg, class Scene>
SDF3D_HD void primal_surface(const float* u, const float* p, float t, Primal& pr) {
  pr.t = t;
  pr.hx = u[U_CAM] + (t * pr.d.ux);
  pr.hy = u[U_CAM + 1] + (t * pr.d.uy);
  pr.hz = u[U_CAM + 2] + (t * pr.d.uz);
  float nx, ny, nz;
  normal_sums<Cfg>(ScenePoint<Scene>{p}, pr.hx, pr.hy, pr.hz, nx, ny, nz);
  pr.n = unit3(nx, ny, nz, true);
  pr.li = light_unit(u, pr.hx, pr.hy, pr.hz);
  pr.ndoti = ((pr.n.ux * pr.li.ux) + (pr.n.uy * pr.li.uy)) + (pr.n.uz * pr.li.uz);
}

// The specular power x^s: powf, or with POW false the chain x³·x³·x³·x³,
// which ignores s (the fit kernel's benchmark variant "nopow", JAX's
// cheap_pow in benchmarks/exp_ad.py; the reference shininess is 12).
template <bool POW>
SDF3D_HD float spec_pow(float x, float s) {
  if constexpr (POW) {
    return powf(x, s);
  } else {
    const float x3 = (x * x) * x;
    return (x3 * x3) * (x3 * x3);
  }
}

// The shading's vectors (after primal_surface): the view vector to the
// camera, the half vector, N.H and the specular term (POW: spec_pow).
template <class Cfg, bool POW = true>
SDF3D_HD void primal_shading(const float* u, float shadow, float ao, Primal& pr) {
  pr.shadow = shadow;
  pr.ao = ao;
  pr.w = unit3(u[U_CAM] - pr.hx, u[U_CAM + 1] - pr.hy, u[U_CAM + 2] - pr.hz, true);
  pr.hw = unit3(pr.li.ux + pr.w.ux, pr.li.uy + pr.w.uy, pr.li.uz + pr.w.uz, true);
  pr.ndoth_arg = ((pr.n.ux * pr.hw.ux) + (pr.n.uy * pr.hw.uy)) + (pr.n.uz * pr.hw.uz);
  pr.ndoth = fmaxf(pr.ndoth_arg, 0.0f);
  pr.spec = Cfg::blinn_phong ? spec_pow<POW>(pr.ndoth, u[U_SHN]) : 0.0f;
}

// Blinn-Phong / Lambert shading of a pixel's primal, with the shadow and AO
// factors, and the background composite of misses (t > max_distance).
template <class Cfg>
SDF3D_HD Pixel shade(const float* u, const Primal& pr) {
  const float dif = fminf(fmaxf(pr.ndoti, 0.0f), 1.0f) * pr.shadow;
  const float amb = Cfg::ao_enabled ? u[U_AMB] * pr.ao : u[U_AMB];
  float r = (amb * u[U_MAT_AMB]) + (dif * u[U_MAT_DIF]);
  float g = (amb * u[U_MAT_AMB + 1]) + (dif * u[U_MAT_DIF + 1]);
  float b = (amb * u[U_MAT_AMB + 2]) + (dif * u[U_MAT_DIF + 2]);
  if constexpr (Cfg::blinn_phong) {
    r = r + (pr.spec * u[U_MAT_REF]);
    g = g + (pr.spec * u[U_MAT_REF + 1]);
    b = b + (pr.spec * u[U_MAT_REF + 2]);
  }
  if constexpr (Cfg::background) {
    if (pr.t > Cfg::max_distance) {
      r = Cfg::bg_r; g = Cfg::bg_g; b = Cfg::bg_b;
    }
  }
  return Pixel{r, g, b, pr.t, pr.shadow, pr.ao};
}

// shade() of hit h (unit normal n, unit light direction i) seen from the
// camera at u[U_CAM], for a caller that holds these values alone (the
// neural kernel).
template <class Cfg>
SDF3D_HD Pixel shade_pixel(const float* u, float t, float hx, float hy, float hz, float nx, float ny, float nz,
                           float ix, float iy, float iz, float shadow, float ao) {
  Primal pr{};
  pr.t = t;
  pr.hx = hx; pr.hy = hy; pr.hz = hz;
  pr.n.ux = nx; pr.n.uy = ny; pr.n.uz = nz;
  pr.li.ux = ix; pr.li.uy = iy; pr.li.uz = iz;
  pr.ndoti = ((nx * ix) + (ny * iy)) + (nz * iz);
  primal_shading<Cfg>(u, shadow, ao, pr);
  return shade<Cfg>(u, pr);
}

// The primal of the pixel at absolute (rows, cols) of an H x W image from a
// forward's (t, shadow, ao): the three stages without the marches.
template <class Cfg, class Scene, bool POW = true>
SDF3D_HD Primal make_primal(const float* u, const float* p, float rows, float cols, int H, int W, float t,
                            float shadow, float ao) {
  Primal pr;
  primal_ray<Cfg>(u, rows, cols, H, W, pr);
  primal_surface<Cfg, Scene>(u, p, t, pr);
  primal_shading<Cfg, POW>(u, shadow, ao, pr);
  return pr;
}

// The primal of the pixel at absolute (rows, cols) of an H x W image: the
// primary march, the soft shadow (marched only where N.I > 0, elsewhere
// 1) and AO between make_primal's stages.
template <class Cfg, class Scene, bool POW = true>
SDF3D_HD Primal trace_pixel(const float* u, const float* p, float rows, float cols, int H, int W) {
  Primal pr;
  primal_ray<Cfg>(u, rows, cols, H, W, pr);
  const float ox = u[U_CAM], oy = u[U_CAM + 1], oz = u[U_CAM + 2];
  const float dx = pr.d.ux, dy = pr.d.uy, dz = pr.d.uz;

  // ---- primary march ----
  float t;
  if constexpr (Cfg::ray_sdf) {
    typename Scene::Ray ray;
    ray.setup(ox, oy, oz, dx, dy, dz, p);
    t = march_primary<Cfg>(ray);
  } else {
    t = march_primary<Cfg>(PointRay<ScenePoint<Scene>>{ScenePoint<Scene>{p}, ox, oy, oz, dx, dy, dz});
  }
  primal_surface<Cfg, Scene>(u, p, t, pr);

  // ---- soft shadow, marched only where N.I > 0 ----
  float shadow = 1.0f;
  if constexpr (Cfg::shadow_enabled) {
    if (pr.ndoti > 0.0f) {
      const float off = 2.0f * Cfg::epsilon;
      const float sox = pr.hx + (off * pr.n.ux), soy = pr.hy + (off * pr.n.uy), soz = pr.hz + (off * pr.n.uz);
      if constexpr (Cfg::ray_sdf) {
        typename Scene::Ray ray;
        ray.setup(sox, soy, soz, pr.li.ux, pr.li.uy, pr.li.uz, p);
        shadow = march_shadow<Cfg>(ray, u[U_K]);
      } else {
        shadow = march_shadow<Cfg>(
            PointRay<ScenePoint<Scene>>{ScenePoint<Scene>{p}, sox, soy, soz, pr.li.ux, pr.li.uy, pr.li.uz}, u[U_K]);
      }
    }
  }

  // ---- ambient occlusion ----
  float ao = 1.0f;
  if constexpr (Cfg::ao_enabled) ao = Scene::ao(pr.hx, pr.hy, pr.hz, pr.n.ux, pr.n.uy, pr.n.uz, p);
  primal_shading<Cfg, POW>(u, shadow, ao, pr);
  return pr;
}

// One pixel at absolute (rows, cols) of an H x W image (POW: spec_pow).
template <class Cfg, class Scene, bool POW = true>
SDF3D_HD Pixel render_pixel(const float* u, const float* p, float rows, float cols, int H, int W) {
  return shade<Cfg>(u, trace_pixel<Cfg, Scene, POW>(u, p, rows, cols, H, W));
}

}  // namespace sdf3d
