// Per-ray state machine of the neural-scene forward render: ray generation
// -> primary march -> normals -> soft shadow -> AO -> Blinn-Phong/Lambert
// shading, with the distance min(analytic(p), mlp(p)) (or mlp(p) alone).
//
// It computes what sdf3d_tpu/ops/neural_kernel.py::_neural_tile_kernel
// computes.  A ray lives in a slot (struct Slot) as a stage and its loop
// variables.  Each step of a slot does two things: slot_point names the
// next point at which the ray needs a distance, and slot_take takes that
// distance and advances the stage.  Between the two the caller evaluates
// the MLP on the points of all its slots at once as a tile (neural_kernel.cu:
// tensor-core products on the card, a plain loop on the host).  The points
// and the arithmetic are those of the per-ray loops they replace:
// march_primary (add the step, then test), normal_sums, the neural
// kernel's shadow (every ray, no N.I gate, the un-squared Quilez form), the
// AO taps and shade_pixel (render_kernel.cuh).  A pixel's bits therefore
// depend only on its own sequence of points, never on its slot or on the
// order in which slots take rays.
//
// __host__ __device__ like render_kernel.cuh: a C++ compiler builds the same
// text for the CPU tests.
#pragma once

#include <stdint.h>
#include <string.h>

#include "render_kernel.cuh"

namespace sdf3d {

// softplus(beta*x)/beta with softplus(z) = max(z, 0) + log1p(exp(-|z|)),
// JAX's logaddexp(z, 0); expf and log1pf are the accurate library calls.
// The division by beta is a multiply by inv_beta = 1/beta, each rounded to
// float32: within an ulp of the quotient.
SDF3D_HD float softplus_beta(float beta, float inv_beta, float x) {
  const float z = beta * x;
  return (fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)))) * inv_beta;
}

enum Stage : int { PRIMARY = 0, NORMAL = 1, SHADOW = 2, AO = 3, SHADE = 4, IDLE = 5 };

// One ray in flight: its pixel, its stage and the stage's loop variables.
struct Slot {
  int pix;    // row-major pixel index
  int stage;  // Stage
  int i;      // step or tap within the stage
  float dx, dy, dz;             // the camera ray's direction
  float t;                      // the primary march's distance
  float hx, hy, hz;             // the hit point
  float nx, ny, nz, ix, iy, iz;  // the normal (summed tap by tap), the light direction
  float sx, sy, sz;             // the shadow ray's origin
  float dist, prev, sh;         // the shadow march
  float occ;                    // the AO taps' sum
};

template <class Cfg>
constexpr int normal_taps() { return Cfg::normals == 0 ? 6 : 4; }

// Enter `stage` (or the first later one that evaluates anything).
template <class Cfg, class Scene>
SDF3D_HD void slot_enter(Slot& s, int stage) {
  s.i = 0;
  if (stage == SHADOW) {
    if (Cfg::shadow_enabled && Cfg::shadow_steps > 0) {
      const float off = 2.0f * Cfg::epsilon;
      s.sx = s.hx + (off * s.nx); s.sy = s.hy + (off * s.ny); s.sz = s.hz + (off * s.nz);
      s.dist = 0.0f; s.prev = INFINITY; s.sh = 1.0f;
      s.stage = SHADOW;
      return;
    }
    s.sh = 1.0f;  // no shadow march: the factor is 1 (a 0-step march also clamps 1 to 1)
    stage = AO;
  }
  if (stage == AO) {
    s.occ = 0.0f;
    if (Cfg::ao_enabled && Scene::ao_taps > 0) {
      s.stage = AO;
      return;
    }
    stage = SHADE;
  }
  s.stage = stage;
}

// The primary march has ended at s.t: the hit point, then the normal taps.
template <class Cfg, class Scene>
SDF3D_HD void slot_hit(Slot& s, const float* u) {
  s.hx = u[U_CAM] + (s.t * s.dx); s.hy = u[U_CAM + 1] + (s.t * s.dy); s.hz = u[U_CAM + 2] + (s.t * s.dz);
  s.i = 0;
  s.stage = NORMAL;
}

// Start the ray of pixel `pix` of an H x W image in slot s.
template <class Cfg, class Scene>
SDF3D_HD void slot_start(Slot& s, const float* u, int pix, int H, int W) {
  const int row = pix / W, col = pix - row * W;
  s.pix = pix;
  ray_direction<Cfg>(u, u[U_ROW0] + static_cast<float>(row), static_cast<float>(col), H, W, s.dx, s.dy, s.dz);
  s.t = 0.0f;
  s.i = 0;
  s.stage = PRIMARY;
  if (Cfg::march_steps <= 0) slot_hit<Cfg, Scene>(s, u);
}

// The point at which slot s needs a distance next (its stage is one that
// evaluates: PRIMARY, NORMAL, SHADOW or AO).
template <class Cfg, class Scene>
SDF3D_HD void slot_point(const Slot& s, const float* u, float& px, float& py, float& pz) {
  const float e = Cfg::epsilon;
  switch (s.stage) {
    case PRIMARY:
      px = u[U_CAM] + (s.t * s.dx); py = u[U_CAM + 1] + (s.t * s.dy); pz = u[U_CAM + 2] + (s.t * s.dz);
      return;
    case NORMAL:
      px = s.hx; py = s.hy; pz = s.hz;
      if constexpr (Cfg::normals == 0) {  // +x, -x, +y, -y, +z, -z
        const float d = (s.i & 1) ? -e : e;
        if (s.i < 2) px = s.hx + d; else if (s.i < 4) py = s.hy + d; else pz = s.hz + d;
      } else {  // the tetrahedron's corners (+,-,-), (-,-,+), (-,+,-), (+,+,+)
        px = s.hx + ((s.i == 0 || s.i == 3) ? e : -e);
        py = s.hy + ((s.i >= 2) ? e : -e);
        pz = s.hz + ((s.i & 1) ? e : -e);
      }
      return;
    case SHADOW:
      px = s.sx + (s.dist * s.ix); py = s.sy + (s.dist * s.iy); pz = s.sz + (s.dist * s.iz);
      return;
    default: {  // AO
      const float h = Scene::ao_h(s.i);
      px = s.hx + (h * s.nx); py = s.hy + (h * s.ny); pz = s.hz + (h * s.nz);
      return;
    }
  }
}

// Take the distance d at slot s's point and advance.  Returns true when
// the ray has reached SHADE: slot_shade gives its pixel.
template <class Cfg, class Scene>
SDF3D_HD bool slot_take(Slot& s, const float* u, float d) {
  switch (s.stage) {
    case PRIMARY:
      s.t = s.t + d;
      ++s.i;
      if (s.t > Cfg::max_distance || d < Cfg::epsilon || s.i >= Cfg::march_steps) slot_hit<Cfg, Scene>(s, u);
      return false;
    case NORMAL:
      // normal_sums' sums, a tap at a time, in its order (no array
      // indexed by the tap, which would leave the registers).
      if constexpr (Cfg::normals == 0) {  // n = (d0 - d1, d2 - d3, d4 - d5)
        switch (s.i) {
          case 0: s.nx = d; break;
          case 1: s.nx = s.nx - d; break;
          case 2: s.ny = d; break;
          case 3: s.ny = s.ny - d; break;
          case 4: s.nz = d; break;
          default: s.nz = s.nz - d; break;
        }
      } else {  // ((s0 - s1) - s2) + s3, (((-s0) - s1) + s2) + s3, (((-s0) + s1) - s2) + s3
        switch (s.i) {
          case 0: s.nx = d; s.ny = -d; s.nz = -d; break;
          case 1: s.nx = s.nx - d; s.ny = s.ny - d; s.nz = s.nz + d; break;
          case 2: s.nx = s.nx - d; s.ny = s.ny + d; s.nz = s.nz - d; break;
          default: s.nx = s.nx + d; s.ny = s.ny + d; s.nz = s.nz + d; break;
        }
      }
      if (++s.i < normal_taps<Cfg>()) return false;
      {
        const float ninv = rsqrt_exact(fmaxf(((s.nx * s.nx) + (s.ny * s.ny)) + (s.nz * s.nz), 1e-24f));
        s.nx = s.nx * ninv; s.ny = s.ny * ninv; s.nz = s.nz * ninv;
      }
      light_direction(u, s.hx, s.hy, s.hz, s.ix, s.iy, s.iz);
      slot_enter<Cfg, Scene>(s, SHADOW);
      break;
    case SHADOW: {  // neural_kernel.py:213-245: prev = +inf, the first step's intersection term 0
      const float k = u[U_K];
      const float inter = s.i == 0 ? 0.0f : (d * d) / (2.0f * (s.prev == 0.0f ? 1e-30f : s.prev));
      const float d2 = (d * d) - (inter * inter);
      const float denom = s.dist - inter;
      const bool valid = (denom > 0.0f) && (d2 >= 0.0f);
      const float atten = valid ? ((k * sqrtf(fmaxf(d2, 0.0f))) / denom) : 1e30f;
      s.sh = fminf(s.sh, atten);
      s.dist = s.dist + d;
      s.prev = d;
      if (++s.i < Cfg::shadow_steps && !(s.dist > Cfg::max_distance || s.sh < Cfg::epsilon)) return false;
      s.sh = fminf(fmaxf(s.sh, 0.0f), 1.0f);
      slot_enter<Cfg, Scene>(s, AO);
      break;
    }
    default:  // AO
      s.occ = s.occ + (Scene::ao_w(s.i) * (Scene::ao_h(s.i) - d));
      if (++s.i < Scene::ao_taps) return false;
      s.stage = SHADE;
      break;
  }
  return s.stage == SHADE;
}

// The pixel of a slot that has reached SHADE.
template <class Cfg, class Scene>
SDF3D_HD Pixel slot_shade(const Slot& s, const float* u) {
  const float ao = (Cfg::ao_enabled && Scene::ao_taps > 0)
                       ? fminf(fmaxf((1.0f - (Scene::ao_strength * s.occ)), 0.0f), 1.0f)
                       : 1.0f;
  return shade_pixel<Cfg>(u, s.t, s.hx, s.hy, s.hz, s.nx, s.ny, s.nz, s.ix, s.iy, s.iz, s.sh, ao);
}

// The scene's distance from the MLP's value m at (x, y, z): min(analytic, m)
// per slot, in scalar code, or m alone.
template <class Scene>
SDF3D_HD float scene_distance(const float* pa, float x, float y, float z, float m) {
  if constexpr (Scene::has_analytic) {
    return fminf(Scene::sdf(x, y, z, pa), m);
  } else {
    return m;
  }
}

// ---- split TF32 ----
//
// x_hi = tf32(x), x_lo = tf32(x - x_hi): cvt.rna.tf32.f32 rounds to the
// nearest value with 10 stored mantissa bits, ties away from zero, and
// leaves the low 13 bits 0.  A product a*b of the MLP is taken as
// a_hi*b_hi + a_hi*b_lo + a_lo*b_hi in float32 (the a_lo*b_lo term is below
// float32's rounding): about float32's accuracy, where one TF32 pass keeps
// about three digits.
SDF3D_HD float tf32_round(float x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
#else
  uint32_t b;
  memcpy(&b, &x, 4);
  if ((b & 0x7f800000u) != 0x7f800000u) b = (b + 0x1000u) & ~0x1fffu;  // inf and nan pass through
  float r;
  memcpy(&r, &b, 4);
  return r;
#endif
}

#ifndef __CUDACC__
// The host form of one layer's product, C (m x n) = A (m x k) B (k x n),
// row-major, from A and B split into TF32 hi and lo parts, in `passes`
// passes (3: a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, 1: a_hi*b_hi alone): per
// k-tile of 8, pass after pass, each pass summed in k order, as the card's
// kernel issues its mma.sync products.  The card sums inside an mma in its
// own order, so the bits differ; the error class is the same.
inline void tf32_product(const float* ah, const float* al, const float* bh, const float* bl, float* C, int m, int k,
                         int n, int passes) {
  for (int r = 0; r < m; ++r) {
    for (int c = 0; c < n; ++c) {
      float acc = 0.0f;
      for (int k0 = 0; k0 < k; k0 += 8) {
        for (int p = 0; p < passes; ++p) {
          const float* x = (p == 2 ? al : ah) + r * k;
          const float* y = p == 1 ? bl : bh;
          for (int q = k0; q < k0 + 8 && q < k; ++q) acc = acc + (x[q] * y[q * n + c]);
        }
      }
      C[r * n + c] = acc;
    }
  }
}
#endif

}  // namespace sdf3d
